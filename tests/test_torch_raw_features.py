"""The port's raw-window feature extraction against the JAX package's.

The same windows (the synthetic raw stream, and seeded Gaussian windows
of several scales, with constant and short windows) go through both
``extract_features``: the 30 histogram columns must be equal bit for bit
(a sample's bin is an int cast of an f32 quotient, and the fraction the
count times 1/T as XLA computes it), the 13 others within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from har_tpu.features.raw_features import FEATURE_NAMES as JAX_FEATURE_NAMES
from har_tpu.features.raw_features import extract_features as jax_extract_features
from har_tpu_torch.data.raw_windows import synthetic_raw_stream
from har_tpu_torch.features.raw_features import FEATURE_NAMES, extract_features

torch.set_num_threads(1)


def _windows(kind: str) -> np.ndarray:
    if kind == "synthetic_stream":
        return np.asarray(synthetic_raw_stream(n_windows=240, seed=1).windows, np.float32)
    rng = np.random.default_rng(2)
    w = rng.normal(size=(120, 200, 3)).astype(np.float32)
    if kind == "scaled":
        w *= rng.uniform(0.01, 50.0, size=(120, 1, 3)).astype(np.float32)
    elif kind == "edge_cases":
        w[0] = 1.5  # constant window: no peaks, one bin
        w[1, :, 0] = np.arange(200, dtype=np.float32)  # monotone: no peaks
        w = w[:, :37]  # a short window
    return w


def test_feature_names_equal():
    assert FEATURE_NAMES == JAX_FEATURE_NAMES and len(FEATURE_NAMES) == 43


@pytest.mark.parametrize("kind", ["synthetic_stream", "gaussian", "scaled", "edge_cases"])
def test_features_equal_jax(kind):
    w = _windows(kind)
    want = np.asarray(jax_extract_features(jnp.asarray(w)))
    got = extract_features(torch.from_numpy(w))
    assert got.shape == (len(w), 43) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(got[:, :30], want[:, :30])
    np.testing.assert_allclose(got[:, 30:], want[:, 30:], rtol=1e-5, atol=1e-5)


def test_takes_numpy_and_stays_on_the_windows_device():
    w = _windows("gaussian")[:5]
    torch.testing.assert_close(extract_features(w), extract_features(torch.from_numpy(w)))
    assert extract_features(torch.from_numpy(w)).device.type == "cpu"


def test_runner_raw_feature_view_equals_jax():
    """`--dataset wisdm_raw` with a classical model: the runner's view is
    the windows' features, split into the same rows as har_tpu's."""
    from har_tpu import runner as jax_runner
    from har_tpu.config import DataConfig as JaxDataConfig
    from har_tpu.config import ModelConfig as JaxModelConfig
    from har_tpu.config import RunConfig as JaxRunConfig
    from har_tpu_torch import runner as port_runner
    from har_tpu_torch.config import DataConfig, ModelConfig, RunConfig

    jax_cfg = JaxRunConfig(data=JaxDataConfig(dataset="wisdm_raw", synthetic_rows=120),
                           model=JaxModelConfig(name="dt"))
    port_cfg = RunConfig(data=DataConfig(dataset="wisdm_raw", synthetic_rows=120),
                         model=ModelConfig(name="dt"))
    want = jax_runner.featurize(jax_cfg, jax_runner.load_dataset(jax_cfg))[:2]
    got = port_runner.featurize(port_cfg, port_runner.load_dataset(port_cfg), "cpu")[:2]
    for a, b in zip(got, want):
        assert a.features.shape == b.features.shape and a.features.shape[1] == 43
        np.testing.assert_array_equal(a.features[:, :30], b.features[:, :30])
        np.testing.assert_allclose(a.features[:, 30:], b.features[:, 30:], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(a.label, b.label)
