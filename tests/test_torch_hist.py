"""The port's histogram (kernel K1's plain version) against the JAX package.

``har_tpu_torch.ops.hist.hist_plain`` must equal ``hist_matmul`` (the Pallas
kernel, in interpret mode here) and the XLA one-hot matmul the JAX tree
grower uses, on the shapes of tests/test_pallas_hist.py.  Integer weights
(the trees' ones and Poisson counts) must agree exactly; random float32
weights within rtol 1e-5, since the order of summation differs.  The CUDA
kernel itself is held against hist_plain on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from har_tpu.ops.pallas_hist import hist_matmul
from har_tpu_torch.ops import hist as hist_ops

torch.set_num_threads(1)

# (n, d, max_bins, wc): the JAX kernel tests' shapes, padded rows and
# features included, and the tree grower's (DT depth 2, 3 classes)
SHAPES = [(300, 7, 8, 12), (513, 130, 4, 6), (257, 9, 32, 12)]


def _inputs(n, d, max_bins, wc, trees=1, integer=True, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, max_bins, size=(n, d)).astype(np.int32)
    if integer:
        m = rng.poisson(1.0, size=(trees, n, wc)).astype(np.float32)
    else:
        m = rng.random((trees, n, wc)).astype(np.float32)
    return bins, m


def _xla_onehot(bins, m2d, max_bins):
    """The JAX grower's XLA path (har_tpu/models/tree.py:248-286)."""
    n, d = bins.shape
    onehot = jax.nn.one_hot(jnp.asarray(bins), max_bins, dtype=jnp.bfloat16)
    return np.asarray(
        jax.lax.dot_general(
            jnp.asarray(m2d, jnp.bfloat16),
            onehot.reshape(n, d * max_bins),
            (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    )


def _plain(bins, m, max_bins):
    return hist_ops.hist_plain(
        torch.from_numpy(bins), torch.from_numpy(m), max_bins
    ).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_pallas_and_xla_exactly_for_integer_weights(shape):
    n, d, max_bins, wc = shape
    bins, m = _inputs(n, d, max_bins, wc)
    out = _plain(bins, m, max_bins)
    assert out.shape == (1, wc, d * max_bins)
    pallas = np.asarray(hist_matmul(jnp.asarray(bins), jnp.asarray(m[0]), max_bins))
    np.testing.assert_array_equal(out[0], pallas)
    np.testing.assert_array_equal(out[0], _xla_onehot(bins, m[0], max_bins))


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_plain_matches_pallas_for_float_weights(shape):
    n, d, max_bins, wc = shape
    bins, m = _inputs(n, d, max_bins, wc, integer=False, seed=1)
    out = _plain(bins, m, max_bins)
    pallas = np.asarray(hist_matmul(jnp.asarray(bins), jnp.asarray(m[0]), max_bins))
    np.testing.assert_allclose(out[0], pallas, rtol=1e-5)


def test_tree_axis_is_one_histogram_per_tree():
    bins, m = _inputs(300, 7, 8, 12, trees=3, seed=2)
    out = _plain(bins, m, 8)
    assert out.shape == (3, 12, 7 * 8)
    for t in range(3):
        np.testing.assert_array_equal(out[t], _xla_onehot(bins, m[t], 8))


def test_out_of_range_bins_contribute_nothing():
    bins, m = _inputs(40, 3, 4, 5, seed=3)
    bins[::3, 1] = 4  # one past the last bin, as one_hot ignores it
    out = _plain(bins, m, 4)
    np.testing.assert_array_equal(out[0], _xla_onehot(bins, m[0], 4))


def test_wrapper_takes_plain_version_on_cpu_tensors_only():
    bins, m = _inputs(64, 5, 8, 6, trees=2, seed=4)
    before = hist_ops.HIST_LAUNCHES
    out = hist_ops.hist(torch.from_numpy(bins), torch.from_numpy(m), 8)
    np.testing.assert_array_equal(out.numpy(), _plain(bins, m, 8))
    assert hist_ops.HIST_LAUNCHES == before  # the kernel did not run


def test_wrapper_rejects_wrong_types_and_shapes():
    bins, m = _inputs(16, 3, 4, 6)
    with pytest.raises(TypeError):
        hist_ops.hist(torch.from_numpy(bins).long(), torch.from_numpy(m), 4)
    with pytest.raises(ValueError):
        hist_ops.hist(torch.from_numpy(bins), torch.from_numpy(m[0]), 4)


@pytest.mark.parametrize(
    "wc,max_bins", [(48, 32), (96, 32), (6, 8), (384, 32), (96, 512)]
)
def test_tile_fits_hopper_shared_memory(wc, max_bins):
    wc_tile, f_tile = hist_ops.tile_shape(wc, max_bins)
    assert 1 <= wc_tile * f_tile <= 1024
    assert max_bins * (wc_tile * f_tile + 1) * 4 <= 232_448


def test_tile_raises_past_the_envelope():
    with pytest.raises(ValueError):
        hist_ops.tile_shape(96, 4096)
