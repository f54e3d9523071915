"""The port's warm-refit cache against ``tests/test_warm_refit.py``'s four
contracts, and a warm refit against ``har_tpu``'s cold fit.

A repeat ``NeuralClassifier.fit`` on the same ``FeatureSet`` object reuses
the fitted scaler, the standardized array and the Trainer, whose staged
path keeps the device copies of x and y and the batch schedule
(``Trainer._scan_cache``); parameters and optimizer start anew, so the
refit is bit-identical to a cold one, and a transformer's refit still
attends through K2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from har_tpu.models import neural as jax_neural
from har_tpu.train import trainer as jax_trainer
from har_tpu_torch import convert
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.neural import MLP, build_model
from har_tpu_torch.models.neural_classifier import NeuralClassifier
from har_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return FeatureSet(
        features=rng.normal(size=(n, 13)).astype(np.float32),
        label=rng.integers(0, 6, n).astype(np.int32),
    )


def _flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.inner.module.parameters()]).numpy()


def _mlp(**config):
    return NeuralClassifier(
        "mlp", config=TrainerConfig(batch_size=16, epochs=3, **config),
        model_kwargs={"hidden": (8,)}, device="cpu",
    )


def test_warm_refit_hits_and_is_bit_identical():
    """The second fit on one FeatureSet object is a hit: the same scaler,
    standardized array and device copies, a module of its own (the first
    model keeps its parameters), and parameters bit-identical to the
    first fit's."""
    data = _data()
    est = _mlp()
    m1 = est.fit(data)
    first = _flat(m1).copy()
    cache = dict(est._fit_cache)
    staged = dict(cache["trainer"]._scan_cache)
    m2 = est.fit(data)
    assert m1.history["warm_refit"] is False
    assert m2.history["warm_refit"] is True
    assert m2.scaler is m1.scaler and est._fit_cache["x"] is cache["x"]
    assert est._fit_cache["trainer"] is cache["trainer"]
    assert cache["trainer"]._scan_cache["x"] is cache["x"]
    for key in ("x_dev", "y_dev", "idx_dev"):
        assert cache["trainer"]._scan_cache[key] is staged[key]
    assert m2.inner.module is not m1.inner.module
    assert (_flat(m1) == first).all()
    assert (_flat(m2) == first).all()


def test_different_data_object_misses_but_agrees():
    data = _data()
    clone = FeatureSet(features=data.features.copy(), label=data.label.copy())
    est = _mlp()
    m1 = est.fit(data)
    m3 = est.fit(clone)
    assert m3.history["warm_refit"] is False
    np.testing.assert_allclose(_flat(m1), _flat(m3), rtol=1e-6, atol=1e-7)


def test_copy_with_does_not_share_cache():
    """A config-changed copy must not hit the original's cache (it would
    run another schedule)."""
    data = _data()
    est = _mlp()
    est.fit(data)
    longer = est.copy_with(config=dataclasses.replace(est.config, epochs=5))
    assert longer._fit_cache == {} and longer._fit_cache is not est._fit_cache
    m = longer.fit(data)
    assert m.history["warm_refit"] is False
    assert len(m.history["loss"]) == 5  # per-epoch losses: 5 epochs ran


def test_streaming_path_untouched():
    """The cache is the staged path's only; the streamed trainer never
    writes the key."""
    data = _data()
    tr = Trainer(build_model("mlp", num_classes=6, in_features=13, hidden=(8,)),
                 TrainerConfig(batch_size=16, epochs=2), device="cpu", scan=False)
    m = tr.fit(data.features, data.label, num_classes=6)
    again = tr.fit(data.features, data.label, num_classes=6)
    assert "warm_refit" not in m.history and "warm_refit" not in again.history
    assert tr._scan_cache is None
    assert np.isfinite(m.history["loss"][-1])


def test_warm_refit_matches_har_tpu_cold_fit():
    """From the same flax init (``convert``), three steps of the port's
    Trainer refitted warm on the same arrays equal its cold fit bit for
    bit and ``har_tpu``'s cold fit within 1e-4 (losses, parameters)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(24, 13)).astype(np.float32)
    y = rng.integers(0, 6, 24).astype(np.int32)
    cfg = dict(batch_size=32, epochs=3, learning_rate=1e-2, seed=1)
    jax_model = jax_neural.MLP(dtype=jnp.float32, hidden=(32, 16), dropout_rate=0.0)
    init = jax.tree.map(np.array, jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = jax_trainer.Trainer(jax_model, jax_trainer.TrainerConfig(**cfg)).fit(
        x, y, num_classes=6, init_params=init
    )
    tr = Trainer(MLP(dtype="float32", in_features=13, hidden=(32, 16), dropout_rate=0.0),
                 TrainerConfig(**cfg), device="cpu")
    cold = tr.fit(x, y, num_classes=6, init_params=convert.mlp_params_from_flax(init))
    cold_sd = {k: v.clone() for k, v in cold.module.state_dict().items()}
    warm = tr.fit(x, y, num_classes=6, init_params=convert.mlp_params_from_flax(init))
    assert (cold.history["warm_refit"], warm.history["warm_refit"]) == (False, True)
    assert warm.history["loss"] == cold.history["loss"]
    for key, value in convert.mlp_params_from_flax(want.params).items():
        assert torch.equal(warm.module.state_dict()[key], cold_sd[key]), key
        np.testing.assert_allclose(warm.module.state_dict()[key].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(warm.history["loss"], want.history["loss"], rtol=1e-4, atol=1e-4)


def test_transformer_warm_refit_still_runs_k2(monkeypatch):
    """A transformer's warm refit attends through K2's op as the cold fit
    does (counted forwards equal, nonzero) and is bit-identical to it."""
    import har_tpu_torch.ops.flash_attention as flash

    rng = np.random.default_rng(1)
    data = FeatureSet(features=rng.normal(size=(24, 16, 3)).astype(np.float32),
                      label=rng.integers(0, 4, 24).astype(np.int32))
    est = NeuralClassifier(
        "transformer", config=TrainerConfig(batch_size=8, epochs=1),
        model_kwargs=dict(embed_dim=16, num_heads=2, num_layers=1, dtype="float32"),
        device="cpu",
    )
    calls = []
    real = flash.flash_attention_fwd
    monkeypatch.setattr(flash, "flash_attention_fwd",
                        lambda q, k, v, lse: calls.append(q.shape) or real(q, k, v, lse))
    m1 = est.fit(data)
    cold_calls, first = len(calls), _flat(m1).copy()
    m2 = est.fit(data)
    assert m2.history["warm_refit"] is True
    assert cold_calls > 0 and len(calls) == 2 * cold_calls
    assert (_flat(m2) == first).all()
