"""Tensor parallelism of the port against the JAX package's.

Ports ``tests/test_tensor_parallel.py``.  The placement specs are checked
here against ``har_tpu``'s on the same model (the port's spec of a weight
is the JAX spec of the kernel reversed); the training cases run in CPU
``gloo`` groups of 4 (dp 2 × tp 2) and 2 (dp 2) processes, started once
for the file (``tests/_torch_ranks.py``):

- ``shard_params`` places the first Dense weight ``Shard(0)`` on tp, 8 of
  16 rows a rank; the rule table's shard and gather closures round-trip;
- tp training of an MLP (dropout 0) from injected parameters equals the
  port's single-device fit and ``har_tpu``'s fit on a dp 2 × tp 2 mesh
  (losses rtol 1e-4, parameters atol 1e-4), staged and streamed;
- with ``class_weight="balanced"`` and augmentation, dp 2 × tp 2 equals
  dp 2 × tp 1 (the same per-shard draws; rtol 1e-5) and the weighted loss
  lifts the minority's recall;
- a checkpointed tp run resumes after a crash on the unbroken run's
  parameters (rtol 1e-5), and early stopping picks single device's epoch;
- ``Transformer1D`` placed as both trainers place it
  (``dense_alternating_specs``) and under ``TRANSFORMER_RULES`` (qkv
  column-split), K2 on each rank's local tensors, equals its unsharded
  forward and gradients (atol 1e-5); three dp 2 × tp 2 steps from
  converted flax parameters equal the single-device trainer's and
  ``har_tpu``'s dp 2 × tp 2 trainer's (atol 1e-4);
- tp alone on 2 ranks (dp 1 × tp 2, no data group), MLP and transformer,
  equals the single-device fit and ``har_tpu``'s dp 1 × tp 2 fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from har_tpu.models.neural import MLP as JaxMLP
from har_tpu.models.transformer import Transformer1D as JaxTransformer1D
from har_tpu.parallel import create_mesh as jax_create_mesh
from har_tpu.parallel import dense_alternating_specs as jax_specs
from har_tpu.train import trainer as jax_trainer
from har_tpu_torch.convert import mlp_params_from_flax, transformer_params_from_flax
from har_tpu_torch.models.neural import MLP
from har_tpu_torch.models.transformer import Transformer1D
from har_tpu_torch.parallel import P, dense_alternating_specs
from har_tpu_torch.parallel.tensor_parallel import tp_dim_check
from har_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

CFG = dict(batch_size=16, epochs=8, learning_rate=1e-2, seed=0)


def _port_mlp(hidden):
    return MLP(num_classes=6, hidden=hidden, dtype="float32", in_features=13)


def _jax_params(hidden):
    model = JaxMLP(num_classes=6, hidden=hidden, dtype=jnp.float32)
    return model, model.init(jax.random.PRNGKey(0), jnp.zeros((2, 13)), train=False)["params"]


def _reversed(spec):
    return P(*reversed(tuple(spec)))


def test_megatron_specs_alternate():
    specs = dense_alternating_specs(_port_mlp((16, 32)))
    assert specs["layers.0.weight"] == P("tp", None)  # column-parallel
    assert specs["layers.0.bias"] == P("tp")
    assert specs["layers.1.weight"] == P(None, "tp")  # row-parallel
    assert specs["layers.1.bias"] == P()
    assert specs["head.weight"] == P("tp", None)
    # the JAX kernel's spec, reversed onto the (out, in) weight
    want = jax_specs(_jax_params((16, 32))[1])
    for i, name in enumerate(("layers.0", "layers.1", "head")):
        assert specs[f"{name}.weight"] == _reversed(want[f"Dense_{i}"]["kernel"])
        assert tuple(specs[f"{name}.bias"]) == tuple(want[f"Dense_{i}"]["bias"])


def test_specs_natural_order_beyond_ten_layers():
    """layers.10 comes after layers.9: the forward order keeps the parity
    alternation past ten layers (11 kernels, the head last)."""
    specs = dense_alternating_specs(_port_mlp((16,) * 10))
    names = [f"layers.{i}.weight" for i in range(10)] + ["head.weight"]
    for i, name in enumerate(names):
        assert specs[name] == (P("tp", None) if i % 2 == 0 else P(None, "tp")), name


def test_tp_dim_check_rejects_indivisible():
    module = _port_mlp((10,))  # 10 % 4 != 0
    with pytest.raises(ValueError, match="not divisible"):
        tp_dim_check(module, dense_alternating_specs(module), tp=4)


def _jax_transformer():
    x, _ = ranks.transformer_data()
    module = JaxTransformer1D(**dict(ranks.TRANSFORMER, dtype=jnp.float32))
    init = module.init(jax.random.PRNGKey(5), jnp.asarray(x[:2]))["params"]
    return module, jax.tree.map(np.array, init)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    x, _ = ranks.mlp_data()
    _, init = _jax_params((16,))
    _, transformer_init = _jax_transformer()
    work = tmp_path_factory.mktemp("ranks")
    args = {"tp_mlp": {"cfg": CFG, "init": mlp_params_from_flax(init)},
            "tp_resume_early_stop": {"dir": str(work / "ck")},
            "tp_transformer_steps": {"init": transformer_params_from_flax(transformer_init)},
            "tp_no_dp": {"cfg": CFG, "mlp_init": mlp_params_from_flax(init),
                         "transformer_init": transformer_params_from_flax(transformer_init)}}
    four, two = ranks.run_groups(
        [(["tp_shard_params", "tp_mlp", "tp_weighted_augmented", "tp_transformer_forward",
           "tp_transformer_steps", "tp_resume_early_stop", "tp_train_step"], 4, args),
         (["tp_weighted_augmented", "tp_no_dp"], 2, args)],
        work,
    )
    return {4: four, 2: two}


def test_shard_params_places_on_tp_axis(results):
    for r in results[4]:
        got = r["tp_shard_params"]
        assert got["placements"] == "(Shard(dim=0),)"
        # a tp=2 shard of the (16, 13) weight holds 16/2 output rows
        assert got["local"] == (8, 13)
        assert got["round_trip"]


@pytest.fixture(scope="module")
def references():
    """The port's single-device fit and har_tpu's dp 2 × tp 2 fit of the
    MLP, from the same parameters."""
    x, y = ranks.mlp_data()
    _, init = _jax_params((16,))
    single = ranks.fit_mlp(None, x, y, CFG, init=mlp_params_from_flax(init))
    jax_model = JaxMLP(num_classes=6, hidden=(16,), dropout_rate=0.0, dtype=jnp.float32)
    want = jax_trainer.Trainer(
        jax_model, jax_trainer.TrainerConfig(**CFG),
        mesh=jax_create_mesh(dp=2, tp=2, devices=jax.devices()[:4]),
    ).fit(x, y, num_classes=6, init_params=jax.tree.map(np.array, init))
    return single, want


def _jax_fit(family, dp, tp):
    """har_tpu's Trainer on a (dp, tp) mesh from the parameters the ranks
    start from."""
    mesh = jax_create_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    if family == "mlp":
        x, y = ranks.mlp_data()
        _, init = _jax_params((16,))
        module = JaxMLP(num_classes=6, hidden=(16,), dropout_rate=0.0, dtype=jnp.float32)
        return jax_trainer.Trainer(module, jax_trainer.TrainerConfig(**CFG), mesh=mesh).fit(
            x, y, num_classes=6, init_params=jax.tree.map(np.array, init))
    x, y = ranks.transformer_data()
    module, init = _jax_transformer()
    return jax_trainer.Trainer(module, jax_trainer.TrainerConfig(**ranks.TRANSFORMER_CFG),
                               mesh=mesh).fit(x, y, num_classes=4, init_params=init)


def _single(family):
    if family == "mlp":
        x, y = ranks.mlp_data()
        return ranks.fit_mlp(None, x, y, CFG,
                             init=mlp_params_from_flax(_jax_params((16,))[1]))
    return ranks.fit_transformer(None, transformer_params_from_flax(_jax_transformer()[1]))


def _assert_params_close(got, want, atol=1e-4):
    """Parameters within ``atol``; of a transformer's qkv bias only the
    query and value parts (the key bias's gradient is zero in exact
    arithmetic: Adam turns each run's float noise there into full-size
    steps)."""
    e = ranks.TRANSFORMER["embed_dim"]
    assert set(got) == set(want)
    for k, v in want.items():
        g, w = np.asarray(got[k]), np.asarray(v)
        if k.endswith("qkv.bias"):
            g, w = np.delete(g, np.s_[e:2 * e]), np.delete(w, np.s_[e:2 * e])
        np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


@pytest.mark.parametrize("route", ["tp", "tp_streamed"])
def test_tp_training_matches_single_device_and_jax(results, references, route):
    single, want = references
    got = results[4][0]["tp_mlp"][route]
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["loss"], want.history["loss"], rtol=1e-4, atol=1e-5)
    want_sd = mlp_params_from_flax(want.params)
    for k, v in single["params"].items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["params"][k], want_sd[k], atol=1e-4, err_msg=k)
    for r in results[4]:  # every rank gathers the same whole parameters
        np.testing.assert_array_equal(r["tp_mlp"][route]["logits"], got["logits"])


def test_tp_class_weight_and_augment(results):
    """Balanced weights and augmentation inside the tp step: the same
    per-shard draws as dp 2 alone, and the minority is learned."""
    x, y = ranks.skewed_data()
    tp = results[4][0]["tp_weighted_augmented"]
    dp = results[2][0]["tp_weighted_augmented"]
    np.testing.assert_allclose(tp["loss"], dp["loss"], rtol=1e-5, atol=1e-6)
    for k, v in dp["params"].items():
        np.testing.assert_allclose(tp["params"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    pred = tp["logits"].argmax(-1)
    assert (pred[y == 1] == 1).mean() > 0.5


def test_gspmd_train_step_equals_scan_fit(results):
    """The streamed factory and the staged one take the same steps, dropout
    draws included (each data shard's generator)."""
    for r in results[4]:
        got = r["tp_train_step"]
        np.testing.assert_array_equal(got["step"], got["fit"])
        assert np.isfinite(got["step"]).all()


def test_tp_checkpoint_resume_and_early_stop(results):
    """Snapshots of a tp run hold whole tensors (gathered from the
    DTensors) and every data shard's generators; a resumed run reloads
    them into the shards and ends where the unbroken run ends."""
    got = results[4][0]["tp_resume_early_stop"]
    assert got["crash"] == "RuntimeError: simulated crash"
    assert got["resumed"]["history"]["resumed_from_epoch"] == 2
    for k, v in got["whole"]["params"].items():
        np.testing.assert_allclose(got["resumed"]["params"][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    tp, single = got["early_tp"]["history"], got["early_single"]["history"]
    assert tp["best_epoch"] == single["best_epoch"]
    assert tp["stopped_epoch"] == single["stopped_epoch"]
    np.testing.assert_allclose(tp["val_accuracy"], single["val_accuracy"], atol=1e-6)


def _assert_tp_forward(got, layout):
    np.testing.assert_allclose(got[layout]["got"], got["want"], atol=1e-5)
    for k, g in got["want_grads"].items():
        np.testing.assert_allclose(got[layout]["grads"][k], g, atol=1e-5, err_msg=k)
    return got[layout]["placements"]


def test_tp_transformer_equals_unsharded(results):
    """Placed as both trainers place it (``shard_params``' default): the
    JAX trainer's walk, mlp_in, mlp_out, proj, qkv, ..., embed, head."""
    placements = _assert_tp_forward(results[4][0]["tp_transformer_forward"], "trainer")
    assert placements["blocks.0.mlp_in.weight"] == "(Shard(dim=0),)"
    assert placements["blocks.0.mlp_out.weight"] == "(Shard(dim=1),)"
    assert placements["blocks.0.proj.weight"] == "(Shard(dim=0),)"
    assert placements["blocks.0.qkv.weight"] == "(Shard(dim=1),)"
    assert placements["embed.weight"] == "(Shard(dim=0),)"
    assert placements["head.weight"] == "(Shard(dim=1),)"


def test_tp_transformer_rules_equal_unsharded(results):
    """Placed by TRANSFORMER_RULES: qkv column-split, proj row-split,
    embedding and head replicated."""
    placements = _assert_tp_forward(results[4][0]["tp_transformer_forward"], "rules")
    assert placements["blocks.0.qkv.weight"] == "(Shard(dim=0),)"
    assert placements["blocks.0.proj.weight"] == "(Shard(dim=1),)"
    assert placements["head.weight"] == "(Replicate(),)"


def test_tp_transformer_steps_match_single_device(results):
    """dp 2 × tp 2 from converted flax parameters: the port's single
    device and har_tpu's Trainer on the same mesh shape."""
    got = results[4][0]["tp_transformer_steps"]
    single = _single("transformer")
    want = _jax_fit("transformer", 2, 2)
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["loss"], want.history["loss"], rtol=1e-4, atol=1e-4)
    _assert_params_close(got["params"], single["params"])
    _assert_params_close(got["params"], transformer_params_from_flax(want.params))
    # the column split of qkv under TRANSFORMER_RULES makes DTensor
    # all-gather the projection (one a layer) before q, k and v split
    layers = ranks.TRANSFORMER["num_layers"]
    assert got["comms"]["rules"]["c10d_functional.all_gather_into_tensor"] == layers
    assert got["comms"]["trainer"]  # the trainer's layout communicates too


@pytest.mark.parametrize("family", ["mlp", "transformer"])
def test_tp_without_dp_matches_single_device_and_jax(results, family):
    """dp 1 × tp 2 (``train --tp 2`` on two ranks): no data group, the
    replicated parameters' gradients placed back before the update."""
    want = _jax_fit(family, 1, 2)
    single = _single(family)
    for r in results[2]:
        got = r["tp_no_dp"][family]
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["loss"], want.history["loss"], rtol=1e-4, atol=1e-4)
        _assert_params_close(got["params"], single["params"])
        to_port = mlp_params_from_flax if family == "mlp" else transformer_params_from_flax
        _assert_params_close(got["params"], to_port(want.params))
