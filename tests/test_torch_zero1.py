"""ZeRO-1 of the port (``parallel.zero1``) against the JAX package's.

Ports ``tests/test_zero1.py``.  The ranks run in one CPU ``gloo`` group of
4 processes (``tests/_torch_ranks.py``, started once for the file):

- ``Trainer(zero1=True)`` equals the replicated trainer on the same dp 4
  mesh (parameters rtol 2e-4 / atol 2e-5, losses rtol 1e-4), and
  ``har_tpu``'s zero1 fit on its dp 4 mesh from the same parameters;
- the moments live 1/N a rank over the padded flat vector;
- a hybrid (dp_dcn 2, dp 2) mesh equals the flat dp 4 mesh;
- augmentation, balanced class weights and early stopping compose: the
  same best epoch, validation accuracies and parameters as replicated;
- a run stopped after its first snapshot resumes from it and ends on the
  unbroken run's parameters (rtol 1e-5);
- the guards: ``scan=False``, a tp axis, a batch the shards do not divide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from har_tpu.models.neural import MLP as JaxMLP
from har_tpu.parallel import create_mesh as jax_create_mesh
from har_tpu.train import trainer as jax_trainer
from har_tpu_torch.convert import mlp_params_from_flax
from har_tpu_torch.models.neural import MLP
from har_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def _jax_init():
    x, _ = ranks.zero1_data()
    module = JaxMLP(num_classes=4, hidden=(32, 16), dropout_rate=0.0, dtype=jnp.float32)
    init = module.init(jax.random.PRNGKey(1), jnp.asarray(x[:2]))["params"]
    return module, jax.tree.map(np.array, init)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    _, init = _jax_init()
    args = {"zero1_equals": {"init": mlp_params_from_flax(init)},
            "zero1_resume": {"dir": str(work / "ck")}}
    return ranks.run_ranks(
        ["zero1_equals", "zero1_state", "zero1_features", "zero1_resume", "zero1_guards"],
        4, work, args=args,
    )


def _close(a, b, rtol=2e-4, atol=2e-5):
    for k, v in b.items():
        np.testing.assert_allclose(a[k], v, rtol=rtol, atol=atol, err_msg=k)


def test_zero1_matches_replicated_trainer_and_jax(results):
    got = results[0]["zero1_equals"]
    _close(got["zero1"]["params"], got["base"]["params"])
    np.testing.assert_allclose(got["zero1"]["loss"], got["base"]["loss"], rtol=1e-4, atol=1e-5)
    x, y = ranks.zero1_data()
    assert (got["zero1"]["logits"].argmax(-1) == y).mean() > 0.5
    module, init = _jax_init()
    want = jax_trainer.Trainer(
        module, jax_trainer.TrainerConfig(batch_size=128, epochs=25, learning_rate=3e-3, seed=0),
        mesh=jax_create_mesh(dp=4, tp=1, devices=jax.devices()[:4]), zero1=True,
    ).fit(x, y, num_classes=4, init_params=init)
    np.testing.assert_allclose(got["zero1"]["loss"], want.history["loss"], rtol=1e-4, atol=1e-5)
    _close(got["zero1"]["params"], mlp_params_from_flax(want.params), rtol=1e-3, atol=1e-4)
    assert got["zero1"]["history"]["zero1_shards"] == 4


def test_zero1_opt_state_is_sharded(results):
    for r in results:
        got = r["zero1_state"]
        assert got["dpad"] == -(-got["d"] // 4) * 4
        assert got["mu"] == (got["dpad"] // 4,)
        assert got["count"] == 2 and np.isfinite(got["losses"]).all()


def test_zero1_on_hybrid_multislice_mesh(results):
    """The all-gather's order must be the linear shard order, or the
    parameters would be scrambled: equal to the flat mesh's."""
    got = results[0]["zero1_equals"]
    _close(got["hybrid"]["params"], got["flat"]["params"])


def test_trainer_zero1_composes_full_features(results):
    got = results[0]["zero1_features"]
    base, z1 = got["base"]["history"], got["zero1"]["history"]
    assert z1["best_epoch"] == base["best_epoch"]
    np.testing.assert_allclose(z1["val_accuracy"], base["val_accuracy"], atol=1e-6)
    _close(got["zero1"]["params"], got["base"]["params"])


def test_trainer_zero1_checkpoint_resume(results):
    got = results[0]["zero1_resume"]
    assert got["crash"] == "RuntimeError: simulated crash"
    assert got["resumed"]["history"]["resumed_from_epoch"] == 2
    _close(got["resumed"]["params"], got["whole"]["params"], rtol=1e-5, atol=1e-6)


def test_trainer_zero1_guards(results):
    with pytest.raises(ValueError, match="scan"):
        Trainer(MLP(num_classes=4, hidden=(8,), in_features=13),
                TrainerConfig(batch_size=32, epochs=1), device="cpu", scan=False, zero1=True)
    got = results[0]["zero1_guards"]
    assert "data parallelism only" in got["tp"]
    assert "divisible" in got["batch"]
    assert "divisible" in got["zero1_trainer_batch"]
