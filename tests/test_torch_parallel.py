"""The port's meshes and data-parallel steps against the JAX package's.

Ports the contracts of ``tests/test_parallel.py`` and the guards of
``tests/test_multihost.py``.  The port's ranks run in CPU ``gloo`` groups of
2 and 4 processes (``tests/_torch_ranks.py``, started once for the file);
the JAX references run here on the 8 virtual CPU devices:

- mesh shapes and their errors, ``pad_to_multiple``;
- ``make_dp_train_step`` at dp 2 and 4 equals the port on one device and
  ``har_tpu``'s step on ``create_mesh(dp=...)`` (SGD, 25 steps, rtol 2e-5);
  padding counts for nothing;
- ``Trainer(mesh=create_mesh(dp=...))`` from the same injected parameters
  equals the port's single-device fit and ``har_tpu``'s fit on the same
  mesh shape (losses rtol 1e-4, parameters atol 1e-4);
- the world-size guard: a mesh whose dp × tp is not the process group's
  size raises ``ValueError`` before any fit;
- LR's mesh-sharded ``cv_scores`` equals its unsharded scores, and
  ``sweep`` hands its mesh to LR's CrossValidator;
- ``train --distributed --device cpu`` in two processes through the CLI.
"""

import json
import re
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_ranks as ranks
from har_tpu.models.neural import MLP as JaxMLP
from har_tpu.parallel import create_mesh as jax_create_mesh
from har_tpu.parallel import make_dp_train_step as jax_dp_step
from har_tpu.parallel import shard_batch as jax_shard_batch
from har_tpu.train import trainer as jax_trainer
from har_tpu_torch import runner
from har_tpu_torch.config import DataConfig, MeshConfig, RunConfig
from har_tpu_torch.convert import mlp_params_from_flax
from har_tpu_torch.parallel import mesh as port_mesh
from har_tpu_torch.parallel import pad_to_multiple

torch.set_num_threads(1)

CFG = dict(batch_size=32, epochs=4, learning_rate=1e-2, seed=0)
GROUP_2 = ["mesh_shapes", "dp_toy", "dp_padding", "jit_col_sum", "trainer_dp", "world_guard",
           "lr_sweep", "sweep_dp"]
GROUP_4 = ["mesh_shapes", "dp_toy", "dp_padding", "trainer_dp", "lr_sweep"]


def _jax_init():
    x, _ = ranks.mlp_data()
    module = JaxMLP(num_classes=6, hidden=(16,), dropout_rate=0.0, dtype=jnp.float32)
    init = module.init(jax.random.PRNGKey(3), jnp.asarray(x[:2]))["params"]
    return module, jax.tree.map(np.array, init)


def _cli_cmd(rank, port, out):
    return [sys.executable, "-m", "har_tpu_torch.cli", "train", "--models", "mlp", "--no-cv",
            "--epochs", "2", "--device", "cpu", "--dp", "2", "--distributed",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(rank), "--output-dir", str(out)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    _, init = _jax_init()
    args = {"trainer_dp": {"cfg": CFG, "init": mlp_params_from_flax(init)},
            "world_guard": {"out": str(work / "guard")},
            "sweep_dp": {"out": str(work / "sweep")}}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    two, four, cli = ranks.run_groups([(GROUP_2, 2, args), (GROUP_4, 4, args)], work,
                                      also=[_cli_cmd(r, port, work / "cli") for r in range(2)])
    return {2: two, 4: four, "cli": (cli, work)}


def test_mesh_shapes(results):
    for world in (2, 4):
        got = results[world][0]["mesh_shapes"]
        assert got["all"] == {"dp": world, "tp": 1}
        assert got["tp2"] == {"dp": world // 2, "tp": 2}
        assert "dp*tp=6 != device count" in got["bad_product"]
        assert "--distributed" in got["bad_product"] and "torchrun" in got["bad_product"]
        assert "must divide" in got["bad_tp"]
        assert got["linear"] == {"sp": world}
        assert "torchrun" in got["bad_linear"]
    four = results[4]
    assert four[0]["mesh_shapes"]["hybrid"] == {"dp_dcn": 2, "dp": 2, "tp": 1}
    # slice-major linear shard ids, and the two-stage sum over both data axes
    assert [r["mesh_shapes"]["hybrid_index"] for r in four] == [0, 1, 2, 3]
    assert {r["mesh_shapes"]["hybrid_sum"] for r in four} == {6.0}
    assert "must divide" in four[0]["mesh_shapes"]["bad_slices"]
    # the shape-only helpers need no process group
    assert port_mesh.data_shard_count({"dp_dcn": 2, "dp": 2, "tp": 2}) == 4
    assert port_mesh.model_shard_count({"dp": 4, "tp": 2}) == 2
    assert port_mesh.model_shard_count({"dp": 8}) == 1


def test_mesh_without_ranks_raises():
    with pytest.raises(ValueError, match="torchrun"):
        port_mesh.create_mesh(dp=2, device="cpu")


def test_pad_to_multiple():
    a = np.arange(10).reshape(5, 2)
    padded, n_pad = pad_to_multiple(a, 4)
    assert padded.shape == (8, 2) and n_pad == 3
    assert (padded[5:] == 0).all()
    same, n_pad = pad_to_multiple(a, 5)
    assert n_pad == 0 and same is a


def _jax_toy(dp, x, y, steps=25):
    params = {"w": jnp.zeros((x.shape[1], 3), jnp.float32), "b": jnp.zeros((3,), jnp.float32)}

    def loss_fn(p, xb, yb, mask):
        ce = optax.softmax_cross_entropy_with_integer_labels(xb @ p["w"] + p["b"], yb)
        return jnp.sum(ce * mask), jnp.sum(mask)

    opt = optax.sgd(0.5)
    mesh = jax_create_mesh(dp=dp, tp=1, devices=jax.devices()[:dp])
    step = jax_dp_step(loss_fn, opt, mesh, donate=False)
    batch = jax_shard_batch(mesh, x, y)
    state, losses = opt.init(params), []
    for _ in range(steps):
        params, state, loss = step(params, state, *batch)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("world", [2, 4])
def test_dp_matches_single_device_and_jax(results, world):
    x, y = ranks.toy_problem()
    single, single_params = ranks.train_toy(None, x, y)
    got = results[world]
    for r in got:  # replicated: every rank ends on the same parameters
        np.testing.assert_array_equal(r["dp_toy"]["losses"], got[0]["dp_toy"]["losses"])
    np.testing.assert_allclose(got[0]["dp_toy"]["losses"], single, rtol=2e-5)
    np.testing.assert_allclose(got[0]["dp_toy"]["losses"], _jax_toy(world, x, y), rtol=2e-5)
    assert single[-1] < single[0] * 0.5  # it learns
    for k in single_params:
        np.testing.assert_allclose(got[0]["dp_toy"]["params"][k], single_params[k],
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_loss_ignores_padding(results, world):
    # 101 rows pad to 102 (dp 2) or 104 (dp 4); the uniform init's mean CE
    # is log(3) whatever the padding
    got = results[world][0]["dp_padding"]
    assert got["mask_sum"] == 101
    assert got["local_rows"] == -(-101 // world)
    np.testing.assert_allclose(got["loss"], np.log(3.0), rtol=1e-6)


def test_jit_replicated_reduction(results):
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    for r in results[2]:
        np.testing.assert_allclose(r["jit_col_sum"]["out"].numpy(), x.sum(axis=0))


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_dp_matches_single_device_and_jax(results, world):
    """Dropout 0, no augmentation: the dp fit is the full batch's fit up to
    the order of the gradient sum."""
    x, y = ranks.mlp_data()
    module, init = _jax_init()
    single = ranks.fit_mlp(None, x, y, CFG, init=mlp_params_from_flax(init))
    want = jax_trainer.Trainer(
        module, jax_trainer.TrainerConfig(**CFG),
        mesh=jax_create_mesh(dp=world, tp=1, devices=jax.devices()[:world]),
    ).fit(x, y, num_classes=6, init_params=init)
    got = results[world]
    for r in got:
        np.testing.assert_array_equal(r["trainer_dp"]["logits"], got[0]["trainer_dp"]["logits"])
    got = got[0]["trainer_dp"]
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["loss"], want.history["loss"], rtol=1e-4, atol=1e-5)
    want_sd = mlp_params_from_flax(want.params)
    for k, v in single["params"].items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["params"][k], want_sd[k], atol=1e-4, err_msg=k)


def test_world_size_guard(results, tmp_path):
    """dp × tp must equal the process group's size: a ValueError that
    names the way to start more ranks, before any fit or report."""
    got = results[2][0]["world_guard"]
    assert got["run"].startswith("ValueError") and "needs 4 ranks" in got["run"]
    assert "--distributed" in got["run"] and not got["wrote"]
    config = RunConfig(data=DataConfig(synthetic_rows=300), mesh=MeshConfig(dp=2, tp=2),
                       output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="torchrun"):
        runner.run(config, models=["mlp"], device="cpu")
    assert not (tmp_path / "result.txt").exists()
    # dp x tp == 1 is no mesh: the single-device path
    assert runner._mesh_from_config(RunConfig(), torch.device("cpu")) is None


@pytest.mark.parametrize("world", [2, 4])
def test_lr_mesh_sweep_equals_unsharded(results, world):
    for r in results[world]:
        np.testing.assert_allclose(r["lr_sweep"]["sharded"], r["lr_sweep"]["plain"],
                                   rtol=1e-6, atol=1e-7)
        assert r["lr_sweep"]["sharded"].shape == (6, 2)


def test_sweep_passes_the_mesh_to_lr(results):
    """`sweep` with its LR CrossValidator on a dp 2 mesh: every row equals
    the same sweep's without a mesh, timings aside."""
    for r in results[2]:
        got = r["sweep_dp"]
        assert [row["model"] for row in got["mesh"]] == ["logistic_regression",
                                                         "logistic_regression_cv"]
        assert got["mesh"] == got["plain"]


def _masked(text: str) -> str:
    text = re.sub(r"uid\S*", "uid", text)
    return re.sub(r"\d+\.\d+\s*(s|sec|seconds)\b", "T", text)


def test_cli_distributed_loopback(results):
    """Two processes of `train --distributed --dp 2 --device cpu` join one
    gloo group through a loopback coordinator and train one replicated
    model: both write the same report, timing lines aside, rank 1 under
    the shared directory's rank_1."""
    runs, work = results["cli"]
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
        printed = json.loads(out.strip().splitlines()[-1])
        assert set(printed["accuracies"]) == {"mlp"}
    texts = [(work / "cli" / "result.txt").read_text(),
             (work / "cli" / "rank_1" / "result.txt").read_text()]
    lines = [[ln for ln in _masked(t).splitlines() if "time" not in ln.lower()] for t in texts]
    assert lines[0] == lines[1]


def test_cli_distributed_flag_guards(tmp_path):
    from har_tpu_torch import cli

    with pytest.raises(SystemExit, match="require --distributed"):
        cli.main(["train", "--models", "dt", "--no-cv", "--device", "cpu",
                  "--coordinator", "127.0.0.1:1", "--output-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="coordinator"):
        port_mesh.initialize_distributed(device="cpu")
