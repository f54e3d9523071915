"""Scenarios that run on every rank of a CPU ``gloo`` group, for the port's
parallel tests (``tests/test_torch_{parallel,tensor_parallel,zero1,
ring_attention,expert_parallel,pipeline_parallel}.py``).

``run_ranks(names, world, workdir)`` starts ``world`` processes of this file,
each joins one group (rendezvous through a ``FileStore`` under
``workdir``), runs the named scenarios in order and saves what they
return; ``run_groups`` runs several groups in turn.  The ranks import
torch and ``har_tpu_torch`` only and run one thread each, scheduled on
idle cores only; the test process collects the results.  The test files group their cases under one
start-up a file, and the test workers take turns (a lock file), so at
most one file's ranks run at a time.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
import sys
import tempfile
import threading


def _yield_the_cores() -> None:
    """The ranks (and the commands run beside them) run only on cores the
    other test workers leave idle, from before they import torch: some of
    those workers time what they run."""
    try:
        os.sched_setscheduler(0, os.SCHED_IDLE, os.sched_param(0))
    except (AttributeError, OSError):
        os.nice(19)


if __name__ == "__main__":
    _yield_the_cores()
    if sys.argv[1] == "--exec":  # a command run beside the ranks
        os.execv(sys.argv[2], sys.argv[2:])

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def _start(names, world: int, workdir: str, args) -> list:
    tag = f"{world}_{'_'.join(names)}"[:80]
    argfile = os.path.join(workdir, f"args_{tag}.pt")
    torch.save(dict(args or {}), argfile)
    store = os.path.join(workdir, f"store_{tag}")
    if os.path.exists(store):
        os.remove(store)
    env = _env()
    return [
        (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), ",".join(names), str(rank),
             str(world), store, os.path.join(workdir, f"out_{tag}_{rank}.pt"), argfile],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO,
        ), os.path.join(workdir, f"out_{tag}_{rank}.pt"))
        for rank in range(world)
    ]


@contextlib.contextmanager
def _one_at_a_time():
    """Test workers share the machine's cores: one worker's rank groups
    run at a time, so the ranks never crowd the other tests' timing."""
    path = os.path.join(tempfile.gettempdir(), "har_tpu_torch_ranks.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_groups(groups, workdir, timeout: float = 240, also=()) -> list[list[dict]]:
    """Run every group of ``groups`` — ``(scenario names, world size,
    args by scenario)`` — one after another, and the commands of ``also``
    (argv lists, run from the repository's root) beside the first; each
    group's ranks' ``{scenario: result}``, in rank order, then the
    ``(returncode, output)`` of each command of ``also``."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with _one_at_a_time():
        extra = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--exec", *argv],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, env=_env(), cwd=REPO)
                 for argv in also]
        try:
            results = [_run(_start(names, world, workdir, args), timeout)
                       for names, world, args in groups]
            if also:
                results.append([(p.returncode, out) for p, out in
                                zip(extra, _wait(extra, timeout))])
        finally:
            _kill(extra)
    return results


def _wait(procs, timeout) -> list[str]:
    return [p.communicate(timeout=timeout)[0] for p in procs]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _run(started, timeout) -> list[dict]:
    """Every rank's results of one started group."""
    procs = [p for p, _ in started]
    try:
        outs = _wait(procs, timeout)
    finally:
        _kill(procs)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {len(procs)} failed:\n{out[-6000:]}"
    return [torch.load(path, weights_only=False) for _, path in started]


def run_ranks(names, world: int, workdir, timeout: float = 240, args=None) -> list[dict]:
    """{scenario: result} of every rank of one group, rank order."""
    return run_groups([(names, world, args)], workdir, timeout)[0]


# ------------------------------------------------------------ wire cells

# the environment and priority of the wire tests' worker, agent and
# gateway processes: one thread each, the lowest weight (not SCHED_IDLE:
# an RPC server must keep answering on a busy machine)
CHILD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
CHILD_NICE = 19


@contextlib.contextmanager
def child_hygiene():
    """Within it, the processes the launchers of ``serve/net`` start run
    with ``CHILD_ENV`` at ``nice CHILD_NICE``: they inherit this
    process's environment (``controller._child_env``) and start under
    ``controller._nice()``."""
    import pytest

    from har_tpu_torch.serve.net import controller

    with pytest.MonkeyPatch.context() as mp:
        for key, value in CHILD_ENV.items():
            mp.setenv(key, value)
        mp.setattr(controller, "_nice", lambda: ["nice", "-n", str(CHILD_NICE)])
        yield


_cell = threading.local()


def current_cell():
    """The name of the cell ``run_cells`` runs on this thread (None off
    its threads): a spy on a runner files what it sees under it."""
    return getattr(_cell, "name", None)


def run_cells(cells: dict, max_workers: int = 3) -> dict:
    """Run the zero-argument callables ``cells`` (each one chaos cell or
    smoke that starts its own processes), at most ``max_workers`` at a
    time on threads of this process, under the lock the rank groups
    take and ``child_hygiene``; ``{name: ("ok", result) | ("error",
    exception)}``, so one failing cell leaves the others' verdicts
    readable."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name, fn):
        _cell.name = name
        try:
            return ("ok", fn())
        except Exception as exc:  # noqa: BLE001 - reported by its test
            return ("error", exc)
        finally:
            _cell.name = None

    with _one_at_a_time(), child_hygiene(), ThreadPoolExecutor(max_workers) as pool:
        futures = {name: pool.submit(one, name, fn) for name, fn in cells.items()}
        return {name: f.result() for name, f in futures.items()}


def cell(results: dict, name: str):
    """One cell's result; a cell that raised raises here, in its test."""
    status, value = results[name]
    if status == "error":
        raise value
    return value


def event_fields(events) -> dict:
    """``{session: [(t_index, label, raw_label, drift, probability
    bytes), ...]}`` in delivery order, for events of either package."""
    out: dict = {}
    for fe in events:
        ev = fe.event
        out.setdefault(fe.session_id, []).append(
            (ev.t_index, ev.label, ev.raw_label, ev.drift, ev.probability.tobytes()))
    return out


def jax_reference(*, sessions: int, n_samples: int, workers: int, window: int = 100,
                  hop: int = 50, seed: int = 0, swap: bool = False) -> list:
    """The JAX package's un-killed in-process cluster run of a wire
    cell's schedule on the same recordings, its events in delivery
    order: with ``swap`` the wire kill matrix's (the hot swap to
    ``tau=5`` half way), else the hop rounds of the partition, takeover
    and gateway cells."""
    import shutil

    from har_tpu.serve import chaos
    from har_tpu.serve.faults import FakeClock
    from har_tpu.serve.loadgen import AnalyticDemoModel

    models = {"A": AnalyticDemoModel(), "B": AnalyticDemoModel(tau=5.0)}
    recordings = chaos._recordings(sessions, n_samples, 3, seed)
    root = tempfile.mkdtemp(prefix="har_jaxref_")
    try:
        clock = FakeClock()
        ref = chaos._build_cluster(
            root, clock, sessions=sessions, workers=workers, window=window, hop=hop,
            model=models["A"], flush_every=512, snapshot_every=40,
            loader=lambda ver: models.get(ver, models["A"]))
        for w in ref._workers.values():
            w.server._fault_hook = None  # the wire workers inject no stalls
        for i in range(sessions):
            ref.add_session(i)
        events: list = []
        if swap:
            chaos._cluster_schedule(ref, recordings, [0] * sessions, hop=hop, clock=clock,
                                    models=models, swap_sample=(n_samples // hop // 2) * hop,
                                    events=events)
        else:
            for r in range(n_samples // hop):
                for i in range(sessions):
                    ref.push(i, recordings[i][r * hop:(r + 1) * hop])
                events.extend(ref.poll(force=True))
                clock.advance(0.01)
            events.extend(ref.flush())
        ref.close()
        return events
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- helpers


def toy_problem(n=103, d=7, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=(d, c)).astype(np.float32)
    y = (x @ w_true).argmax(-1).astype(np.int32)
    return x, y


def toy_loss(params, x, y, mask):
    logits = x @ params["w"] + params["b"]
    ce = torch.nn.functional.cross_entropy(logits, y.long(), reduction="none")
    return (ce * mask).sum(), mask.sum()


def train_toy(mesh, x, y, steps=25, lr=0.5):
    """``make_dp_train_step`` with SGD on the toy problem (the JAX test's
    ``_train``): the per-step losses and the final parameters."""
    from har_tpu_torch.parallel import make_dp_train_step, shard_batch

    params = {
        "w": torch.zeros((x.shape[1], 3), requires_grad=True),
        "b": torch.zeros((3,), requires_grad=True),
    }
    opt = torch.optim.SGD(list(params.values()), lr=lr)
    step = make_dp_train_step(toy_loss, opt, mesh)
    if mesh is None:
        batch = (torch.from_numpy(x), torch.from_numpy(y), torch.ones(len(x)))
    else:
        batch = shard_batch(mesh, x, y, device="cpu")
    losses = [float(step(params, *batch)) for _ in range(steps)]
    return losses, {k: v.detach().clone() for k, v in params.items()}


def mlp_data(n=128, d=13, c=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, c))
    y = (x @ w).argmax(1).astype(np.int32)
    return x, y


def fit_mlp(mesh, x, y, cfg, init=None, hidden=(16,), zero1=False, augment=None,
            num_classes=6, scan=True):
    from har_tpu_torch.models.neural import MLP
    from har_tpu_torch.train.trainer import Trainer, TrainerConfig

    module = MLP(num_classes=num_classes, hidden=hidden, dropout_rate=0.0,
                 dtype="float32", in_features=x.shape[1])
    model = Trainer(module, TrainerConfig(**cfg), device="cpu", mesh=mesh, zero1=zero1,
                    augment=augment, scan=scan).fit(x, y, num_classes=num_classes,
                                                     init_params=init)
    return {"loss": model.history["loss"], "history": model.history,
            "params": {k: v.detach().clone() for k, v in model.module.state_dict().items()},
            "logits": model.predict_logits(x)}


def transformer_data(n=16, t=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=n).astype(np.int32)
    y[:4] = np.arange(4)
    return x, y


TRANSFORMER = dict(num_classes=4, embed_dim=32, num_heads=4, num_layers=2,
                   dropout_rate=0.0, dtype="float32")
TRANSFORMER_CFG = dict(batch_size=8, epochs=3, learning_rate=1e-2, seed=1)


def fit_transformer(mesh, init=None):
    """Three staged steps of the float32 transformer (dropout 0) on
    ``transformer_data``, from ``init`` (a state_dict) or the seed."""
    from har_tpu_torch.models.transformer import Transformer1D
    from har_tpu_torch.train.trainer import Trainer, TrainerConfig

    x, y = transformer_data()
    model = Trainer(Transformer1D(**TRANSFORMER), TrainerConfig(**TRANSFORMER_CFG),
                    device="cpu", mesh=mesh).fit(x, y, num_classes=4, init_params=init)
    return {"loss": model.history["loss"],
            "params": {k: v.detach().clone() for k, v in model.module.state_dict().items()}}


def jitter(generator, xb):
    noise = torch.randn(xb.shape, generator=generator, device=xb.device)
    return xb + 0.01 * noise


# -------------------------------------------------------------- scenarios

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def tp_transformer_forward(rank, world, args):
    """Transformer1D on a (world/2, 2) mesh, placed as the trainer places
    it (``dense_alternating_specs``) and by TRANSFORMER_RULES: the forward
    and the gradients equal the unsharded module's."""
    from har_tpu_torch.models.transformer import Transformer1D
    from har_tpu_torch.parallel import TRANSFORMER_RULES, create_mesh, match_partition_rules
    from har_tpu_torch.parallel.tensor_parallel import replication, shard_params

    x, y = transformer_data()
    plain = Transformer1D(**TRANSFORMER)
    want = plain(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(want, torch.from_numpy(y).long()).backward()
    out = {"want": want.detach(),
           "want_grads": {k: p.grad.clone() for k, p in plain.named_parameters()}}
    mesh = create_mesh(dp=world // 2, tp=2, device="cpu")
    for layout in ("trainer", "rules"):
        module = Transformer1D(**TRANSFORMER)
        specs = (match_partition_rules(TRANSFORMER_RULES, module) if layout == "rules"
                 else None)
        shard_params(module, mesh, specs)
        with replication():
            got = module(torch.from_numpy(x))
            loss = torch.nn.functional.cross_entropy(got, torch.from_numpy(y).long())
            loss.backward()
        out[layout] = {
            "got": got.full_tensor().detach(),
            "grads": {k: p.grad.full_tensor() for k, p in module.named_parameters()},
            "placements": {k: str(p.placements) for k, p in module.named_parameters()}}
    return out


def _raises(fn) -> str | None:
    try:
        fn()
    except Exception as e:  # the message is the result
        return f"{type(e).__name__}: {e}"
    return None


# ---- tests/test_torch_parallel.py


@scenario
def mesh_shapes(rank, world, args):
    from har_tpu_torch.parallel import mesh as pm

    out = {"all": pm.mesh_shape(pm.create_mesh(device="cpu")),
           "tp2": pm.mesh_shape(pm.create_mesh(dp=world // 2, tp=2, device="cpu")),
           "bad_product": _raises(lambda: pm.create_mesh(dp=3, tp=2, device="cpu")),
           "bad_tp": _raises(lambda: pm.create_mesh(tp=3, device="cpu")),
           "linear": pm.mesh_shape(pm.linear_mesh(-1, "sp", device="cpu")),
           "bad_linear": _raises(lambda: pm.linear_mesh(world + 1, "ep", device="cpu"))}
    if world == 4:
        hybrid = pm.create_multihost_mesh(num_slices=2, device="cpu")
        out["hybrid"] = pm.mesh_shape(hybrid)
        out["hybrid_index"] = pm.linear_data_shard_index(hybrid)
        total = torch.tensor([float(rank)])
        for group in pm.data_groups(hybrid):
            torch.distributed.all_reduce(total, group=group)
        out["hybrid_sum"] = float(total)
        out["bad_slices"] = _raises(lambda: pm.create_multihost_mesh(num_slices=3, device="cpu"))
    return out


@scenario
def dp_toy(rank, world, args):
    from har_tpu_torch.parallel import create_mesh

    x, y = toy_problem()
    losses, params = train_toy(create_mesh(dp=world, device="cpu"), x, y)
    return {"losses": losses, "params": params}


@scenario
def dp_padding(rank, world, args):
    from har_tpu_torch.parallel import create_mesh, make_dp_train_step, shard_batch

    x, y = toy_problem(n=101)
    mesh = create_mesh(dp=world, device="cpu")
    xd, yd, mask = shard_batch(mesh, x, y, device="cpu")
    params = {"w": torch.zeros((x.shape[1], 3), requires_grad=True),
              "b": torch.zeros((3,), requires_grad=True)}
    step = make_dp_train_step(toy_loss, torch.optim.SGD(list(params.values()), lr=0.1), mesh)
    loss = float(step(params, xd, yd, mask))
    return {"mask_sum": float(mask.full_tensor().sum()), "loss": loss,
            "local_rows": int(xd.to_local().shape[0])}


@scenario
def jit_col_sum(rank, world, args):
    from har_tpu_torch.parallel import create_mesh, jit_replicated

    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    out = jit_replicated(lambda a: a.sum(0), create_mesh(device="cpu"))(x)
    return {"out": out}


@scenario
def trainer_dp(rank, world, args):
    from har_tpu_torch.parallel import create_mesh

    x, y = mlp_data()
    return fit_mlp(create_mesh(dp=world, device="cpu"), x, y, args["cfg"], init=args["init"])


@scenario
def world_guard(rank, world, args):
    from har_tpu_torch import runner
    from har_tpu_torch.config import DataConfig, MeshConfig, RunConfig

    config = RunConfig(data=DataConfig(synthetic_rows=300), mesh=MeshConfig(dp=2 * world),
                       output_dir=args["out"])
    return {"run": _raises(lambda: runner.run(config, models=["mlp"], device="cpu")),
            "wrote": os.path.exists(os.path.join(args["out"], "result.txt"))}


@scenario
def lr_sweep(rank, world, args):
    from har_tpu_torch.features.wisdm_pipeline import FeatureSet
    from har_tpu_torch.models.logistic_regression import LogisticRegression
    from har_tpu_torch.parallel import create_mesh

    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    y = (x[:, :3].argmax(1)).astype(np.int32)
    folds = [(np.arange(100, 300), np.arange(100)), (np.arange(200), np.arange(200, 300))]
    grid = [{"reg_param": r, "elastic_net_param": e}
            for r in (0.1, 0.3, 0.5) for e in (0.0, 0.1)]
    data = FeatureSet(x, y)
    mesh = create_mesh(dp=world, device="cpu")
    return {"sharded": LogisticRegression(mesh=mesh, device="cpu").cv_scores(
                data, folds, grid, "accuracy"),
            "plain": LogisticRegression(device="cpu").cv_scores(data, folds, grid, "accuracy")}


# ---- tests/test_torch_tensor_parallel.py


@scenario
def tp_shard_params(rank, world, args):
    from har_tpu_torch.models.neural import MLP
    from har_tpu_torch.parallel import create_mesh, make_shard_and_gather_fns, shard_params
    from har_tpu_torch.parallel.rules import match_partition_rules, rules_for_params

    mesh = create_mesh(dp=world // 2, tp=2, device="cpu")
    module = MLP(num_classes=6, hidden=(16,), dtype="float32", in_features=13)
    whole = {k: v.clone() for k, v in module.state_dict().items()}
    specs = match_partition_rules(rules_for_params(module), module)
    shard_params(module, mesh, specs)
    w = module.layers[0].weight
    shard_fns, gather_fns = make_shard_and_gather_fns(mesh["tp"], specs)
    placed = {k: shard_fns[k](v) for k, v in whole.items()}
    back = {k: gather_fns[k](v) for k, v in placed.items()}
    return {"placements": str(w.placements), "local": tuple(w.to_local().shape),
            "round_trip": all(torch.equal(back[k], whole[k]) for k in whole)}


@scenario
def tp_mlp(rank, world, args):
    from har_tpu_torch.parallel import create_mesh

    x, y = mlp_data()
    out = {"tp": fit_mlp(create_mesh(dp=world // 2, tp=2, device="cpu"), x, y,
                         args["cfg"], init=args["init"])}
    out["tp_streamed"] = fit_mlp(create_mesh(dp=world // 2, tp=2, device="cpu"), x, y,
                                 args["cfg"], init=args["init"], scan=False)
    return out


def skewed_data(n=192, d=8):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] > 1.3).astype(np.int32)
    return x, y


@scenario
def tp_weighted_augmented(rank, world, args):
    """class_weight="balanced" and augmentation on a (world/tp, tp) mesh."""
    from har_tpu_torch.parallel import create_mesh

    x, y = skewed_data()
    cfg = dict(batch_size=32, epochs=6, learning_rate=1e-2, class_weight="balanced", seed=0)
    return fit_mlp(create_mesh(dp=2, tp=world // 2, device="cpu"), x, y, cfg,
                   augment=jitter, num_classes=2)


@scenario
def tp_transformer_steps(rank, world, args):
    """Three staged steps of the transformer on a (world/2, 2) mesh from
    the converted flax parameters, K2 on each rank's local tensors; the
    collectives of one forward under each layout."""
    from torch.distributed.tensor.debug import CommDebugMode

    from har_tpu_torch.models.transformer import Transformer1D
    from har_tpu_torch.parallel import (
        TRANSFORMER_RULES,
        create_mesh,
        match_partition_rules,
        shard_params,
    )
    from har_tpu_torch.parallel.tensor_parallel import replication

    x, _ = transformer_data()
    mesh = create_mesh(dp=world // 2, tp=2, device="cpu")
    out = fit_transformer(mesh, args["init"])
    out["comms"] = {}
    for layout in ("trainer", "rules"):
        probe = Transformer1D(**TRANSFORMER)
        specs = (match_partition_rules(TRANSFORMER_RULES, probe) if layout == "rules"
                 else None)
        shard_params(probe, mesh, specs)
        with replication(), CommDebugMode() as comm:
            probe(torch.from_numpy(x[:4]))
        out["comms"][layout] = {str(k): v for k, v in comm.get_comm_counts().items()}
    return out


@scenario
def tp_no_dp(rank, world, args):
    """A (1, world) mesh: tp alone, no data group to sum over (the
    gradients of replicated parameters still reduced over tp); the MLP
    and the transformer from the converted flax parameters."""
    from har_tpu_torch.parallel import create_mesh

    mesh = create_mesh(dp=1, tp=world, device="cpu")
    x, y = mlp_data()
    return {"mlp": fit_mlp(mesh, x, y, args["cfg"], init=args["mlp_init"]),
            "transformer": fit_transformer(mesh, args["transformer_init"])}


@scenario
def tp_train_step(rank, world, args):
    """``make_gspmd_train_step`` over streamed batches equals
    ``make_gspmd_scan_fit`` over the same schedule (dp × tp 2)."""
    from har_tpu_torch.models.neural import MLP
    from har_tpu_torch.parallel import (
        create_mesh,
        make_gspmd_scan_fit,
        make_gspmd_train_step,
        shard_params,
    )
    from har_tpu_torch.train.trainer import TrainerConfig, make_optimizer

    x, y = mlp_data()
    mesh = create_mesh(dp=world // 2, tp=2, device="cpu")
    idx = torch.from_numpy(np.random.default_rng(0).permutation(128).reshape(8, 16))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    out = {}
    for route in ("step", "fit"):
        module = shard_params(MLP(num_classes=6, hidden=(16,), dropout_rate=0.2,
                                  dtype="float32", in_features=13), mesh)
        opt = make_optimizer(TrainerConfig(learning_rate=1e-2), module.parameters(), 8)
        gens = {"dropout": torch.Generator().manual_seed(rank // 2),
                "augment": torch.Generator().manual_seed(9)}
        if route == "step":
            step = make_gspmd_train_step(module, opt, mesh, generators=gens)
            losses = [step(xt[i], yt[i], torch.ones(16)) for i in idx]
        else:
            losses = make_gspmd_scan_fit(module, opt, mesh, generators=gens)(xt, yt, idx)
        out[route] = [float(v) for v in losses]
    return out


# ---- tests/test_torch_zero1.py


def zero1_data(n=512, d=13, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes))
    y = (x @ w).argmax(axis=1).astype(np.int32)
    return x, y


@scenario
def zero1_equals(rank, world, args):
    from har_tpu_torch.parallel import create_mesh, create_multihost_mesh

    x, y = zero1_data()
    cfg = dict(batch_size=128, epochs=25, learning_rate=3e-3, seed=0)
    mesh = create_mesh(dp=world, device="cpu")
    out = {"base": fit_mlp(mesh, x, y, cfg, hidden=(32, 16), num_classes=4,
                           init=args["init"]),
           "zero1": fit_mlp(mesh, x, y, cfg, hidden=(32, 16), num_classes=4, zero1=True,
                            init=args["init"])}
    x2, y2 = zero1_data(n=256)
    cfg2 = dict(batch_size=64, epochs=2, learning_rate=3e-3, seed=0)
    out["flat"] = fit_mlp(mesh, x2, y2, cfg2, num_classes=4, zero1=True)
    out["hybrid"] = fit_mlp(create_multihost_mesh(num_slices=2, device="cpu"), x2, y2, cfg2,
                            num_classes=4, zero1=True)
    return out


@scenario
def zero1_state(rank, world, args):
    from har_tpu_torch.models.neural import MLP
    from har_tpu_torch.parallel import create_mesh, make_zero1_fit
    from har_tpu_torch.train.trainer import TrainerConfig, make_optimizer

    module = MLP(num_classes=4, hidden=(32,), dtype="float32", in_features=13)
    mesh = create_mesh(dp=world, device="cpu")
    opt = make_optimizer(TrainerConfig(), module.parameters(), 10)
    gens = {"dropout": torch.Generator().manual_seed(0),
            "augment": torch.Generator().manual_seed(1)}
    fit, init_opt_state = make_zero1_fit(module, opt, mesh, generators=gens)
    state = init_opt_state()
    x, y = zero1_data(n=64)
    idx = torch.from_numpy(np.arange(64).reshape(2, 32) % 64)
    losses = fit(torch.from_numpy(x), torch.from_numpy(y).long(), idx)
    return {"mu": tuple(state.optimizer.mu[0].shape), "dpad": state.dpad,
            "d": sum(p.numel() for p in module.parameters()),
            "count": state.optimizer.count, "losses": [float(v) for v in losses]}


@scenario
def zero1_features(rank, world, args):
    from har_tpu_torch.parallel import create_mesh

    x, y = zero1_data(n=384)
    keep = np.concatenate([np.where(y != 0)[0], np.where(y == 0)[0][:20]])
    x, y = x[keep], y[keep]
    cfg = dict(batch_size=64, epochs=12, learning_rate=3e-3, seed=0, class_weight="balanced",
               early_stop_patience=4, validation_fraction=0.15)
    mesh = create_mesh(dp=world, device="cpu")
    kw = dict(hidden=(32, 16), num_classes=4, augment=jitter)
    return {"base": fit_mlp(mesh, x, y, cfg, **kw),
            "zero1": fit_mlp(mesh, x, y, cfg, zero1=True, **kw)}


@scenario
def zero1_resume(rank, world, args):
    """A zero1 run that stops after its first snapshot (every rank raises
    at the second) resumes from it and ends where the unbroken run ends."""
    import torch.distributed as dist

    from har_tpu_torch.parallel import create_mesh

    x, y = zero1_data(n=256)
    mesh = create_mesh(dp=world, device="cpu")

    def cfg(ckpt_dir=None):
        return dict(batch_size=64, epochs=6, learning_rate=3e-3, seed=0,
                    checkpoint_dir=ckpt_dir, save_every_epochs=2 if ckpt_dir else 0)

    whole = fit_mlp(mesh, x, y, cfg(), num_classes=4, zero1=True)
    gather = dist.all_gather_object
    calls = []

    def crashing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated crash")
        return gather(*a, **kw)

    dist.all_gather_object = crashing
    try:
        crash = _raises(lambda: fit_mlp(mesh, x, y, cfg(args["dir"]), num_classes=4,
                                        zero1=True))
    finally:
        dist.all_gather_object = gather
    resumed = fit_mlp(mesh, x, y, cfg(args["dir"]), num_classes=4, zero1=True)
    return {"whole": whole, "resumed": resumed, "crash": crash}


@scenario
def zero1_guards(rank, world, args):
    from har_tpu_torch.parallel import create_mesh

    from har_tpu_torch.models.neural import MLP
    from har_tpu_torch.parallel import Zero1Trainer
    from har_tpu_torch.train.trainer import TrainerConfig

    x, y = zero1_data(n=64)
    return {
        "zero1_trainer_batch": _raises(lambda: Zero1Trainer(
            MLP(num_classes=4, hidden=(8,), in_features=13), TrainerConfig(batch_size=30, epochs=1),
            mesh=create_mesh(dp=world, device="cpu"), device="cpu").fit(x, y, num_classes=4)),
        "tp": _raises(lambda: fit_mlp(create_mesh(dp=world // 2, tp=2, device="cpu"), x, y,
                                      dict(batch_size=32, epochs=1), num_classes=4,
                                      zero1=True)),
        "batch": _raises(lambda: fit_mlp(create_mesh(dp=world, device="cpu"), x, y,
                                         dict(batch_size=30, epochs=1), num_classes=4,
                                         zero1=True)),
    }


# ---- tests/test_torch_ring_attention.py


def qkv(b=2, t=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
                 for _ in range(3))


def _block(x, rank, n):
    t = x.shape[1] // n
    return x[:, rank * t:(rank + 1) * t]


@scenario
def ring(rank, world, args):
    """The ring over every rank (tp plays the sp role, as in the JAX
    tests): plain and flash, extreme logits, gradients; then dp 2 × sp 2."""
    from har_tpu_torch.parallel import create_mesh, use_mesh
    from har_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention

    mesh = create_mesh(dp=1, tp=world, device="cpu")
    out = {}
    with use_mesh(mesh):
        q, k, v = (_block(z, rank, world) for z in qkv())
        out["ring"] = ring_attention(q, k, v, "tp")
        q, k, v = (_block(z * (30.0 if i == 0 else 1.0), rank, world)
                   for i, z in enumerate(qkv(t=16)))
        out["extreme"] = ring_attention(q, k, v, "tp")
        q, k, v = (_block(z, rank, world) for z in qkv(b=2, t=128, h=2, d=32))
        out["flash"] = ring_flash_attention(q, k, v, "tp")
        out["flash_ring"] = ring_attention(q, k, v, "tp")
        q, k, v = (_block(z, rank, world).requires_grad_() for z in qkv(b=1, t=64, h=2, d=32,
                                                                      seed=5))
        (ring_flash_attention(q, k, v, "tp") ** 2).sum().backward()
        out["grads"] = [z.grad for z in (q, k, v)]
    if world == 4:
        mesh = create_mesh(dp=2, tp=2, device="cpu")
        b, s = mesh.get_local_rank("dp"), mesh.get_local_rank("tp")
        q, k, v = (_block(z[2 * b:2 * b + 2], s, 2) for z in qkv(b=4, t=32))
        with use_mesh(mesh):
            out["dp_sp"] = ring_attention(q, k, v, "tp")
    return out


@scenario
def sp_transformer(rank, world, args):
    """Transformer1D(sp_axis="tp") over every rank: ring-flash and the plain
    ring on the same parameters, each against the unsharded module."""
    from har_tpu_torch.models.transformer import Transformer1D
    from har_tpu_torch.parallel import create_mesh, use_mesh

    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 128, 3)).astype(np.float32))
    kw = dict(num_classes=6, embed_dim=64, num_heads=2, num_layers=1, dtype="float32")
    single = Transformer1D(**kw)
    state = single.state_dict()
    out = {"single": single(x).detach()}
    mesh = create_mesh(dp=1, tp=world, device="cpu")
    with use_mesh(mesh):
        for flash in (True, False):
            model = Transformer1D(**kw, sp_axis="tp", use_flash=flash)
            model.load_state_dict(state)
            out["flash" if flash else "plain"] = model(_block(x, rank, world)).detach()
        # head dim 12, outside K2's envelope: the ring-flash route refuses
        # it as the unsharded route does; the plain ring takes it
        odd = dict(kw, embed_dim=24)
        out["odd_flash"] = _raises(
            lambda: Transformer1D(**odd, sp_axis="tp")(_block(x, rank, world)))
        out["odd_plain"] = Transformer1D(**odd, sp_axis="tp", use_flash=False)(
            _block(x, rank, world)).detach()
    return out


@scenario
def sweep_dp(rank, world, args):
    """``runner.sweep`` of LR with its CV on a dp mesh (the mesh reaches
    LR's CV sweep) against the same sweep without a mesh."""
    from har_tpu_torch import runner
    from har_tpu_torch.config import DataConfig, MeshConfig, RunConfig

    out = {}
    for tag, dp in (("mesh", world), ("plain", 1)):
        config = RunConfig(data=DataConfig(synthetic_rows=300), mesh=MeshConfig(dp=dp),
                           output_dir=os.path.join(args["out"], f"{tag}_{rank}"))
        rows = runner.sweep(config, models=["lr"], fractions=(0.7,), with_cv=True,
                            device="cpu")
        out[tag] = [{k: v for k, v in r.items() if not k.endswith("_time_s")} for r in rows]
    return out


@scenario
def tp_resume_early_stop(rank, world, args):
    """dp × tp 2: a checkpointed run stopped after its first snapshot (every
    rank raises at the second) resumes from it — DTensor parameters and
    moments reloaded — and ends on the unbroken run's parameters; early
    stopping scores the held-out rows through the tp forward."""
    import torch.distributed as dist

    from har_tpu_torch.parallel import create_mesh

    x, y = zero1_data(n=256)
    mesh = create_mesh(dp=world // 2, tp=2, device="cpu")

    def cfg(ckpt_dir=None):
        return dict(batch_size=64, epochs=6, learning_rate=3e-3, seed=0,
                    checkpoint_dir=ckpt_dir, save_every_epochs=2 if ckpt_dir else 0)

    whole = fit_mlp(mesh, x, y, cfg(), num_classes=4)
    gather = dist.all_gather_object
    calls = []

    def crashing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated crash")
        return gather(*a, **kw)

    dist.all_gather_object = crashing
    try:
        crash = _raises(lambda: fit_mlp(mesh, x, y, cfg(args["dir"]), num_classes=4))
    finally:
        dist.all_gather_object = gather
    resumed = fit_mlp(mesh, x, y, cfg(args["dir"]), num_classes=4)
    stop_cfg = dict(batch_size=64, epochs=8, learning_rate=3e-3, seed=0,
                    early_stop_patience=2, validation_fraction=0.2)
    return {"whole": whole, "resumed": resumed, "crash": crash,
            "early_tp": fit_mlp(mesh, x, y, stop_cfg, num_classes=4),
            "early_single": fit_mlp(None, x, y, stop_cfg, num_classes=4)}


# ---- tests/test_torch_expert_parallel.py and test_torch_pipeline_parallel.py


def moe_problem(e, n=32, h=8, ff=16, seed=0):
    """The port's ``init_moe_params`` (numpy draws from ``seed``) and
    (n, h) float32 tokens."""
    from har_tpu_torch.parallel.expert_parallel import init_moe_params

    params = init_moe_params(seed, e, h, ff)
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(n, h)).astype(np.float32))
    return params, x


def _summed_grads(params):
    """Every leaf's gradient summed over the ranks (the loss's gradient
    under the replicated-output convention)."""
    flat = {"router": params["router"], **{f"experts/{k}": v
                                           for k, v in params["experts"].items()}}
    out = {}
    for name, p in flat.items():
        g = p.grad.clone()
        torch.distributed.all_reduce(g)
        out[name] = g
    return out


def _with_grad(params):
    return {"router": params["router"].clone().requires_grad_(),
            "experts": {k: v.clone().requires_grad_() for k, v in params["experts"].items()}}


@scenario
def moe(rank, world, args):
    """The MoE layer over every rank (one expert a rank): dropless and
    tight capacity, gradients with and without the balance loss, and a
    stack of the wrong expert count."""
    from har_tpu_torch.parallel.expert_parallel import (
        dropless_capacity,
        expert_mesh,
        make_moe_fn,
    )

    mesh = expert_mesh(world, device="cpu")
    params, x = moe_problem(world)
    n_local = x.shape[0] // world
    f = make_moe_fn(mesh, capacity=dropless_capacity(n_local))
    y, aux = f(params, x)
    out = {"y": y, "aux": aux}
    _, x64 = moe_problem(world, n=64)
    out["tight"] = make_moe_fn(mesh, capacity=1)(params, x64)[0]
    for tag, lb in (("grads", 0.01), ("grads_plain", 0.0)):
        p = _with_grad(params)
        y, aux = f(p, x)
        ((y ** 2).mean() + lb * aux["load_balance_loss"]).backward()
        out[tag] = _summed_grads(p)
    if world == 2:
        four, _ = moe_problem(4)
        out["mismatch"] = _raises(lambda: f(four, x))
    return out


def stage_fn(params, a):
    return torch.relu(a @ params["w"] + params["b"])


def stage_params(rng, s, h):
    return {"w": torch.from_numpy(rng.normal(0, 0.3, (s, h, h)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(0, 0.1, (s, h)).astype(np.float32))}


@scenario
def pipeline(rank, world, args):
    """S = world pipelined stages: forward, gradients, a training run,
    and a stack of the wrong stage count."""
    from har_tpu_torch.parallel.pipeline_parallel import make_pipeline_fn, pipeline_mesh

    mesh = pipeline_mesh(world, device="cpu")
    f = make_pipeline_fn(stage_fn, mesh)
    rng = np.random.default_rng(0)
    stacked = stage_params(rng, world, 16)
    x = torch.from_numpy(rng.normal(size=(6, 8, 16)).astype(np.float32))
    out = {"y": f(stacked, x)}
    rng = np.random.default_rng(1)
    stacked = {k: v.requires_grad_() for k, v in stage_params(rng, world, 8).items()}
    x = torch.from_numpy(rng.normal(size=(5, 4, 8)).astype(np.float32))
    (f(stacked, x) ** 2).mean().backward()
    grads = {}
    for k, v in stacked.items():
        g = v.grad.clone()
        torch.distributed.all_reduce(g)
        grads[k] = g
    out["grads"] = grads
    # in-proj → pipeline → head, Adam; gradients summed over the ranks
    m, mb, d, h, c = 8, 16, 13, 16, 6
    rng = np.random.default_rng(2)
    params = {"in": torch.from_numpy(rng.normal(0, 0.3, (d, h)).astype(np.float32)),
              "stages": stage_params(rng, world, h),
              "head": torch.from_numpy(rng.normal(0, 0.3, (h, c)).astype(np.float32))}
    leaves = [params["in"], *params["stages"].values(), params["head"]]
    for leaf in leaves:
        leaf.requires_grad_()
    xs = rng.normal(size=(m, mb, d)).astype(np.float32)
    ys = torch.from_numpy((xs @ rng.normal(size=(d, c))).argmax(-1))
    xs = torch.from_numpy(xs)
    opt = torch.optim.Adam(leaves, lr=3e-3)
    losses = []
    for _ in range(60):
        opt.zero_grad()
        a = f(params["stages"], xs @ params["in"])
        loss = torch.nn.functional.cross_entropy((a @ params["head"]).reshape(-1, c),
                                                 ys.reshape(-1))
        loss.backward()
        for leaf in leaves:
            torch.distributed.all_reduce(leaf.grad)
            if leaf is params["head"]:
                # after the pipeline every rank computes the whole head
                leaf.grad /= world
        opt.step()
        losses.append(float(loss))
    out["losses"] = losses
    if world == 2:
        four = stage_params(np.random.default_rng(3), 4, 8)
        out["mismatch"] = _raises(lambda: f(four, torch.zeros((3, 4, 8))))
    return out


def main(argv) -> None:
    names, rank, world, store, out, argfile = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    args = torch.load(argfile, weights_only=False)
    results = {}
    try:
        for name in names.split(","):
            results[name] = SCENARIOS[name](rank, world, args.get(name, {}))
            dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(results, out)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
