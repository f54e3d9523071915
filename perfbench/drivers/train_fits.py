"""Back-to-back fits of a raw-window classifier: the general generator of
every traffic mix of kind ``train_fits``.

Mix keys: ``rows`` (seeded windows of the configuration's T × C, uniform
labels, ``class_signal`` as ``harness.inputs.raw_windows`` takes it),
``batch_size``, ``epochs``, ``learning_rate``, ``weight_decay``,
``warmup_fraction`` (``TrainerConfig``'s fields).

Set-up: the windows, labels and initial weights are drawn on the card
from the seed; one ``Trainer`` (the staged fit and its step,
``parallel.data_parallel.make_module_step``, its own optimizer) is built
over the configuration's module.  Its first fit, from those weights
(``init_params``), builds K2 (the nvcc library stays in the checkout),
warms every shape and fills the warm-refit cache.  Its second fit takes
the window's branch (the cache hit, asserted) and is watched through
module hooks and a pass-through of ``AdamW.step``: the parameters it
started from, its logits in steps 1-3, its optimizer's state after step
1, its parameters before step 4 and when it returns.

Window: ``Trainer.fit`` on the same arrays from the same weights, back
to back, as the watched fit ran, so the warm-refit cache (the staged
copies and schedule) is hit, as in a sweep; it ends at the first fit
boundary after ``--seconds``.  ``train_windows_per_s`` is windows ×
epochs of the fits over the window's wall time.  With ``--trace 1`` the
window's second fit runs under the profiler.

After the window: the peak memory is read, the program freed, and the
reference (``reference/train_check.py``) follows the whole fit from the
seed's inputs in float32.
"""

from __future__ import annotations

import gc
import time

import torch
import torch.nn.functional as F

from harness import inputs
from harness.result import Observed, RunOutput, limited
from harness.trace import Tracer, span
from reference import train_check
from reference.precision import MATMULS, exact_tf32_off


def build_module(cfg: dict, reference):
    """The program's module for ``cfg`` (on the host, as the program
    builds it), checked against the reference's names and shapes."""
    from har_tpu_torch.models.neural import build_model

    prog = cfg["program"]
    module = build_model(prog["model"], num_classes=cfg["num_classes"],
                         in_features=cfg["channels"], **prog["kwargs"])
    have = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    want = reference.state_shapes(cfg)
    if have != want:
        raise RuntimeError(f"the program's parameters {have} are not the reference's {want}")
    return module


def trainer_config(traffic: dict, seed: int):
    from har_tpu_torch.train.trainer import TrainerConfig

    return TrainerConfig(batch_size=traffic["batch_size"], epochs=traffic["epochs"],
                         learning_rate=traffic["learning_rate"],
                         weight_decay=traffic["weight_decay"],
                         warmup_fraction=traffic["warmup_fraction"], seed=seed)


def watched_fit(trainer, x, y, num_classes: int, init: dict) -> dict:
    """Run one warm refit, keeping what it produced: "start" (the
    parameters step 1 began from), "logits" of steps 1-3, "grad" (the
    first gradient, from the optimizer's state after one step), "update"
    (the parameters' change, read when step 4 begins) and "final" (the
    change over the whole fit)."""
    from unittest import mock

    from har_tpu_torch.train.trainer import AdamW

    module = trainer.module
    names = {id(p): k for k, p in module.named_parameters()}
    seen = {"logits": []}
    stepped = []
    calls = 0
    real_step = AdamW.step

    def step(opt):
        # passes through; only notes which optimizer the fit stepped
        if not stepped:
            stepped.append(opt)
        return real_step(opt)

    def before(mod, args):
        nonlocal calls
        if not mod.training:
            return
        calls += 1
        if calls == 1:
            seen["start"] = {k: v.detach().cpu().clone() for k, v in mod.state_dict().items()}
        elif calls == 2 and stepped:
            # the state after one step; a program whose optimizer did not
            # step is judged by the state it kept
            opt = stepped[0]
            seen["grad"] = {names[id(p)]: m.detach().float().cpu() / (1 - train_check.B1)
                            for p, m in zip(opt.params, opt.mu)}
        elif calls == train_check.STEPS + 1:
            seen["update"] = {k: v.detach().cpu() - seen["start"][k]
                              for k, v in mod.state_dict().items()}

    def after(mod, args, out):
        if mod.training and calls <= train_check.STEPS:
            seen["logits"].append(out.detach().float().cpu())

    hooks = [module.register_forward_pre_hook(before), module.register_forward_hook(after)]
    try:
        with mock.patch.object(AdamW, "step", step):
            fitted = trainer.fit(x, y, num_classes=num_classes, init_params=init)
    finally:
        for h in hooks:
            h.remove()
    if not fitted.history.get("warm_refit"):
        raise RuntimeError("the watched fit missed the warm-refit cache: not the window's branch")
    missing = {"start", "grad", "update"} - set(seen)
    if missing or len(seen["logits"]) != train_check.STEPS:
        raise RuntimeError(f"the watched fit ran fewer than {train_check.STEPS + 1} steps")
    seen["final"] = {k: v.detach().cpu() - seen["start"][k]
                     for k, v in fitted.module.state_dict().items()}
    return seen


def prepare(ctx) -> dict:
    """Set-up up to and through the watched warm refit."""
    from har_tpu_torch.train.trainer import Trainer

    ref, device, traffic = ctx.reference, ctx.device, ctx.cell.traffic
    cfg = ctx.cell.config
    _, _, _, _, t, c, k = ref.dims(cfg)
    n = traffic["rows"]
    x_dev, y_dev = inputs.raw_windows(ctx.seed, n, t, c, k, device,
                                       traffic.get("class_signal", 0.0))
    x, y = x_dev.cpu().numpy(), y_dev.cpu().numpy()
    weights = inputs.initial_weights(ref.state_shapes(cfg), ctx.seed, device)
    init = {name: v.cpu() for name, v in weights.items()}
    del x_dev, y_dev, weights
    ctx.note("inputs and weights drawn")

    prog_seed = inputs.sub_seed(ctx.seed, "trainer")
    trainer = Trainer(build_module(cfg, ref), trainer_config(traffic, prog_seed), device=device)
    ctx.note("trainer built")
    trainer.fit(x, y, num_classes=k, init_params=init)
    ctx.note("first fit run")
    seen = watched_fit(trainer, x, y, k, init)
    ctx.note("warm refit watched")
    return dict(x=x, y=y, init=init, trainer=trainer, seen=seen, prog_seed=prog_seed,
                n=n, num_classes=k)


def follow_reference(ctx, prog_seed: int, precision: str = "float32") -> tuple[dict, dict]:
    """The reference's fit from the seed's inputs, and the initial
    weights it drew."""
    ref, device, cfg = ctx.reference, ctx.device, ctx.cell.config
    _, _, _, _, t, c, k = ref.dims(cfg)
    exact_tf32_off()
    x, y = inputs.raw_windows(ctx.seed, ctx.cell.traffic["rows"], t, c, k, device,
                              ctx.cell.traffic.get("class_signal", 0.0))
    weights = inputs.initial_weights(ref.state_shapes(cfg), ctx.seed, device)
    return train_check.follow(ref, cfg, ctx.cell.traffic, x, y, weights, prog_seed,
                              MATMULS[precision]), weights


def judge(ctx, seen: dict, y, prog_seed: int, diagnose: bool = False) -> dict:
    """The check's numbers for the program's watched fit ``seen`` (with
    ``diagnose``, the calibration's diagnostics besides)."""
    followed, weights = follow_reference(ctx, prog_seed)
    rows = train_check.batch_rows(len(y), ctx.cell.traffic["batch_size"], prog_seed,
                                  train_check.STEPS)
    y_host = torch.as_tensor(y).long()
    # the loss of the rows the step's forward saw: a step that saw fewer
    # than its batch is judged by the loss it computed
    seen["loss"] = [float(F.cross_entropy(lg, y_host[r[:len(lg)]]))
                    for lg, r in zip(seen["logits"], rows)]
    numbers = train_check.readings(seen, followed, weights)
    if diagnose:
        numbers["diagnostics"] = train_check.diagnostics(seen, followed)
    return numbers


def free(device) -> None:
    """Release what the program left on the card before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> RunOutput:
    device, traffic = ctx.device, ctx.cell.traffic
    s = prepare(ctx)
    trainer, x, y, init, k = s["trainer"], s["x"], s["y"], s["init"], s["num_classes"]

    fits, traced_fit, tracer = 0, 1, None
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    while True:
        if ctx.trace and fits == traced_fit:
            with Tracer(device) as tracer, span("fit"):
                trainer.fit(x, y, num_classes=k, init_params=init)
        else:
            with span("fit"):
                trainer.fit(x, y, num_classes=k, init_params=init)
        fits += 1
        if time.perf_counter() - t0 >= ctx.seconds and (not ctx.trace or fits > traced_fit):
            break
    window_s = time.perf_counter() - t0
    trained = fits * s["n"] * traffic["epochs"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del trainer, s["trainer"]
    free(device)
    numbers = judge(ctx, s["seen"], y, s["prog_seed"])
    checks = limited(ctx, numbers)
    return RunOutput(
        attempted=trained, failed=0,
        e2e={"setup_s": setup_s, "train_windows_per_s": trained / window_s},
        checks=checks, memory_peak_bytes=peak,
        observed=Observed(trace=tracer.summary if tracer else None,
                          counters={"windows_in_trace": s["n"] * traffic["epochs"]},
                          cell=ctx.cell, reference=ctx.reference),
    )


def half_batch_fault():
    """Plant step 3's fault in the program: each step trains on the first
    half of its batch, the mean taken over that half."""
    from unittest import mock

    from har_tpu_torch.train import trainer as trainer_module

    real = trainer_module.make_module_step

    def make_module_step(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda xb, yb, wb: step(xb[: len(xb) // 2], yb[: len(yb) // 2],
                                       wb[: len(wb) // 2])

    return mock.patch.object(trainer_module, "make_module_step", make_module_step)


def unchanged_state_fault():
    """Plant step 3's fault in the program: the optimizer's step leaves
    the parameters as they were."""
    from unittest import mock

    from har_tpu_torch.train.trainer import AdamW

    return mock.patch.object(AdamW, "step", lambda self: None)


def stale_moments_fault():
    """Plant a warm refit's fault in the program: each fit's optimizer
    starts from the moments and count that the fit before it ended with."""
    from unittest import mock

    from har_tpu_torch.train import trainer as trainer_module

    real = trainer_module.make_optimizer
    last = []

    def make_optimizer(cfg, params, total_steps):
        optimizer = real(cfg, params, total_steps)
        if last:
            optimizer.load_state_dict(last[0].state_dict())
        last[:] = [optimizer]
        return optimizer

    return mock.patch.object(trainer_module, "make_optimizer", make_optimizer)


FAULTS = {"half_batch": half_batch_fault, "unchanged_state": unchanged_state_fault,
          "stale_moments": stale_moments_fault}


def calibrate(ctx, kind: str) -> dict[str, float]:
    """One seed's readings for setting limits: ``kind`` "program" (the
    program's watched warm refit), "control" (the reference in fp8 in the
    program's place), or a fault of ``FAULTS`` planted in the program."""
    if kind == "control":
        prog_seed = inputs.sub_seed(ctx.seed, "trainer")
        followed, weights = follow_reference(ctx, prog_seed)
        control, _ = follow_reference(ctx, prog_seed, "fp8")
        control["start"] = weights
        return dict(train_check.readings(control, followed, weights),
                    diagnostics=train_check.diagnostics(control, followed))
    if kind in FAULTS:
        with FAULTS[kind]():
            s = prepare(ctx)
    else:
        s = prepare(ctx)
    del s["trainer"]
    free(ctx.device)
    return judge(ctx, s["seen"], s["y"], s["prog_seed"], diagnose=True)
