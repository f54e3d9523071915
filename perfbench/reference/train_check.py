"""A whole fit followed by the reference, and the numbers that judge the
program's fit against it: its first three steps closely, and where its
parameters ended.

The reference works out again, from the run's inputs alone, what the
program's fit does (``TrainerConfig``'s documented semantics):

- the batch schedule: each epoch a permutation of the rows from
  ``numpy.random.default_rng(seed)``, the last partial batch wrapped
  round to full size;
- each step's loss: the mean cross-entropy over the batch (every row
  weighs 1), its gradient that of the mean;
- AdamW as optax computes it (b1 0.9, b2 0.999, eps 1e-8, decoupled
  weight decay), under a warmup-cosine schedule read at the count before
  the step (linear from 0 to the peak over ``int(warmup_fraction ·
  steps)``, at least 1, then a cosine to 0 by the last step).

The numbers, each a worst case:

- ``init_gap``: the largest difference between the parameters the
  program started from and the weights the benchmark handed it (0);
- ``rows_short``: rows of steps 1-3's batches that the program's forward
  did not see (0);
- ``logits_gap``: step 1's logits, ‖program − reference‖ / ‖reference‖
  over the batch (the forward before any update);
- ``loss_gap``: step 1's |program − reference| / reference loss.  Steps 2
  and 3 are not compared: their first update moves each weight by about
  the learning rate in the direction of its gradient's sign (Adam's
  first steps), so entries whose gradient is round-off flip on either
  side and the later losses differ by that, seed by seed (their gaps
  are in the calibration's diagnostics);
- ``grad_gap``: over the leaves, the gap between the norm of the
  program's first gradient, worked out from its optimizer's state after
  one step (mu / (1 − b1)), and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same for the parameters' change over steps 1-3,
  read before step 4 runs, over the entries that move by more than
  round-off: a leaf whose reference gradient's norm is under a
  thousandth of the median leaf's is left out, and so is every entry
  whose reference gradient is under a thousandth of its leaf's median
  entry (the key's third of a fused qkv bias, whose gradient is nought
  under softmax, moves under Adam by round-off alone, on both sides);
- ``final_gap``: the same for the parameters' change over the whole fit,
  every step of the warmup-cosine schedule, read when the fit returns.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8
STEPS = 3


def schedule(n: int, batch: int, seed: int, epochs: int) -> list[np.ndarray]:
    """The rows of every batch of ``epochs`` epochs: each epoch a
    permutation from one ``default_rng(seed)``, its last partial batch
    wrapped round to full size."""
    rng = np.random.default_rng(seed)
    n_batches = max(1, -(-n // batch))
    rows = []
    for _ in range(epochs):
        padded = np.resize(rng.permutation(n), n_batches * batch)
        rows += [padded[i * batch:(i + 1) * batch] for i in range(n_batches)]
    return rows


def batch_rows(n: int, batch: int, seed: int, steps: int) -> list[np.ndarray]:
    """The rows of the first ``steps`` batches."""
    n_batches = max(1, -(-n // batch))
    return schedule(n, batch, seed, -(-steps // n_batches))[:steps]


def learning_rate(count: int, peak: float, total_steps: int, warmup_fraction: float) -> float:
    warmup = max(1, int(warmup_fraction * total_steps))
    decay = max(2, total_steps)
    if count < warmup:
        return peak * count / warmup
    c = min(count - warmup, decay - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / (decay - warmup)))


def follow(model, cfg: dict, traffic: dict, x: torch.Tensor, y: torch.Tensor,
           weights: dict[str, torch.Tensor], seed: int, mm, block_rows: int = 256) -> dict:
    """The reference's whole fit from ``weights`` on (x, y) with the
    program's seed ``seed``: {"loss": [3], "logits": [step 1's], "grad":
    {leaf: g₁}, "update": {leaf: p₃ − p₀}, "final": {leaf: p_end − p₀}}.
    Each batch runs in blocks of ``block_rows`` rows, their gradients
    summed."""
    batch = traffic["batch_size"]
    total = max(1, -(-len(x) // batch)) * traffic["epochs"]
    if total < STEPS:
        raise ValueError(f"a fit of {total} steps has fewer than {STEPS}")
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad, first_logits, early = [], None, [], None
    for count, rows in enumerate(schedule(len(x), batch, seed, traffic["epochs"])):
        rows = torch.as_tensor(rows, device=x.device)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        loss_sum = 0.0
        for lo in range(0, batch, block_rows):
            r = rows[lo:lo + block_rows]
            logits = model.forward(params, x[r], cfg, mm=mm)
            if count == 0:
                first_logits.append(logits.detach())
            loss = F.cross_entropy(logits, y[r].long(), reduction="sum")
            for k, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
                grads[k] += g
            if count < STEPS:
                loss_sum += float(loss.detach())
        if count < STEPS:
            losses.append(loss_sum / batch)
        lr = learning_rate(count, traffic["learning_rate"], total, traffic["warmup_fraction"])
        bc1, bc2 = 1 - B1 ** (count + 1), 1 - B2 ** (count + 1)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] / batch
                mu[k] = (1 - B1) * g + B1 * mu[k]
                nu[k] = (1 - B2) * g * g + B2 * nu[k]
                update = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
                p -= lr * (update + traffic["weight_decay"] * p)
        if count == 0:
            first_grad = {k: g / batch for k, g in grads.items()}
        if count == STEPS - 1:
            early = {k: (params[k].detach() - start[k]) for k in params}
    return {"loss": losses, "grad": first_grad, "logits": [torch.cat(first_logits)],
            "update": early, "final": {k: (params[k].detach() - start[k]) for k in params}}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _worst_leaf_gap(program: dict, reference: dict, keep: dict | None = None) -> float:
    """max over leaves of |‖program‖ − ‖reference‖| / max(‖reference‖,
    median leaf's ‖reference‖), over the entries ``keep`` (leaf → bool
    mask) leaves in, every entry of every leaf without it."""
    if keep is not None:
        reference = {k: v[keep[k]] for k, v in reference.items() if k in keep}
        program = {k: program[k].to(keep[k].device)[keep[k]] for k in reference}
    ref_norms = {k: _norm(v) for k, v in reference.items()}
    median = float(np.median(list(ref_norms.values())))
    return max(abs(_norm(program[k].to(reference[k].device)) - ref) / max(ref, median)
               for k, ref in ref_norms.items())


def moving_entries(grad: dict) -> dict:
    """Leaf → mask of the entries that move by more than round-off: the
    leaf's gradient norm at least a thousandth of the median leaf's, the
    entry's magnitude at least a thousandth of its leaf's median entry."""
    norms = {k: _norm(g) for k, g in grad.items()}
    median = float(np.median(list(norms.values())))
    return {k: g.abs() >= 1e-3 * g.abs().median() for k, g in grad.items()
            if norms[k] >= 1e-3 * median}


def leaf_gaps(program: dict, reference: dict, keep: dict | None = None) -> dict[str, float]:
    """Every leaf's gap of norms, as ``_worst_leaf_gap`` takes its worst."""
    if keep is not None:
        reference = {k: v[keep[k]] for k, v in reference.items() if k in keep}
        program = {k: program[k].to(keep[k].device)[keep[k]] for k in reference}
    ref_norms = {k: _norm(v) for k, v in reference.items()}
    median = float(np.median(list(ref_norms.values())))
    return {k: abs(_norm(program[k].to(reference[k].device)) - ref) / max(ref, median)
            for k, ref in ref_norms.items()}


def diagnostics(observed: dict, followed: dict) -> dict:
    """What the calibration looks at beside the numbers: each step's loss
    gap and the three worst leaves of each leaf gap."""
    out = {"loss_gaps": [abs(p - r) / abs(r) for p, r in zip(observed["loss"], followed["loss"])]}
    moving = moving_entries(followed["grad"])
    for name, keep in (("grad", None), ("update", moving), ("final", moving)):
        gaps = leaf_gaps(observed[name], followed[name], keep)
        out[f"{name}_median_leaf"] = float(np.median(list(gaps.values())))
        out[f"{name}_worst"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    return out


def readings(observed: dict, followed: dict, weights: dict) -> dict[str, float]:
    """The check's numbers; ``observed`` holds the program's "start"
    parameters, per-step "logits" and "loss", first "grad", "update" and
    "final", as ``follow`` returns the reference's (its "logits" step
    1's)."""
    init_gap = max(float((observed["start"][k].to(v.device) - v).abs().max())
                   for k, v in weights.items())
    batch = len(followed["logits"][0])
    rows_short = sum(batch - len(lg) for lg in observed["logits"])
    got = observed["logits"][0]
    want = followed["logits"][0][:len(got)]
    moving = moving_entries(followed["grad"])
    logits_gap = _norm(got.to(want.device) - want) / _norm(want)
    return {
        "init_gap": init_gap,
        "rows_short": float(rows_short),
        "logits_gap": logits_gap,
        "loss_gap": abs(observed["loss"][0] - followed["loss"][0]) / abs(followed["loss"][0]),
        "grad_gap": _worst_leaf_gap(observed["grad"], followed["grad"]),
        "update_gap": _worst_leaf_gap(observed["update"], followed["update"], keep=moving),
        "final_gap": _worst_leaf_gap(observed["final"], followed["final"], keep=moving),
    }
