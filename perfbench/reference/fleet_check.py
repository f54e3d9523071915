"""The fleet's answers judged one by one.

For each checked session the reference rebuilds, from the seed's pool
and the session's offset, the window that ends at each answered
``t_index`` (the session's stream is the pool read cyclically from its
offset), runs the float32 forward over it, takes the softmax, and
smooths along the session's answers in order as the configuration's
smoothing states (``ema``: e₁ = p₁, eₖ = α·pₖ + (1 − α)·eₖ₋₁; ``none``:
the window's own probabilities).  The numbers:

- ``prob_gap``: the largest difference between an answered probability
  and the reference's;
- ``order_faults``: answers whose ``t_index`` is not a window end
  (window + k·hop) or does not follow the session's previous answer.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 512


def windows_at(pool: torch.Tensor, offset: int, t_index: np.ndarray, window: int) -> torch.Tensor:
    """(n, window, C) windows of the stream that reads ``pool`` cyclically
    from pool window ``offset``, each ending at its ``t_index``."""
    p, t, c = pool.shape
    flat = pool.reshape(p * t, c)
    start = torch.as_tensor(t_index - window, device=pool.device)[:, None]
    idx = (offset * t + start + torch.arange(window, device=pool.device)[None, :]) % (p * t)
    return flat[idx]


@torch.no_grad()
def reference_answers(model, cfg: dict, traffic: dict, pool: torch.Tensor, offsets,
                      weights: dict, answers: dict, mm) -> dict:
    """Session → [(t_index, probabilities)] as the reference answers the
    same windows, smoothed along each session's answers."""
    window = cfg["window"]
    keys, blocks = [], []
    for sid, got in answers.items():
        t_index = np.asarray([t for t, _ in got], np.int64)
        if len(t_index):
            keys.append((sid, t_index))
            blocks.append(windows_at(pool, int(offsets[sid]), t_index, window))
    if not blocks:
        return {sid: [] for sid in answers}
    x = torch.cat(blocks)
    probs = torch.cat([torch.softmax(model.forward(weights, x[i:i + BLOCK_ROWS], cfg, mm=mm), -1)
                       for i in range(0, len(x), BLOCK_ROWS)]).double().cpu().numpy()
    alpha = traffic["ema_alpha"]
    out, row = {sid: [] for sid in answers}, 0
    for sid, t_index in keys:
        smoothed = None
        for t in t_index:
            p = probs[row]
            row += 1
            if traffic["smoothing"] == "ema":
                smoothed = p if smoothed is None else alpha * p + (1 - alpha) * smoothed
            elif traffic["smoothing"] == "none":
                smoothed = p
            else:
                raise ValueError(f"no reference for smoothing {traffic['smoothing']!r}")
            out[sid].append((int(t), smoothed))
    return out


def order_faults(answers: dict, window: int, hop: int) -> int:
    faults = 0
    for got in answers.values():
        last = None
        for t, _ in got:
            if t < window or (t - window) % hop or (last is not None and t <= last):
                faults += 1
            last = t
    return faults


def readings(model, cfg: dict, traffic: dict, pool: torch.Tensor, offsets, weights: dict,
             answers: dict, mm) -> dict[str, float]:
    want = reference_answers(model, cfg, traffic, pool, offsets, weights, answers, mm)
    gap = 0.0
    for sid, got in answers.items():
        for (_, p), (_, r) in zip(got, want[sid]):
            gap = max(gap, float(np.abs(np.asarray(p, np.float64) - r).max()))
    return {"prob_gap": gap,
            "order_faults": float(order_faults(answers, cfg["window"], traffic["hop"]))}
