"""Augmentation of raw (B, T, 3) tri-axial accelerometer windows.

Port of ``har_tpu/data/augment.py``: jitter, per-axis scaling, a random
3-D rotation (Rodrigues' formula) and a time mask, each per window with
independent randomness, applied inside the training step.  The JAX package
draws from ``jax.random`` keys; here :meth:`WindowAugment.draw` takes the
same draws (the same distributions and shapes) from an explicit
``torch.Generator``, and :meth:`WindowAugment.apply` is a pure function of
``(x, draws)``, so the tests feed it the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def rotations(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(n, 3, 3) rotation matrices from (n, 3) axes (normalized here) and
    (n,) angles, by Rodrigues' formula."""
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-8)
    c, s = torch.cos(angle), torch.sin(angle)
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    zero = torch.zeros_like(x)
    k_cross = torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    outer = axis[:, :, None] * axis[:, None, :]
    return (
        c[:, None, None] * eye
        + s[:, None, None] * k_cross
        + (1 - c)[:, None, None] * outer
    )


@dataclasses.dataclass(frozen=True)
class WindowAugment:
    """Composable augmentation policy; call as ``aug(generator, x)`` per
    batch.  Zero-valued knobs disable their transform, so
    ``WindowAugment(0, 0, 0, 0)`` is the identity."""

    jitter_std: float = 0.03
    scale_std: float = 0.05
    max_rotation: float = 0.2  # radians
    time_mask_fraction: float = 0.1

    def _span(self, t: int) -> int:
        return max(1, int(round(t * self.time_mask_fraction)))

    @staticmethod
    def _check(x: torch.Tensor) -> None:
        if x.dim() != 3:
            raise ValueError(
                "window augmentation expects (batch, time, channels) "
                f"windows, got shape {tuple(x.shape)} — tabular feature "
                "models (e.g. mlp) cannot train with --augment"
            )

    def draw(self, generator: torch.Generator, x: torch.Tensor) -> dict:
        """The random numbers one call needs, on ``x``'s device: ``jitter``
        (B, T, C) and ``scale`` (B, 1, C) standard normals, rotation
        ``axis`` (B, 3) standard normals and ``angle`` (B,) uniform in
        [0, max_rotation), and the mask's ``start`` (B, 1) uniform over
        [0, T − span]; a disabled transform draws nothing."""
        self._check(x)
        b, t, c = x.shape
        kw = dict(generator=generator, device=x.device)
        draws = {}
        if self.jitter_std > 0:
            draws["jitter"] = torch.randn(x.shape, dtype=x.dtype, **kw)
        if self.scale_std > 0:
            draws["scale"] = torch.randn((b, 1, c), dtype=x.dtype, **kw)
        if self.max_rotation > 0 and c == 3:
            draws["axis"] = torch.randn((b, 3), dtype=x.dtype, **kw)
            draws["angle"] = torch.rand((b,), dtype=x.dtype, **kw) * self.max_rotation
        if self.time_mask_fraction > 0:
            draws["start"] = torch.randint(0, t - self._span(t) + 1, (b, 1), **kw)
        return draws

    def apply(self, x: torch.Tensor, draws: dict) -> torch.Tensor:
        """The augmented windows for these draws (a pure function)."""
        self._check(x)
        b, t, c = x.shape
        if self.jitter_std > 0:
            x = x + self.jitter_std * draws["jitter"]
        if self.scale_std > 0:
            x = x * (1.0 + self.scale_std * draws["scale"])
        if self.max_rotation > 0 and c == 3:
            rot = rotations(draws["axis"], draws["angle"])
            x = torch.einsum("btc,bdc->btd", x, rot)
        if self.time_mask_fraction > 0:
            start = draws["start"]
            pos = torch.arange(t, device=x.device)[None, :]
            mask = (pos >= start) & (pos < start + self._span(t))
            x = torch.where(mask[:, :, None], torch.zeros_like(x), x)
        return x

    def __call__(self, generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x, self.draw(generator, x))


def build_augment(name: str | None) -> Callable | None:
    """Config-string → augmentation policy (None / "none" → no-op)."""
    if name is None or name == "none":
        return None
    if name == "raw_windows":
        return WindowAugment()
    raise ValueError(f"unknown augmentation policy {name!r}")
