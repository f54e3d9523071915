"""Input-drift monitoring for deployed streaming inference.

Port of ``har_tpu/monitoring.py``, numpy only and copied, so its reports
are bit-equal to the JAX package's for the same samples.

The reference's stated use case is continuous monitoring of elderly
people from a worn accelerometer (paper §1; the pipeline itself is a
one-shot batch script, `Main/main.py`).  A deployed recognizer fails
silently when its INPUT distribution moves — a re-mounted sensor, a
changed orientation, gain drift, a different wearer — while the model
keeps emitting confident labels.  This module watches for exactly that:

  ``DriftMonitor`` — per-channel exponentially-weighted running
    mean/std over the sample stream, compared against the training
    distribution (taken from a fitted scaler, training windows, or
    explicit stats).  ``update(samples)`` returns a ``DriftReport``
    with per-channel z-scores (location) and log-scale ratios (spread),
    plus a debounced ``drifting`` verdict.

  ``StreamingClassifier(..., monitor=...)`` feeds it automatically:
    every ``StreamEvent`` then carries ``drift=True`` while the stream
    is out of distribution, so a timeline consumer can grey out
    decisions it should not trust.

Host-side numpy by design: the statistics are O(channels) EWMAs over
samples already in host memory for the ring buffer — putting them on
the GPU would cost a launch and a copy per chunk to accelerate nine
multiply-adds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One update()'s verdict."""

    drifting: bool  # debounced out-of-distribution verdict
    location_z: np.ndarray  # (C,) |ewma_mean - ref_mean| / ref_std
    scale_log_ratio: np.ndarray  # (C,) log(ewma_std / ref_std)
    n_samples: int  # total samples absorbed so far
    onset: int | None = None  # sample index (n_samples at the flip) of
    #   the CURRENT drift episode's onset; None while not drifting.  A
    #   stable episode id: every report of one uninterrupted episode
    #   carries the same onset, so an alert consumer (the adapt
    #   trigger) can de-duplicate per episode — and a reset() re-arm
    #   after a model swap starts a fresh episode by construction.
    generation: int = 0  # reset() count of the emitting monitor: onset
    #   indices restart at every reset, so (generation, onset) — not
    #   onset alone — is the globally unambiguous episode id (a post-
    #   reset episode can land on a numerically equal onset).

    @property
    def worst_channel(self) -> int:
        return int(
            np.argmax(
                np.maximum(self.location_z, np.abs(self.scale_log_ratio))
            )
        )


class DriftMonitor:
    """EWMA location/scale drift detector against training statistics.

    Parameters
    ----------
    ref_mean, ref_std:
        Per-channel training-distribution statistics, shape ``(C,)``.
    halflife:
        EWMA halflife in samples (default 400 = 20 s at 20 Hz): the
    	window over which old evidence decays to half weight.
    z_threshold:
        Location shift (in training standard deviations) or scale
        log-ratio magnitude (``|log(std_new/std_ref)|``; 0.69 = 2x)
        that counts as drifted.
    patience:
        Consecutive over-threshold updates before ``drifting`` flips
        (debounce: one noisy chunk is not a re-mounted sensor).
    """

    def __init__(
        self,
        ref_mean,
        ref_std,
        *,
        halflife: float = 400.0,
        z_threshold: float = 3.0,
        scale_threshold: float = 0.69,
        patience: int = 3,
    ):
        self.ref_mean = np.asarray(ref_mean, np.float64).reshape(-1)
        self.ref_std = np.asarray(ref_std, np.float64).reshape(-1)
        if self.ref_mean.shape != self.ref_std.shape:
            raise ValueError("ref_mean and ref_std must have equal shape")
        self.ref_std = np.where(self.ref_std > 0, self.ref_std, 1.0)
        if halflife <= 0:
            raise ValueError("halflife must be positive")
        self.halflife = float(halflife)
        self.z_threshold = float(z_threshold)
        self.scale_threshold = float(scale_threshold)
        self.patience = int(patience)
        self.reset()

    @classmethod
    def from_model(cls, model, **kwargs) -> "DriftMonitor":
        """Training stats from a fitted model's scaler.

        Raw-window scalers carry (window, C) statistics — collapsed to
        per-channel by averaging the location and RMS-averaging the
        spread over the window axis.
        """
        scaler = getattr(model, "scaler", None)
        if scaler is None:
            raise ValueError(
                "model has no fitted scaler; use from_windows or pass "
                "ref_mean/ref_std explicitly"
            )
        mean = np.asarray(scaler.mean, np.float64)
        std = np.asarray(scaler.std, np.float64)
        if mean.ndim == 2:  # (window, C) raw-window statistics
            mean = mean.mean(axis=0)
            std = np.sqrt((std**2).mean(axis=0))
        return cls(mean, std, **kwargs)

    @classmethod
    def from_windows(cls, windows, **kwargs) -> "DriftMonitor":
        """Training stats from raw ``(n, T, C)`` (or ``(n, C)``) data."""
        w = np.asarray(windows, np.float64)
        flat = w.reshape(-1, w.shape[-1])
        return cls(flat.mean(axis=0), flat.std(axis=0), **kwargs)

    def reset(self) -> None:
        """Re-arm: back to the reference state, debounce cleared, any
        current drift episode ended (the next episode gets a fresh
        ``onset``).  Called after a stream restart or a model swap —
        the new model was trained on the drifted data, so the old
        episode's evidence must not re-alert against it."""
        self._mean = self.ref_mean.copy()
        self._var = self.ref_std.copy() ** 2
        self._n = 0
        self._over = 0
        self._drifting = False
        self._onset: int | None = None
        # 0 on construction, +1 per re-arm: reports stamp it so episode
        # ids (generation, onset) never collide across resets
        self._generation = getattr(self, "_generation", -1) + 1

    def state(self) -> dict:
        """Full JSON-serializable state — knobs, reference stats, EWMA
        state and the live episode (onset/generation) — so a recovered
        stream's drift verdicts continue the pre-crash episode instead
        of restarting cold.  Serialization lives HERE, next to the
        fields it depends on: a representation change must update both
        sides in one place (the fleet journal snapshots call this)."""
        return {
            "ref_mean": [float(v) for v in self.ref_mean],
            "ref_std": [float(v) for v in self.ref_std],
            "halflife": self.halflife,
            "z_threshold": self.z_threshold,
            "scale_threshold": self.scale_threshold,
            "patience": self.patience,
            "mean": [float(v) for v in self._mean],
            "var": [float(v) for v in self._var],
            "n": self._n,
            "over": self._over,
            "drifting": self._drifting,
            "onset": self._onset,
            "generation": self._generation,
        }

    @classmethod
    def from_state(cls, state: dict) -> "DriftMonitor":
        """Rebuild a monitor from ``state()`` output."""
        m = cls(
            state["ref_mean"],
            state["ref_std"],
            halflife=state.get("halflife", 400.0),
            z_threshold=state.get("z_threshold", 3.0),
            scale_threshold=state.get("scale_threshold", 0.69),
            patience=state.get("patience", 3),
        )
        m._mean = np.asarray(state["mean"], np.float64)
        m._var = np.asarray(state["var"], np.float64)
        m._n = int(state.get("n", 0))
        m._over = int(state.get("over", 0))
        m._drifting = bool(state.get("drifting", False))
        onset = state.get("onset")
        m._onset = None if onset is None else int(onset)
        m._generation = int(state.get("generation", 0))
        return m

    @staticmethod
    def update_many(monitors, block) -> list["DriftReport | None"]:
        """Batched EWMA step: one ``(m, n, C)`` block of same-length
        chunks, one monitor per row — the fleet engine's SoA ingest
        path (``FleetServer.push_many``) updates a whole delivery
        round's monitors in five vectorized reductions instead of m
        Python ``update`` calls.

        Bit-identity by construction: every recurrence below is the
        elementwise float64 expression ``update`` evaluates per
        monitor (same ``keep`` power, same total-variance identity,
        same verdict thresholds), just broadcast over the row axis —
        so a monitored session's drift verdicts are identical whether
        its chunk rode the batched path or the sequential one
        (test-pinned).  Rows whose monitor is None get None back;
        monitors must share ``halflife`` only per distinct chunk
        length (``keep`` is scalar per call because the block rows are
        equal length; heterogeneous halflives are gathered per row).
        """
        idx = [i for i, mon in enumerate(monitors) if mon is not None]
        out: list[DriftReport | None] = [None] * len(monitors)
        if not idx:
            return out
        mons = [monitors[i] for i in idx]
        x = np.asarray(block, np.float64)[idx]
        n = x.shape[1]
        # math.pow per row, not np.power: ``update`` computes keep with
        # the C-library pow, and the two can differ in the last ulp —
        # the batched step must be BIT-identical to the sequential one
        # (journal replay re-runs updates sequentially; an ulp of EWMA
        # drift there could flip a borderline verdict post-recovery)
        keep = np.asarray(
            [math.pow(0.5, n / m.halflife) for m in mons], np.float64
        )[:, None]
        cm = x.mean(axis=1)
        cv = x.var(axis=1)
        mean = np.stack([m._mean for m in mons])
        var = np.stack([m._var for m in mons])
        var = keep * (var + (mean - cm) ** 2 * (1 - keep)) + (
            1 - keep
        ) * cv
        mean = keep * mean + (1 - keep) * cm
        ref_mean = np.stack([m.ref_mean for m in mons])
        ref_std = np.stack([m.ref_std for m in mons])
        z = np.abs(mean - ref_mean) / ref_std
        ratio = np.log(np.sqrt(np.maximum(var, 1e-12)) / ref_std)
        over_rows = (
            (z > np.asarray([m.z_threshold for m in mons])[:, None]).any(
                axis=1
            )
            | (
                np.abs(ratio)
                > np.asarray([m.scale_threshold for m in mons])[:, None]
            ).any(axis=1)
        )
        for j, mon in enumerate(mons):
            mon._mean = mean[j]
            mon._var = var[j]
            mon._n += n
            over = bool(over_rows[j])
            mon._over = mon._over + 1 if over else 0
            if mon._over >= mon.patience:
                if not mon._drifting:
                    mon._onset = mon._n
                mon._drifting = True
            elif not over:
                mon._drifting = False
                mon._onset = None
            out[idx[j]] = DriftReport(
                drifting=mon._drifting,
                location_z=z[j],
                scale_log_ratio=ratio[j],
                n_samples=mon._n,
                onset=mon._onset,
                generation=mon._generation,
            )
        return out

    def update(self, samples) -> DriftReport:
        """Absorb ``(n, C)`` samples; return the current verdict."""
        x = np.atleast_2d(np.asarray(samples, np.float64))
        if x.shape[-1] != self.ref_mean.shape[0]:
            raise ValueError(
                f"expected (n, {self.ref_mean.shape[0]}) samples, got "
                f"{x.shape}"
            )
        n = len(x)
        if n:
            # chunk-sized EWMA step: weight of the old state after n
            # samples is (1/2)^(n/halflife) — order-insensitive within
            # a chunk, equivalent to per-sample EWMA in the aggregate
            keep = math.pow(0.5, n / self.halflife)
            cm = x.mean(axis=0)
            cv = x.var(axis=0)
            # total variance: within-chunk + between-means
            self._var = keep * (
                self._var + (self._mean - cm) ** 2 * (1 - keep)
            ) + (1 - keep) * cv
            self._mean = keep * self._mean + (1 - keep) * cm
            self._n += n

        z = np.abs(self._mean - self.ref_mean) / self.ref_std
        ratio = np.log(
            np.sqrt(np.maximum(self._var, 1e-12)) / self.ref_std
        )
        over = bool(
            (z > self.z_threshold).any()
            or (np.abs(ratio) > self.scale_threshold).any()
        )
        self._over = self._over + 1 if over else 0
        if self._over >= self.patience:
            if not self._drifting:
                self._onset = self._n  # episode starts at THIS flip
            self._drifting = True
        elif not over:
            self._drifting = False
            self._onset = None  # recovery ends the episode
        return DriftReport(
            drifting=self._drifting,
            location_z=z,
            scale_log_ratio=ratio,
            n_samples=self._n,
            onset=self._onset,
            generation=self._generation,
        )
