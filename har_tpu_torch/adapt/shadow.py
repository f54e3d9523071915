"""Shadow evaluation: score a candidate model on mirrored live traffic
before letting it serve anyone.

A retrained candidate's held-out accuracy says nothing about the live
distribution that triggered the retrain — the honest test is the live
traffic itself.  ``ShadowEvaluator`` is ``FleetServer``'s dispatch tap
(``set_dispatch_tap``): after each batch's events are finalized, it
receives the unpadded windows and the incumbent's probabilities,
deterministically samples a BOUNDED fraction of batches (never the
serving critical path — per-event latencies are recorded before the tap
runs), scores the candidate on the mirror, and accumulates:

  - agreement: argmax match rate candidate-vs-incumbent, measured on
    TRUSTED traffic only (``exclude_sessions`` — the drifted sessions
    that triggered the retrain).  On drifted traffic the incumbent is
    the suspect, so disagreement there is the candidate doing its job;
    on in-distribution traffic the incumbent is the ground reference,
    so disagreement there is regression.  Without the exclusion a
    drift-correcting candidate could never pass an agreement gate —
    the exact failure mode the loop exists to fix;
  - mean |Δp|: probability-level divergence over ALL mirrored windows
    (drifted included — a candidate can agree on argmax while moving
    every confidence; the drifted-side movement is worth seeing).
    CAVEAT: when the incumbent serves FUSED, the tap's incumbent
    probabilities are the compact decision-confidence surrogate
    (serve.dispatch.compact_probs — exact at the decision label,
    uniform elsewhere), so Δp then measures against the surrogate and
    overstates off-label movement.  The agreement gate — the actual
    promotion criterion — compares argmaxes and is exact either way;
  - candidate latency per mirrored batch — a candidate that is too slow
    to serve must fail the gate BEFORE the swap, not after.

``gates()`` is the promotion verdict: enough trusted evidence,
agreement above threshold, latency within budget.  The engine's
``stats.shadow_*`` counters and ``shadow_ms`` histogram carry the same
evidence into every stats snapshot.

Port of ``har_tpu/adapt/shadow.py``.  A candidate's ``transform`` runs
on its own device and returns host arrays, so the latency sample
brackets the whole synchronous call — scaler, host-to-device copy,
forward, fetch and softmax — while the incumbent's baseline is the
engine's mean dispatch-stage time.  The first mirrored batch pays the
candidate's warm-up (its kernels' first launch, allocator growth),
which ``latency_warmup`` keeps out of the sample.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Sampling bound + promotion gates."""

    # score every Nth dispatched batch (the bounded mirror fraction:
    # 1/sample_every of dispatches pay a shadow scoring)
    sample_every: int = 2
    # promotion gates
    min_windows: int = 64  # TRUSTED-window evidence floor
    min_agreement: float = 0.98  # argmax match floor on trusted traffic
    # candidate mean batch latency must stay within this factor of the
    # incumbent's observed mean dispatch latency (None disables —
    # host-stub incumbents measure microseconds that no real model meets)
    max_latency_factor: float | None = None
    # initial scored batches EXCLUDED from the latency sample: the
    # candidate's first mirrored batch pays its warm-up, which
    # is deployment cadence, not serving speed — a latency gate that
    # reads the warm-up as serving would reject every device candidate
    # (the int8 promotion path gates on exactly this sample).  The
    # batches still count toward agreement/Δp evidence.
    latency_warmup: int = 1

    def __post_init__(self):
        if self.sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        if self.latency_warmup < 0:
            raise ValueError("latency_warmup must be >= 0")
        if self.min_windows < 1:
            # 0 would let gates() pass with NO evidence at all (no
            # agreement, no latency) and promote an unscored candidate
            raise ValueError("min_windows must be >= 1")
        if not (0.0 <= self.min_agreement <= 1.0):
            raise ValueError("min_agreement must be in [0, 1]")


class ShadowEvaluator:
    """Accumulating candidate-vs-incumbent comparison over mirrored
    dispatch batches.  Install with ``server.set_dispatch_tap(shadow)``;
    the ``__call__`` signature is the tap contract."""

    def __init__(
        self,
        candidate,
        config: ShadowConfig | None = None,
        *,
        exclude_sessions=None,
        clock: Callable[[], float] | None = None,
    ):
        self.candidate = candidate
        self.config = config or ShadowConfig()
        # the DRIFTED sessions behind the retrain: their windows are
        # scored (Δp visibility) but excluded from the agreement gate —
        # the incumbent is not a trustworthy reference on them
        self.exclude_sessions = (
            frozenset() if exclude_sessions is None
            else frozenset(exclude_sessions)
        )
        self._clock = clock or time.perf_counter
        self._calls = 0
        self.n_batches = 0
        self.n_windows = 0  # trusted (gate-counted) windows
        self.n_windows_excluded = 0  # drifted-session windows scored
        self.n_agree = 0
        self._abs_dp_sum = 0.0
        self._abs_dp_n = 0
        self._cand_ms: list[float] = []
        self._incumbent_ms: float | None = None  # latest running mean

    # ------------------------------------------------------- the tap

    def __call__(
        self, session_ids: Sequence, windows: np.ndarray,
        incumbent_probs: np.ndarray,
    ) -> bool:
        """Score a mirrored batch when the sampler selects it.  Returns
        True when scored (the engine then records shadow accounting)."""
        self._calls += 1
        if (self._calls - 1) % self.config.sample_every:
            return False
        from har_tpu_torch.serving import pad_pow2

        k = len(windows)
        # THE shared power-of-two padding policy (serving.pad_pow2): a
        # device candidate reuses the incumbent's batch-shape budget
        # instead of one new batch shape per tail-batch size (and the
        # latency sample measures serving, not warm-up cadence)
        windows = pad_pow2(windows)
        t0 = self._clock()
        preds = self.candidate.transform(windows)
        cand = np.asarray(preds.probability[:k], np.float64)
        if self.n_batches >= self.config.latency_warmup:
            self._cand_ms.append((self._clock() - t0) * 1e3)
        inc = np.asarray(incumbent_probs, np.float64)
        self.n_batches += 1
        trusted = np.asarray(
            [sid not in self.exclude_sessions for sid in session_ids],
            bool,
        )
        self.n_windows += int(trusted.sum())
        self.n_windows_excluded += int((~trusted).sum())
        self.n_agree += int(
            (
                cand[trusted].argmax(axis=-1)
                == inc[trusted].argmax(axis=-1)
            ).sum()
        )
        self._abs_dp_sum += float(np.abs(cand - inc).sum())
        self._abs_dp_n += cand.size
        return True

    def set_incumbent_ms(self, mean_ms: float) -> None:
        """THE entry point for the latency-gate baseline: replace it
        with the incumbent's current running mean (AdaptationEngine
        feeds FleetStats.dispatch's mean each step)."""
        self._incumbent_ms = float(mean_ms)

    # ------------------------------------------------------ verdicts

    @property
    def agreement(self) -> float | None:
        if not self.n_windows:
            return None
        return self.n_agree / self.n_windows

    def report(self) -> dict:
        """JSON-ready evidence summary."""
        return {
            "batches_scored": self.n_batches,
            "windows_scored": self.n_windows,
            "windows_excluded": self.n_windows_excluded,
            "agreement": (
                None if self.agreement is None else round(self.agreement, 4)
            ),
            "mean_abs_prob_delta": (
                round(self._abs_dp_sum / self._abs_dp_n, 6)
                if self._abs_dp_n
                else None
            ),
            "candidate_mean_batch_ms": (
                round(float(np.mean(self._cand_ms)), 3)
                if self._cand_ms
                else None
            ),
            "incumbent_mean_batch_ms": (
                None
                if self._incumbent_ms is None
                else round(self._incumbent_ms, 3)
            ),
        }

    def gates(self) -> dict:
        """The promotion verdict: {passed, reasons, **report}."""
        cfg = self.config
        reasons: list[str] = []
        if self.n_windows < cfg.min_windows:
            reasons.append(
                f"insufficient evidence: {self.n_windows} trusted "
                f"shadow-scored windows < min_windows={cfg.min_windows}"
            )
        agr = self.agreement
        if agr is not None and agr < cfg.min_agreement:
            reasons.append(
                f"agreement {agr:.4f} < min_agreement="
                f"{cfg.min_agreement}"
            )
        if cfg.max_latency_factor is not None:
            if not self._cand_ms:
                # a configured latency gate may NEVER pass on zero
                # latency evidence: with latency_warmup excluding the
                # compile batch, the first mirrored batch alone could
                # otherwise satisfy min_windows and promote a slow
                # candidate entirely unmeasured
                reasons.append(
                    "no post-warmup latency evidence yet "
                    f"(latency_warmup={cfg.latency_warmup}) — the "
                    "max_latency_factor gate needs a measured batch"
                )
            elif self._incumbent_ms is not None:
                cand = float(np.mean(self._cand_ms))
                inc = self._incumbent_ms
                if cand > cfg.max_latency_factor * inc:
                    reasons.append(
                        f"candidate batch latency {cand:.3f}ms > "
                        f"{cfg.max_latency_factor}x incumbent "
                        f"{inc:.3f}ms"
                    )
        out = {"passed": not reasons, "reasons": reasons}
        out.update(self.report())
        return out
