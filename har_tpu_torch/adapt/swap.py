"""The closed adaptation loop: drift → retrain → shadow → hot-swap →
probation → (rollback | accept).

``AdaptationEngine`` is the controller that wires the pieces together
around a live ``FleetServer``:

  serving ──trigger fires──▶ retrain (caller's ``retrainer(job)``)
     ▲                            │ candidate registered (ModelRegistry)
     │                            ▼
     │◀──gates fail (incumbent  shadowing: candidate scores a mirrored
     │    keeps serving)          sample of live dispatches
     │                            │ gates pass
     │                            ▼
     │                        hot swap: registry.promote + FleetServer.
     │                          swap_model at a dispatch boundary —
     │                          zero windows dropped, in-flight batches
     │                          finish on the old model
     │                            │
     │◀──probation clean──────────┤
     │                            │ SLO / agreement regression
     │◀──auto-rollback: registry.rollback + swap back to the prior
             incumbent (stats.rollbacks counted)

Single-threaded like the engine it controls: ``step()`` is called from
the serving loop (the CLI's drive loop, a bench lane, or a transport
shim's timer) and never blocks serving beyond the synchronous
``retrainer`` call the caller chose to run there — a deployment that
wants retraining off-thread passes a retrainer that submits and returns
the handle's result on a later step (``RetrainPending``).

Port of ``har_tpu/adapt/swap.py``: the step machine, the journal
records and the recovery reconciliation are the JAX package's.  The
engine contains a retrainer's, a registry's and a shadow tap's errors
by design (counted in ``retrain_errors``, ``registry_errors`` and
``stats.shadow_errors``, never raised), so a caller that must know its
device path ran clean reads those counters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from har_tpu_torch.adapt.registry import ModelRegistry
from har_tpu_torch.adapt.shadow import ShadowConfig, ShadowEvaluator
from har_tpu_torch.adapt.trigger import (
    ReplayBuffer,
    RetrainJob,
    RetrainTrigger,
    TriggerConfig,
)


class RetrainPending(Exception):
    """A retrainer may raise this to signal "job submitted, candidate
    not ready" — the engine stays in ``serving`` and re-runs the
    retrainer with the SAME job on later steps until it returns."""


@dataclasses.dataclass(frozen=True)
class AdaptationConfig:
    """Loop-level knobs (trigger/shadow carry their own configs)."""

    # dispatches a candidate may shadow before an undecided evaluation
    # is rejected (gates that cannot accumulate evidence must not pin
    # the loop in `shadowing` forever)
    max_shadow_dispatches: int = 64
    # post-swap watch: this many dispatches must complete without
    # regression before the swap is accepted
    probation_dispatches: int = 8
    # regression criteria inside probation: reverse-shadow agreement of
    # the OLD model vs the new incumbent below this floor ...
    probation_min_agreement: float = 0.95
    # ... with at least this much reverse evidence before agreement can
    # condemn the swap
    probation_min_windows: int = 16
    # ... or this fraction of probation dispatches breaching SLO
    probation_max_breach_frac: float = 0.5
    # ... or ANY dispatch failure during probation (the strictest
    # signal: the new model cannot score the live traffic at all)
    probation_fail_on_dispatch_failure: bool = True

    def __post_init__(self):
        if self.probation_dispatches < 1:
            raise ValueError("probation_dispatches must be >= 1")


class AdaptationEngine:
    """Drift-triggered retrain/shadow/swap/rollback controller.

    Parameters
    ----------
    server:
        The live ``FleetServer``.  The engine owns its dispatch tap.
    registry:
        Model lineage store.  A fresh registry gets the serving
        incumbent registered + promoted as the bootstrap version.
    retrainer:
        ``retrainer(job: RetrainJob) -> model`` — produces a candidate
        from the drifted-session replay (mixed into the caller's seed
        set; the engine does not prescribe how).  May raise
        ``RetrainPending`` to keep the job in flight across steps; any
        other exception rejects the job (counted, serving untouched).
    saver:
        Optional ``saver(model, path)`` used to persist candidates into
        their registry version dir (e.g. ``checkpoint.save_model``
        partial).  Without it candidates register metadata-only.
    clock:
        Injectable monotonic-seconds source shared with the trigger
        debounce — tests drive the whole loop with a FakeClock.
    """

    def __init__(
        self,
        server,
        registry: ModelRegistry,
        retrainer: Callable[[RetrainJob], object],
        *,
        config: AdaptationConfig | None = None,
        trigger: RetrainTrigger | None = None,
        trigger_config: TriggerConfig | None = None,
        shadow_config: ShadowConfig | None = None,
        saver: Callable | None = None,
        clock: Callable[[], float] | None = None,
        resume: bool = False,
        loader: Callable[[str], object] | None = None,
    ):
        self.server = server
        self.registry = registry
        self.retrainer = retrainer
        self.config = config or AdaptationConfig()
        self.shadow_config = shadow_config or ShadowConfig()
        self._saver = saver
        self._loader = loader
        self._clock = clock or time.monotonic
        self.trigger = trigger or RetrainTrigger(
            trigger_config, replay=ReplayBuffer(), clock=self._clock
        )
        self.state = "serving"
        self.log: list[dict] = []
        self.retrain_jobs = 0
        self.rejected_candidates = 0
        self.retrain_errors = 0
        self.registry_errors = 0
        self._pending_job: RetrainJob | None = None
        self._exclude: frozenset = frozenset()  # drifted sessions of
        #   the job under evaluation (agreement-gate exclusion set)
        self._shadow: ShadowEvaluator | None = None
        self._candidate = None  # (ModelVersion, model) under shadow
        self._shadow_start = 0  # stats.dispatches at shadow start
        self._probation = None  # baseline dict during probation
        if resume:
            # crash recovery (har_tpu_torch.serve.recover): reconcile the
            # recovered fleet with the registry pointer and the
            # journaled episode state instead of bootstrapping
            self._resume()
        else:
            # lineage bootstrap: the serving model becomes the promoted
            # incumbent so the first candidate has a parent and
            # rollback always has a target.  On a REUSED registry the
            # convention is that the caller serves the promoted
            # incumbent's model — the server's version label is synced
            # to it either way, so scored_by_version keys always map
            # onto registry versions.
            cur = registry.current()
            if cur is None:
                cur = registry.register(
                    None, note="incumbent:bootstrap", promote=True
                )
            server.model_version = cur.name
        server.set_dispatch_tap(self._tap)
        # durability: the engine's episode/probation state rides the
        # fleet journal's snapshots, and every transition is journaled
        # as an `adapt` record — a half-finished promotion survives a
        # SIGKILL and resumes (or rolls back) on restore
        providers = getattr(server, "snapshot_providers", None)
        if providers is not None:
            providers["adapt"] = self._snapshot_state
            if getattr(server, "journal", None) is not None:
                # the server's attach-time snapshot predates this
                # registration: write one that carries the adapt extra,
                # so episode state recovers even when a crash lands
                # before the first cadence snapshot
                server.write_snapshot()

    # ----------------------------------------------------------- tap

    def _tap(self, session_ids, windows, probs) -> bool:
        """The engine's single dispatch tap: replay capture always,
        shadow scoring (candidate or probation reverse-shadow) when one
        is active.  Return value = "shadow actually scored" (engine
        accounting)."""
        self.trigger.replay.add_batch(session_ids, windows)
        if self._shadow is not None:
            return self._shadow(session_ids, windows, probs)
        return False

    # ---------------------------------------------------------- step

    def step(self) -> dict:
        """Advance the loop one tick: pull drift state, run whichever
        transition is due, return ``status()``.  Safe to call at any
        cadence — every transition is edge-triggered and debounced."""
        self.trigger.observe_server(self.server)
        if self.state == "serving":
            self._step_serving()
        elif self.state == "shadowing":
            self._step_shadowing()
        elif self.state == "probation":
            self._step_probation()
        return self.status()

    def _note(self, event: str, **fields) -> None:
        self.log.append({"event": event, "at": self._clock(), **fields})
        # every transition also lands in the fleet journal (t="adapt"),
        # so recovery can tell a promotion that concluded from one the
        # crash interrupted
        journal = getattr(self.server, "journal", None)
        if journal is not None:
            try:
                journal.append(
                    {"t": "adapt", "ev": event, "at": self._clock(),
                     **fields}
                )
            except TypeError:
                # a non-JSON-serializable field (shouldn't happen; all
                # note fields are scalars/lists) must not kill serving
                journal.append({"t": "adapt", "ev": event})

    def _chaos(self, point: str) -> None:
        journal = getattr(self.server, "journal", None)
        if journal is not None:
            journal.chaos_point(point)

    def _step_serving(self) -> None:
        job = self._pending_job or self.trigger.poll()
        if job is None:
            return
        if self._pending_job is None:
            self.retrain_jobs += 1
            self._note(
                "trigger_fired",
                job_id=job.job_id,
                sessions=len(job.session_ids),
                channels=list(job.channels),
                reason=job.reason,
            )
        try:
            candidate = self.retrainer(job)
        except RetrainPending:
            self._pending_job = job  # re-poll the same job next step
            return
        except Exception as exc:
            self.retrain_errors += 1
            self._pending_job = None
            # re-arm the job's episodes: a persistent drift must be
            # able to fire again (after the cooldown) — one transient
            # retrain error must not disarm adaptation forever
            self.trigger.reopen(job)
            self._note(
                "retrain_failed",
                job_id=job.job_id,
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )
            return
        self._pending_job = None
        save = (
            None
            if self._saver is None
            else (lambda path: self._saver(candidate, path))
        )
        from har_tpu_torch.adapt.registry import data_fingerprint

        try:
            mv = self.registry.register(
                save,
                data_fingerprint=(
                    None
                    if job.replay is None
                    else data_fingerprint(job.replay)
                ),
                note=f"candidate:job{job.job_id}",
            )
        except Exception as exc:
            # registry I/O (disk full, permissions) must be contained
            # exactly like a retrainer failure: the candidate is
            # dropped, the incumbent keeps serving, the loop survives
            self.registry_errors += 1
            self.trigger.reopen(job)  # same re-arm as a retrain error
            self._note(
                "registry_failed",
                op="register",
                job_id=job.job_id,
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )
            return
        # the drifted sessions are excluded from the agreement gate on
        # BOTH sides of the swap: pre-swap the incumbent is not a
        # trustworthy reference on them (a corrective candidate SHOULD
        # disagree there), post-swap the replaced model isn't either
        self._start_shadow(
            mv, candidate, frozenset(job.session_ids),
            self.shadow_config,
        )
        self._note("shadow_started", version=mv.name, job_id=job.job_id)

    def _start_shadow(self, mv, candidate, exclude, shadow_config) -> None:
        """Enter ``shadowing`` for a registered candidate — shared by
        the drift-retrain path and operator-proposed candidates
        (``propose_candidate`` / the int8 promotion path)."""
        self._exclude = exclude
        self._shadow = ShadowEvaluator(
            candidate,
            shadow_config,
            exclude_sessions=exclude,
            clock=self._clock,
        )
        self._candidate = (mv, candidate)
        # budget baseline counts dispatch ATTEMPT outcomes (successes
        # AND failures): a fleet whose every dispatch fails must still
        # run the evidence budget down and reject, not pin `shadowing`
        self._shadow_start = (
            self.server.stats.dispatches
            + self.server.stats.dispatch_failures
        )
        self.state = "shadowing"

    # ------------------------------------------- proposed candidates

    def propose_candidate(
        self,
        candidate,
        *,
        note: str = "candidate:proposed",
        shadow_config: ShadowConfig | None = None,
    ) -> str:
        """Inject a candidate WITHOUT a drift trigger — same evidence
        discipline as a retrained one: register in the lineage, shadow
        against live traffic, gate, hot-swap at a dispatch boundary,
        probation with automatic rollback.  No session is excluded from
        the agreement gate (there is no drifted cohort: the incumbent
        is the trusted reference everywhere — exactly the stance a
        tier change wants).  Returns the registered version label;
        refuses while a shadow or probation is already in flight (one
        candidate at a time is the loop's whole safety story)."""
        if self.state != "serving":
            raise RuntimeError(
                f"cannot propose a candidate while {self.state!r}; "
                "wait for the loop to settle"
            )
        try:
            mv = self.registry.register(None, note=note)
        except Exception as exc:
            self.registry_errors += 1
            self._note(
                "registry_failed",
                op="register",
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )
            raise
        self._start_shadow(
            mv, candidate, frozenset(),
            shadow_config or self.shadow_config,
        )
        self._note("shadow_started", version=mv.name, proposed=note)
        return mv.name

    def propose_int8(
        self,
        *,
        max_latency_factor: float | None = 1.5,
        shadow_config: ShadowConfig | None = None,
    ) -> str:
        """THE quantization promotion path: quantize the serving
        incumbent to the int8 tier (har_tpu_torch.quantize.quantize_serving —
        weights int8 on the device, dequantized inside the
        forward), shadow the int8 scorer against the live f32 traffic,
        and gate on agreement PLUS a latency factor (an int8 tier that
        is slower than the f32 incumbent has no reason to exist) —
        then hot-swap at a dispatch boundary with probation and
        automatic rollback exactly like a retrain candidate.  Adoption
        is on measurement, not faith: a quantization that moves live
        decisions past the agreement floor is rejected with evidence
        in the registry, and a post-swap regression rolls back."""
        from har_tpu_torch.quantize import quantize_serving

        candidate = quantize_serving(self.server.model)
        cfg = shadow_config or dataclasses.replace(
            self.shadow_config, max_latency_factor=max_latency_factor
        )
        return self.propose_candidate(
            candidate, note="candidate:int8", shadow_config=cfg
        )

    def _step_shadowing(self) -> None:
        # live incumbent baseline for the optional latency gate: the
        # engine's own dispatch-stage mean (replaced each step — the
        # gate compares means, so only the latest baseline matters)
        disp = self.server.stats.dispatch
        if disp.count:
            self._shadow.set_incumbent_ms(disp.total_ms / disp.count)
        gates = self._shadow.gates()
        mv, candidate = self._candidate
        if gates["passed"]:
            self._swap_to(mv, candidate, gates)
            return
        waited = (
            self.server.stats.dispatches
            + self.server.stats.dispatch_failures
            - self._shadow_start
        )
        if waited >= self.config.max_shadow_dispatches:
            # undecided or failing after the evidence budget: the
            # incumbent keeps serving, the candidate stays in the
            # registry unpromoted (auditable, prunable)
            self.rejected_candidates += 1
            self._note(
                "candidate_rejected",
                version=mv.name,
                gates=gates,
                dispatches_waited=waited,
            )
            self._shadow = None
            self._candidate = None
            self.trigger.hold()
            self.state = "serving"

    def _swap_to(self, mv, candidate, gates: dict) -> None:
        stats = self.server.stats
        prev_version = self.server.model_version
        prev_model = self.server.model
        try:
            self.registry.promote(mv.version)
        except Exception as exc:
            # cannot record the promotion → do not swap: an unrecorded
            # incumbent would have no rollback trail.  The candidate is
            # rejected, the incumbent keeps serving.
            self.registry_errors += 1
            self.rejected_candidates += 1
            self._note(
                "registry_failed",
                op="promote",
                version=mv.name,
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )
            self._shadow = None
            self._candidate = None
            self.trigger.hold()
            self.state = "serving"
            return
        # the registry pointer is durable, the fleet swap is not yet: a
        # kill HERE is the half-finished promotion the recovery path
        # must complete (serve CURRENT) — the chaos harness pins it
        self._chaos("mid_promote")
        self.server.swap_model(candidate, version=mv.name)
        self.server.reset_monitors()  # re-arm: fresh episodes only
        self.trigger.aggregator.reset()
        self.trigger.hold()
        # probation: reverse-shadow the REPLACED model against the new
        # incumbent's live traffic — disagreement now means the swap
        # changed fleet decisions more than the shadow sample promised
        self._shadow = ShadowEvaluator(
            prev_model,
            ShadowConfig(
                sample_every=1,
                min_windows=self.config.probation_min_windows,
            ),
            exclude_sessions=self._exclude,
            clock=self._clock,
        )
        self._candidate = None
        self._probation = {
            "version": mv.name,
            "prev_version": prev_version,
            "prev_model": prev_model,
            "dispatches0": stats.dispatches,
            "breaches0": stats.slo_breaches,
            "failures0": stats.dispatch_failures,
        }
        self.state = "probation"
        self._note(
            "swapped",
            version=mv.name,
            from_version=prev_version,
            shadow=gates,
        )
        # the 'swapped' record must be durable WITH the swap record: a
        # kill after the swap flushed but before this note would
        # otherwise recover into plain serving and skip probation —
        # the promoted candidate would run with no watchdog
        journal = getattr(self.server, "journal", None)
        if journal is not None:
            journal.flush()

    def _step_probation(self) -> None:
        cfg = self.config
        stats = self.server.stats
        p = self._probation
        dispatches = stats.dispatches - p["dispatches0"]
        breaches = stats.slo_breaches - p["breaches0"]
        failures = stats.dispatch_failures - p["failures0"]
        regression = None
        if cfg.probation_fail_on_dispatch_failure and failures > 0:
            regression = f"{failures} dispatch failure(s) post-swap"
        elif (
            dispatches >= 2
            and breaches / dispatches > cfg.probation_max_breach_frac
        ):
            regression = (
                f"SLO regression: {breaches}/{dispatches} post-swap "
                "dispatches breached"
            )
        else:
            agr = self._shadow.agreement
            if (
                agr is not None
                and self._shadow.n_windows >= cfg.probation_min_windows
                and agr < cfg.probation_min_agreement
            ):
                regression = (
                    f"agreement regression: {agr:.4f} < "
                    f"{cfg.probation_min_agreement} vs prior incumbent"
                )
        if regression is not None:
            self._rollback(regression)
            return
        if dispatches >= cfg.probation_dispatches:
            self._note(
                "probation_passed",
                version=p["version"],
                dispatches=dispatches,
                reverse_agreement=self._shadow.agreement,
            )
            self._shadow = None
            self._probation = None
            self.state = "serving"

    def _rollback(self, reason: str) -> None:
        p = self._probation
        try:
            rolled = self.registry.rollback()
            registry_version = rolled.name
        except Exception as exc:
            # serving correctness over lineage: swap the prior model
            # back even when the registry write fails (the pointer can
            # be repaired; a regressing model serving the fleet cannot)
            self.registry_errors += 1
            registry_version = None
            self._note(
                "registry_failed",
                op="rollback",
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )
        # the rollback DECISION (the registry event, or the journaled
        # registry_failed record when the pointer write failed) must be
        # durable before the swap-back: a kill in between must leave
        # recovery knowing a rollback was owed, not guessing
        journal = getattr(self.server, "journal", None)
        if journal is not None:
            journal.flush()
        # mirror of mid_promote: pointer rolled back, swap-back not yet
        # applied — recovery must land the fleet on CURRENT
        self._chaos("mid_rollback")
        self.server.swap_model(p["prev_model"], version=p["prev_version"])
        self.server.stats.rollbacks += 1
        self.server.reset_monitors()
        self.trigger.aggregator.reset()
        self.trigger.hold()
        self._note(
            "rolled_back",
            to_version=p["prev_version"],
            registry_version=registry_version,
            from_version=p["version"],
            reason=reason,
        )
        # durable WITH the swap-back it concludes (mirror of _swap_to's
        # flush): a kill between them would otherwise re-enter a
        # phantom probation for the already-rolled-back version
        journal = getattr(self.server, "journal", None)
        if journal is not None:
            journal.flush()
        self._shadow = None
        self._probation = None
        self.state = "serving"

    # ---------------------------------------------------- durability

    def _snapshot_state(self) -> dict:
        """Episode + loop state persisted inside the fleet journal's
        snapshots (FleetServer.snapshot_providers).  A candidate under
        shadow is deliberately NOT persisted — a model object has no
        journal form; recovery abandons an in-flight shadow evaluation
        (the candidate stays registered unpromoted, the trigger
        re-fires for a persistent drift)."""
        agg = {}
        for sid, st in self.trigger.aggregator._sessions.items():
            agg[str(sid)] = {
                "onset": st.onset,
                "channels": sorted(st.channels),
                "last_seen": st.last_seen,
                "clean_streak": st.clean_streak,
                "alerted_onset": st.alerted_onset,
                "last_n": st.last_n,
                "last_gen": st.last_gen,
            }
        return {
            "state": self.state,
            "probation": (
                None
                if self._probation is None
                else {
                    "version": self._probation["version"],
                    "prev_version": self._probation["prev_version"],
                }
            ),
            "trigger": {
                "last_fired": self.trigger._last_fired,
                "n_jobs": self.trigger._n_jobs,
            },
            "counters": {
                "retrain_jobs": self.retrain_jobs,
                "rejected_candidates": self.rejected_candidates,
                "retrain_errors": self.retrain_errors,
                "registry_errors": self.registry_errors,
            },
            "aggregator": agg,
        }

    def _resume(self) -> None:
        """Crash-recovery reconciliation (``resume=True``): restore the
        journaled loop state and resolve any half-finished transition.

        The registry pointer is the durable source of truth for WHICH
        version should serve: a kill between ``registry.promote`` and
        the fleet swap (or between ``registry.rollback`` and the
        swap-back) leaves the pointer ahead of the fleet — recovery
        completes the swap to CURRENT via ``loader`` and, for a
        promotion, resumes probation from a fresh baseline.  An
        in-flight shadow evaluation is abandoned cleanly (candidate
        stays registered unpromoted; a persistent drift re-fires after
        the cooldown)."""
        from har_tpu_torch.adapt.trigger import _SessionDrift

        server = self.server
        snap = (getattr(server, "recovered_extra", None) or {}).get(
            "adapt"
        ) or {}
        for k, v in (snap.get("counters") or {}).items():
            if hasattr(self, k):
                setattr(self, k, int(v))
        trig = snap.get("trigger") or {}
        if "last_fired" in trig:
            self.trigger._last_fired = float(trig["last_fired"])
        if "n_jobs" in trig:
            self.trigger._n_jobs = int(trig["n_jobs"])
        # episode state: restored per session so recovery does not
        # double-count drift evidence or forget an alerted episode
        sid_map = {str(sid): sid for sid in server.sessions}
        for key, st in (snap.get("aggregator") or {}).items():
            sid = sid_map.get(key)
            if sid is None:
                continue
            s = _SessionDrift()
            s.onset = st.get("onset")
            s.channels = set(st.get("channels") or [])
            s.last_seen = float(st.get("last_seen", -float("inf")))
            s.clean_streak = int(st.get("clean_streak", 0))
            s.alerted_onset = st.get("alerted_onset")
            s.last_n = int(st.get("last_n", -1))
            s.last_gen = st.get("last_gen")
            self.trigger.aggregator._sessions[sid] = s
        # loop state at the crash: journal suffix overrides snapshot
        state = snap.get("state", "serving")
        probation = snap.get("probation")
        pending_rollback = None  # regression decided, swap-back unproven
        for rec in getattr(server, "recovered_adapt_records", []):
            ev = rec.get("ev")
            if ev == "shadow_started":
                state = "shadowing"
            elif ev in ("swapped", "recovery_completed_promotion"):
                state = "probation"
                probation = {
                    "version": rec.get("version"),
                    "prev_version": rec.get("from_version"),
                }
                pending_rollback = None
            elif ev == "recovery_resumed_probation":
                # a PRIOR recovery resumed probation: a second crash
                # must resume it again, not forget it
                state = "probation"
                if probation is None:
                    probation = {
                        "version": rec.get("version"),
                        "prev_version": None,
                    }
            elif ev in (
                "recovery_completed_rollback",
                "recovery_abandoned_shadow",
                "recovery_probation_unresumable",
                "recovery_probation_superseded",
                "recovery_rollback_unresumable",
            ):
                state = "serving"
                probation = None
                pending_rollback = None
            elif ev == "registry_failed" and rec.get("op") == "rollback":
                # the live path swaps back even when the pointer write
                # fails ("serving correctness over lineage"); a kill
                # between this record and the swap-back must not leave
                # the regressing model serving — remember the intent
                pending_rollback = probation
                state = "serving"
                probation = None
            elif ev in (
                "rolled_back", "probation_passed", "candidate_rejected",
                "retrain_failed", "registry_failed",
            ):
                if ev == "rolled_back":
                    # the swap-back is noted AFTER it applies: proven
                    pending_rollback = None
                state = "serving"
                probation = None
        # a regression verdict whose rollback never finished (registry
        # write failed, then the kill hit before the swap-back): finish
        # it now, exactly as the live path would have
        completed_pending_rollback = False
        if (
            pending_rollback is not None
            and server.model_version == pending_rollback.get("version")
        ):
            prev_version = pending_rollback.get("prev_version")
            prev_model = None
            if self._loader is not None:
                try:
                    prev_model = self._loader(prev_version)
                except Exception:
                    prev_model = None
            if prev_model is None:
                # cannot load the prior incumbent: the condemned model
                # keeps serving, but NEVER silently — the operator (and
                # the journal) get the unresumable verdict
                self._note(
                    "recovery_rollback_unresumable",
                    version=pending_rollback.get("version"),
                    prev_version=prev_version,
                )
            else:
                try:
                    self.registry.rollback()  # retry the pointer write
                except Exception:
                    self.registry_errors += 1
                server.swap_model(prev_model, version=prev_version)
                server.stats.rollbacks += 1
                server.reset_monitors()
                self.trigger.aggregator.reset()
                self.trigger.hold()
                completed_pending_rollback = True
                self._note(
                    "recovery_completed_rollback",
                    version=prev_version,
                    from_version=pending_rollback.get("version"),
                )
        # registry reconciliation: the pointer moved but the fleet
        # didn't — complete the half-finished transition.  Skipped
        # after a completed pending rollback whose pointer retry failed
        # again: the pointer then still names the REGRESSING version,
        # and "serving correctness over lineage" wins.
        cur = self.registry.current()
        if completed_pending_rollback:
            cur = None
        completed_promote = False
        if cur is not None and cur.name != server.model_version:
            if self._loader is None:
                raise RuntimeError(
                    "recovery found registry CURRENT "
                    f"({cur.name}) != serving version "
                    f"({server.model_version}) but no loader was given; "
                    "pass loader=version_label->model to resume"
                )
            prev_version = server.model_version
            prev_model = server.model
            last_event = None
            for line in self.registry.history():
                last_event = line.get("event")
            server.swap_model(self._loader(cur.name), version=cur.name)
            server.reset_monitors()
            self.trigger.aggregator.reset()
            self.trigger.hold()
            if last_event == "promote":
                # finish the promotion: watch the completed swap
                completed_promote = True
                state = "probation"
                probation = {
                    "version": cur.name, "prev_version": prev_version,
                }
                self._probation_models = (prev_version, prev_model)
                self._note(
                    "recovery_completed_promotion",
                    version=cur.name,
                    from_version=prev_version,
                )
            else:  # rollback concluded: serve the restored incumbent
                state = "serving"
                probation = None
                self._note(
                    "recovery_completed_rollback",
                    version=cur.name,
                    from_version=prev_version,
                )
        if state == "shadowing":
            # the candidate model died with the process: abandon the
            # evaluation; the registry still holds the artifact
            self.trigger.hold()
            self._note("recovery_abandoned_shadow")
            state = "serving"
        if (
            state == "probation"
            and probation is not None
            and probation.get("version") != server.model_version
        ):
            # the journal proves a later swap superseded the probation
            # target (e.g. the swap-back applied but its 'rolled_back'
            # note died in the buffer): nothing left to watch
            self._note(
                "recovery_probation_superseded",
                version=probation.get("version"),
                serving=server.model_version,
            )
            state = "serving"
            probation = None
        if state == "probation" and probation is not None:
            prev_version = probation.get("prev_version")
            prev_model = None
            if completed_promote:
                prev_model = self._probation_models[1]
            elif self._loader is not None and prev_version:
                try:
                    prev_model = self._loader(prev_version)
                except Exception:
                    prev_model = None
            if prev_model is None:
                # cannot reverse-shadow or roll back without the prior
                # model: keep serving the incumbent, say so loudly
                self._note(
                    "recovery_probation_unresumable",
                    version=probation.get("version"),
                )
                state = "serving"
            else:
                stats = server.stats
                self._shadow = ShadowEvaluator(
                    prev_model,
                    ShadowConfig(
                        sample_every=1,
                        min_windows=self.config.probation_min_windows,
                    ),
                    clock=self._clock,
                )
                self._probation = {
                    "version": probation.get("version"),
                    "prev_version": prev_version,
                    "prev_model": prev_model,
                    "dispatches0": stats.dispatches,
                    "breaches0": stats.slo_breaches,
                    "failures0": stats.dispatch_failures,
                }
                self._note(
                    "recovery_resumed_probation",
                    version=probation.get("version"),
                )
        self.state = state

    # -------------------------------------------------------- status

    def status(self) -> dict:
        """JSON-ready loop state for CLIs, bench lanes and the gate."""
        stats = self.server.stats
        out = {
            "state": self.state,
            "serving_version": self.server.model_version,
            "retrain_jobs": self.retrain_jobs,
            "retrain_errors": self.retrain_errors,
            "registry_errors": self.registry_errors,
            "rejected_candidates": self.rejected_candidates,
            "swaps": stats.model_swaps,
            "rollbacks": stats.rollbacks,
            "shadow_batches": stats.shadow_batches,
            "shadow_windows": stats.shadow_windows,
        }
        if self._shadow is not None:
            key = "shadow" if self.state == "shadowing" else "probation_shadow"
            out[key] = self._shadow.report()
        return out
