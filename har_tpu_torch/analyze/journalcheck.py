"""HL003 — journal/replay exhaustiveness: record types, replay
handlers and chaos kill points must stay in bijection.

Three closed sets keep the durability layer honest, and each has a
writer side and a consumer side that live in DIFFERENT files — exactly
the shape that drifts:

  1. every journal record type written anywhere in the fleet stack
     (``_jappend({"t": "push", ...})`` in the engine,
     ``journal.append({"t": "adapt", ...})`` in the adaptation
     controller, ``ship_journal.append({"t": "ship_chunk", ...})`` in
     the journal-ship receiver) must have a replay handler in a
     replay module — ``serve/recover.py`` for fleet records, ``serve/
     net/ship.py`` for the ship log's own records (``t == "push"`` /
     ``t == "ship_chunk"`` dispatch) — a recordless handler is dead
     code, a handlerless record is data a crash writes and recovery
     silently drops (the replay loops tolerate unknown types BY DESIGN
     for forward compat, which is precisely why the same-version check
     must be static);
  2. every replay handler must correspond to a written record type;
  3. the kill-point names the chaos matrix enumerates
     (``KILL_POINTS`` + ``ENGINE_KILL_POINTS`` + the cluster, ship,
     replication-tail and gateway tuples in ``serve/chaos.py``) must
     biject with the ``chaos_point("...")`` / ``_chaos("...")`` call
     sites across the stack, and every matrix point needs a
     ``_DEFAULT_AT`` occurrence calibration — a stage boundary without
     a matrix entry is a crash window no chaos run ever exercises;
  4. the gateway pair's ``{"moved": leader_addr}`` receipt has a writer
     side (the standby/drain refusal dict in ``serve/net``) and a
     consumer side (the HA client's ``"moved" in resp`` redirect) —
     losing either turns a declared refusal into a silent hangup (no
     writer) or an unfollowable one (no handler), so the pair is pinned
     in both directions like the record/handler bijection.
"""

from __future__ import annotations

import ast

from har_tpu_torch.analyze.core import FileContext, Finding, Rule, call_name

_CHAOS_NAMES = {"chaos_point", "_chaos"}


def _is_journal_write(node: ast.Call) -> bool:
    """True for the two real journaling spellings: the engine's
    ``self._jappend(...)`` wrapper, and ``<journal>.append(...)`` where
    the receiver's terminal name names a journal (``journal.append``,
    ``self._journal.append``).  A bare ``something.append`` is the
    universal LIST method — an ordinary list of dicts that happen to
    carry a "t" key must never read as a phantom record type."""
    name = call_name(node)
    if name == "_jappend":
        return True
    if name != "append" or not isinstance(node.func, ast.Attribute):
        return False
    recv = node.func.value
    terminal = (
        recv.id if isinstance(recv, ast.Name)
        else recv.attr if isinstance(recv, ast.Attribute)
        else ""
    )
    return "journal" in terminal.lower()


def _record_writes(ctx: FileContext) -> list[tuple[str, ast.AST]]:
    """``("push", node)`` for every journaled dict literal with a
    constant "t" key passed to an append-style call."""
    out = []
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Call)
            and _is_journal_write(node)
            and node.args
            and isinstance(node.args[0], ast.Dict)
        ):
            continue
        d = node.args[0]
        for k, v in zip(d.keys, d.values):
            if (
                isinstance(k, ast.Constant)
                and k.value == "t"
                and isinstance(v, ast.Constant)
                and isinstance(v.value, str)
            ):
                out.append((v.value, node))
    return out


def _replay_handlers(ctx: FileContext) -> list[tuple[str, ast.AST]]:
    """``t == "push"``-style comparisons in the replay dispatch."""
    out = []
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Compare)
            and isinstance(node.left, ast.Name)
            and node.left.id == "t"
            and len(node.ops) == 1
            and isinstance(node.ops[0], ast.Eq)
            and isinstance(node.comparators[0], ast.Constant)
            and isinstance(node.comparators[0].value, str)
        ):
            continue
        out.append((node.comparators[0].value, node))
    return out


def _string_tuple(tree: ast.Module, name: str) -> tuple[set[str], ast.AST | None]:
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets
            )
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            return (
                {
                    e.value
                    for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                },
                node,
            )
    return set(), None


def _dict_keys(tree: ast.Module, name: str) -> set[str]:
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets
            )
            and isinstance(node.value, ast.Dict)
        ):
            return {
                k.value
                for k in node.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            }
    return set()


class JournalExhaustivenessRule(Rule):
    rule_id = "HL003"
    title = "journal/replay exhaustiveness"

    def finalize(self, ctxs: list[FileContext]) -> list[Finding]:
        findings: list[Finding] = []
        written: dict[str, tuple[FileContext, ast.AST]] = {}
        handled: dict[str, tuple[FileContext, ast.AST]] = {}
        chaos_calls: dict[str, tuple[FileContext, ast.AST]] = {}
        chaos_ctx = None
        declared: set[str] = set()
        declared_node = None
        default_at: set[str] = set()
        matrix_points: set[str] = set()
        retired: set[str] = set()
        retired_node = None
        recover_ctx = None
        moved_writers: list[tuple[FileContext, ast.AST]] = []
        moved_handlers: list[tuple[FileContext, ast.AST]] = []

        for ctx in ctxs:
            base = ctx.rel.rsplit("/", 1)[-1]
            for t, node in _record_writes(ctx):
                written.setdefault(t, (ctx, node))
            # two replay modules: the fleet suffix replay (recover.py)
            # and the ship log's resume replay (net/ship.py) — the ship
            # record family's handlers live beside their writer, and a
            # deleted ship_chunk handler must flag exactly like a
            # deleted fleet handler
            if base in ("recover.py", "ship.py"):
                for t, node in _replay_handlers(ctx):
                    handled.setdefault(t, (ctx, node))
            if base == "recover.py":
                # record types whose writer was superseded (per-event
                # `ack` → group-committed `acks`) but whose journals
                # are still in the field: the handler stays forever,
                # declared — and the declaration is itself pinned both
                # ways below
                recover_ctx = ctx
                retired, retired_node = _string_tuple(
                    ctx.tree, "RETIRED_RECORD_TYPES"
                )
            if base == "chaos.py":
                chaos_ctx = ctx
                kp, kp_node = _string_tuple(ctx.tree, "KILL_POINTS")
                ekp, _ = _string_tuple(ctx.tree, "ENGINE_KILL_POINTS")
                # the cluster control plane's migration points
                # (mid_migration / mid_handoff) join both bijections:
                # they need chaos_point/_chaos call sites AND a
                # _DEFAULT_AT occurrence calibration like any matrix
                # point — a hand-off stage boundary without a matrix
                # entry is a crash window no chaos run exercises
                ckp, _ = _string_tuple(ctx.tree, "CLUSTER_KILL_POINTS")
                # the journal-ship transfer's stage boundaries
                # (mid_ship_send / mid_ship_recv / post_ship_pre_drain)
                # join the same way: dropping one from the declared
                # tuple orphans its call site, deleting a call site
                # orphans the matrix entry
                skp, _ = _string_tuple(ctx.tree, "SHIP_KILL_POINTS")
                # the continuous-replication tail's stage boundaries
                # (mid_tail_recv / mid_tail_remanifest /
                # post_tail_verify, fired inside net/tail.py's pull and
                # finalize loops, run by run_tail_kill_point): same
                # bijection — a tail boundary outside the matrix is a
                # standby-death window no chaos run exercises
                tkp, _ = _string_tuple(ctx.tree, "TAIL_KILL_POINTS")
                # the ingest gateway pair's stage boundaries
                # (mid_frame_recv / post_accept_pre_forward /
                # mid_lease_handoff, fired inside net/gateway.py's
                # admission and drain paths, run by
                # run_gateway_kill_point): same bijection — an edge
                # boundary outside the matrix is a gateway-death
                # window no chaos run exercises
                gkp, _ = _string_tuple(ctx.tree, "GATEWAY_KILL_POINTS")
                declared = kp | ekp | ckp | skp | tkp | gkp
                matrix_points = kp | ckp | skp | tkp | gkp
                declared_node = kp_node
                default_at = _dict_keys(ctx.tree, "_DEFAULT_AT")
            for node in ast.walk(ctx.tree):
                if (
                    isinstance(node, ast.Call)
                    and call_name(node) in _CHAOS_NAMES
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    chaos_calls.setdefault(node.args[0].value, (ctx, node))
            # the moved-receipt bijection lives entirely in the
            # transport package: writers are `{"moved": ...}` dict
            # literals, consumers are `"moved" in resp` membership
            # tests or `.get("moved")` reads
            if "serve/net/" in ctx.rel:
                for node in ast.walk(ctx.tree):
                    if isinstance(node, ast.Dict) and any(
                        isinstance(k, ast.Constant) and k.value == "moved"
                        for k in node.keys
                    ):
                        moved_writers.append((ctx, node))
                    elif (
                        isinstance(node, ast.Compare)
                        and isinstance(node.left, ast.Constant)
                        and node.left.value == "moved"
                        and len(node.ops) == 1
                        and isinstance(node.ops[0], ast.In)
                    ):
                        moved_handlers.append((ctx, node))
                    elif (
                        isinstance(node, ast.Call)
                        and call_name(node) == "get"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and node.args[0].value == "moved"
                    ):
                        moved_handlers.append((ctx, node))

        # record types <-> replay handlers, both directions
        recover_seen = bool(handled) or any(
            c.rel.endswith("recover.py") for c in ctxs
        )
        if recover_seen:
            for t in sorted(set(written) - set(handled)):
                ctx, node = written[t]
                findings.append(
                    ctx.finding(
                        self.rule_id,
                        node,
                        f"journal record type {t!r} is written here but "
                        "has no replay handler in serve/recover.py — a "
                        "crash would silently drop it (the replay loop "
                        "skips unknown types for forward compat; "
                        "same-version exhaustiveness is this check)",
                    )
                )
            for t in sorted(set(handled) - set(written) - retired):
                ctx, node = handled[t]
                findings.append(
                    ctx.finding(
                        self.rule_id,
                        node,
                        f"replay handler for record type {t!r} matches "
                        "no journaled write in the fleet stack — dead "
                        "recovery code, or the writer was removed "
                        "without its handler (a deliberately kept "
                        "back-compat handler belongs in "
                        "RETIRED_RECORD_TYPES)",
                    )
                )
            # the retirement declaration is pinned both ways: a type
            # with a live writer must not hide behind it, and a retired
            # type that loses its handler breaks every journal still in
            # the field
            for t in sorted(retired & set(written)):
                ctx, node = written[t]
                findings.append(
                    ctx.finding(
                        self.rule_id,
                        node,
                        f"record type {t!r} is declared retired in "
                        "serve/recover.py but is still written here — "
                        "a stale retirement hides a real bijection "
                        "break; drop it from RETIRED_RECORD_TYPES",
                    )
                )
            for t in sorted(retired - set(handled)):
                findings.append(
                    recover_ctx.finding(
                        self.rule_id,
                        retired_node or recover_ctx.tree,
                        f"retired record type {t!r} has no replay "
                        "handler — old journals carrying it would "
                        "silently lose acked state on restore; retired "
                        "types keep their handlers forever",
                    )
                )

        # kill points <-> chaos_point call sites, plus _DEFAULT_AT
        if chaos_ctx is not None and declared:
            for p in sorted(set(chaos_calls) - declared):
                ctx, node = chaos_calls[p]
                findings.append(
                    ctx.finding(
                        self.rule_id,
                        node,
                        f"chaos point {p!r} is instrumented here but "
                        "absent from the chaos matrix (KILL_POINTS / "
                        "ENGINE_KILL_POINTS in serve/chaos.py) — a "
                        "crash window no chaos run exercises",
                    )
                )
            for p in sorted(declared - set(chaos_calls)):
                findings.append(
                    chaos_ctx.finding(
                        self.rule_id,
                        declared_node or chaos_ctx.tree,
                        f"kill point {p!r} is declared in the chaos "
                        "matrix but no `chaos_point(...)`/`_chaos(...)` "
                        "call site exists — the matrix would report it "
                        "as 'never fired'",
                    )
                )
            for p in sorted(matrix_points - default_at):
                findings.append(
                    chaos_ctx.finding(
                        self.rule_id,
                        declared_node or chaos_ctx.tree,
                        f"matrix kill point {p!r} has no _DEFAULT_AT "
                        "occurrence calibration",
                    )
                )

        # the moved receipt, both directions: a transport package that
        # only writes (or only consumes) the receipt has lost half of
        # the declared-failover contract
        if moved_writers and not moved_handlers:
            ctx, node = moved_writers[0]
            findings.append(
                ctx.finding(
                    self.rule_id,
                    node,
                    'a {"moved": ...} receipt is written here but no '
                    'client-side handler ("moved" in resp / '
                    '.get("moved")) exists in serve/net — the '
                    "standby's declared refusal would be unfollowable "
                    "and every failover would strand its clients",
                )
            )
        if moved_handlers and not moved_writers:
            ctx, node = moved_handlers[0]
            findings.append(
                ctx.finding(
                    self.rule_id,
                    node,
                    'a "moved"-receipt handler exists here but nothing '
                    'in serve/net writes a {"moved": ...} refusal — '
                    "dead redirect code, or the standby's declared "
                    "refusal was replaced by a silent hangup",
                )
            )
        return findings
