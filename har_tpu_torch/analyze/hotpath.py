"""HL001 — hot-path host-sync: nothing on the dispatch launch path may
make the host wait for the device.

Serialization and scheduling, not compute, dominate distributed-ML
latency (arXiv 1612.01437, PAPERS.md); the analog here is a host
synchronization on the launch path, which stalls the pipelined
dispatch plane (``har_tpu_torch.serve.dispatch``) and erases the
overlap ``FleetConfig.pipeline_depth`` exists to buy.  CUDA launches
are asynchronous: ``launch`` returns an un-synchronised device tensor
and ``fetch`` is where the host is meant to block.

The guarded surface is COMPUTED, not curated: the project call graph's
reachability closure (``analyze.callgraph``) from

  - the LAUNCH ROOTS: every function/method named ``launch`` or
    ``_launch_batch`` — the ``DispatchTicket`` entry points — closed
    over ``self.`` methods (including subclass overrides), typed
    attributes (``self._arena.gather``), locals typed through return
    inference (``scorer = self._get_scorer()``), cross-module imports,
    and closures nested in reached functions (``_attempt_launch``
    handed to ``retry_call``).  Traversal stops at functions named
    ``fetch``/``fetch_fused`` — the allowed sinks, scanned separately;
  - every compiled body: a function decorated with ``torch.compile``
    (or wrapped by name, ``torch.compile(fn)``) and a custom op's fake
    kernel (``@op.register_fake``) — a host read inside a traced body
    either fails on a fake tensor or graph-breaks.  (The closure of
    these bodies through the call graph, and the ``torch.func`` /
    ``torch.export`` / CUDA-graph bodies, is HL006's surface, which
    reuses this module's detectors);
  - every function named ``fetch`` or ``fetch_fused`` (the fused
    hot-loop retire) — the allowed sinks.  Each host-sync line there
    must carry the reviewed ``# harlint: fetch-ok`` annotation, so a
    new sync cannot hide in a fetch body unexamined.

What is flagged:

  - hard syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``
    (device-to-host reads), ``torch.cuda.synchronize()``,
    ``torch.cuda.current_stream().synchronize()`` and
    ``Event.synchronize()`` (any ``.synchronize()`` call, and a bare
    ``synchronize(...)``) — and a blocking host-to-device copy (below);
  - soft syncs: ``np.asarray``/``np.array`` (host materialization of a
    possibly-device value) and ``float()``/``int()`` over a non-trivial
    expression (calls/subscripts/attributes — a device scalar coerced
    on the host; bare-name coercions of scalar locals are not flagged).

On the launch surface ``# harlint: host-ok`` marks a reviewed
conversion of host-origin data (the cast of the host-side scaler's
output before it is placed); it excuses soft syncs only, never a hard
one.  A read whose receiver the call graph PROVES is a host numpy
array (``.tolist()`` on a slice of the pending arena's numpy columns,
on a local built by ``np.asarray``) touches no device and is not a
sync at all: numpy provenance is followed through locals, subscripts,
numpy method chains and class attributes every assignment of which is
a ``np.*`` call.  What the graph cannot prove stays flagged.

The host-to-device decision.  ``.to(device)`` / ``.cuda()`` of a tensor
the graph can prove is host-built (``torch.from_numpy``,
``torch.as_tensor`` / ``torch.tensor`` without a device, or a local
bound only to those) is flagged as a HARD sync unless it passes
``non_blocking=True``: PyTorch copies pageable memory with a
``cudaMemcpyAsync`` followed by a stream synchronize, so the host
waits for every kernel queued ahead of the copy — on the dispatch
stream, the previous batch's forward.  ``DeviceScorer._place``
(``launch``'s one copy in) is such a copy.  A device-to-device
``.to(other_device)`` is not flagged (the receiver is not provably
host-built; those copies do not block the host), nor is a tensor built
directly on a device (``torch.as_tensor(a, device=d)``, run once when
a program is built).  The helpers ``_sync`` / ``_synchronize`` in
dispatch hold ``torch.cuda.synchronize`` and are flagged wherever the
launch closure reaches them; ``measure`` calls them, ``launch`` does
not.
"""

from __future__ import annotations

import ast

from har_tpu_torch.analyze.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    receiver_name,
)

LAUNCH_ROOTS = {"launch", "_launch_batch"}
FETCH_SURFACE = {"fetch", "fetch_fused"}

# device-to-host reads and stream/device/event waits
_HARD_SYNCS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# host-to-device moves that block unless non_blocking=True
_COPY_IN = {"to", "cuda"}
# constructors of a host tensor from host data (without a device=)
_HOST_TENSOR_CTORS = {"from_numpy", "as_tensor", "tensor"}
_NP_NAMES = {"np", "numpy"}
# decorators (and wrap-by-name calls) whose body is compiled or traced
# rather than run per call: HL001 scans these bodies directly
COMPILE_MARKS = {"compile", "register_fake"}
_MAX_DEPTH = 12


def is_compile_marked(node: ast.FunctionDef) -> bool:
    """Decorated with ``torch.compile`` (bare or called) or registered as
    a custom op's fake kernel (``@op.register_fake``,
    ``@torch.library.register_fake(...)``)."""
    for dec in node.decorator_list:
        for sub in ast.walk(dec):
            if isinstance(sub, ast.Attribute) and sub.attr in COMPILE_MARKS:
                return True
            if isinstance(sub, ast.Name) and sub.id in COMPILE_MARKS:
                return True
    return False


def _is_np_call(expr) -> bool:
    f = expr.func if isinstance(expr, ast.Call) else None
    while isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and f.value.id in _NP_NAMES:
            return True
        f = f.value
    return False


def host_array(graph, fi, expr, depth: int = 0) -> bool:
    """True when ``expr`` is provably a host numpy array (or a numpy
    scalar) in function ``fi``: a ``np.*`` call, a subscript or method
    call on one, a local every assignment of which is one, or a
    ``self.``/typed attribute every class-level assignment of which is
    one.  False whenever the proof fails — the caller then flags."""
    if depth > _MAX_DEPTH or graph is None or fi is None:
        return False
    if isinstance(expr, ast.Call):
        if _is_np_call(expr):
            return True
        f = expr.func
        # ndarray methods (.astype, .copy, .reshape, ...) stay on the host
        return isinstance(f, ast.Attribute) and host_array(
            graph, fi, f.value, depth + 1
        )
    if isinstance(expr, ast.Subscript):
        return host_array(graph, fi, expr.value, depth + 1)
    if isinstance(expr, ast.Name):
        holder = fi
        while holder is not None:
            assigns, params = graph._fn_locals(holder)
            if expr.id in assigns:
                vals = [v for v in assigns[expr.id] if v is not expr]
                return bool(vals) and all(
                    host_array(graph, holder, v, depth + 1) for v in vals
                )
            if expr.id in params:
                return False
            holder = (
                graph.functions.get((holder.rel, holder.parent_qual))
                if holder.parent_qual is not None else None
            )
        return False
    if isinstance(expr, ast.Attribute):
        if isinstance(expr.value, ast.Name) and expr.value.id == "self":
            classes = [graph.classes[fi.cls]] if fi.cls is not None else []
        else:
            classes = [
                graph.classes[k]
                for k in graph.expr_types(fi, expr.value, depth + 1)
            ]
        writes = []
        for ci in classes:
            writes.extend(_attr_writes(graph, ci, expr.attr))
        return bool(writes) and all(
            host_array(graph, owner, val, depth + 1) for owner, val in writes
        )
    return False


def _attr_writes(graph, ci, attr: str) -> list:
    """Every ``self.<attr> = value`` of a class and its bases."""
    out, stack, seen = [], [ci], set()
    while stack:
        c = stack.pop()
        if c.key in seen:
            continue
        seen.add(c.key)
        out.extend(c.attr_exprs.get(attr, ()))
        for b in c.base_exprs:
            base = graph._resolve_class_expr(c.ctx.rel, b)
            if base is not None:
                stack.append(base)
    return out


def _host_tensor(graph, fi, expr, depth: int = 0) -> bool:
    """True when ``expr`` is provably a tensor on the host built from host
    data: ``torch.from_numpy(...)``, ``torch.as_tensor`` /
    ``torch.tensor`` without a ``device=``, or a local bound only to
    those."""
    if depth > _MAX_DEPTH:
        return False
    if isinstance(expr, ast.Call):
        name = call_name(expr)
        if name in _HOST_TENSOR_CTORS and isinstance(expr.func, ast.Attribute):
            return not any(k.arg == "device" for k in expr.keywords)
        return False
    if isinstance(expr, ast.Name) and graph is not None and fi is not None:
        assigns, params = graph._fn_locals(fi)
        vals = [v for v in assigns.get(expr.id, ()) if v is not expr]
        return (
            expr.id not in params
            and bool(vals)
            and all(_host_tensor(graph, fi, v, depth + 1) for v in vals)
        )
    return False


def _blocking_copy_in(graph, fi, call: ast.Call) -> bool:
    """``<host tensor>.to(<device>)`` / ``.cuda()`` without
    ``non_blocking=True`` (a dtype-only ``.to(torch.float32)`` is not a
    copy to a device)."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr in _COPY_IN):
        return False
    for k in call.keywords:
        if (
            k.arg == "non_blocking"
            and isinstance(k.value, ast.Constant)
            and k.value.value is True
        ):
            return False
    if f.attr == "to":
        kw = {k.arg for k in call.keywords}
        first = call.args[0] if call.args else None
        dtype_only = (
            first is None and "device" not in kw
        ) or (
            isinstance(first, ast.Attribute)
            and isinstance(first.value, ast.Name)
            and first.value.id == "torch"
            and "device" not in kw
        )
        if dtype_only:
            return False
    return _host_tensor(graph, fi, f.value)


def wrapped_def_nodes(ctx: FileContext, wrappers: set[str]) -> set[int]:
    """AST ``id()``s of the defs wrapped via ``torch.compile(forward)`` /
    ``torch.func.vmap(step)`` — the define-then-wrap-by-name pattern, at
    any nesting level.  The referenced Name is resolved LEXICALLY from
    the wrapping call outward (innermost enclosing scope that binds a
    def of that name wins, then the module), exactly like the
    interpreter would — so an unrelated def merely SHARING the name
    elsewhere in the file is never mistaken for a traced body.  A class
    body is its own namespace: ``step_c = torch.compile(step)`` next to
    ``def step`` in a class body resolves to the member (the
    define-then-wrap-in-class pattern), while functions NESTED inside
    the class resolve through the enclosing function scopes only —
    class namespaces do not participate in closures."""
    out: set[int] = set()
    if not ctx.wrap_calls & wrappers:
        return out

    def shallow(scope: ast.AST):
        # scope's own statements (any block depth): stop at nested
        # def/class boundaries — their interiors are separate scopes
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                stack.extend(ast.iter_child_nodes(node))

    def bound_defs(scope: ast.AST) -> dict[str, ast.AST]:
        defs: dict[str, ast.AST] = {}
        for node in shallow(scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, node)
        return defs

    def visit(scope: ast.AST, env: list[dict[str, ast.AST]]) -> None:
        body_env = env + [bound_defs(scope)]
        # the class namespace is visible to the class BODY only —
        # functions nested in the class close over the enclosing
        # function scopes instead
        child_env = env if isinstance(scope, ast.ClassDef) else body_env
        for sub in shallow(scope):
            if (
                isinstance(sub, ast.Call)
                and call_name(sub) in wrappers
                and sub.args
                and isinstance(sub.args[0], ast.Name)
            ):
                target = sub.args[0].id
                for table in reversed(body_env):
                    if target in table:
                        out.add(id(table[target]))
                        break
            elif isinstance(
                sub,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                visit(sub, child_env)

    visit(ctx.tree, [])
    return out


def scan_syncs(
    rule_id: str,
    ctx: FileContext,
    qual: str,
    node: ast.FunctionDef,
    mode: str,
    where: str,
    *,
    own_statements_only: bool = False,
    reach_note: str = "",
    graph=None,
    fi=None,
) -> list[Finding]:
    """The shared host-sync detectors — HL001 runs them over the launch
    reachability closure, direct compiled bodies and fetch sinks; HL006
    reuses them over the traced-body closure.  ``mode`` selects the
    annotation contract: ``fetch`` (any sync legal WITH ``fetch-ok``),
    ``launch`` (``host-ok`` covers soft conversions only), anything
    else (no annotation escape, only ``disable=``).  ``graph`` and
    ``fi`` (the function's call-graph entry) let a read on a provable
    host numpy array, and a copy in of a provable host tensor, be
    judged by provenance."""
    out: list[Finding] = []

    def flag(sub: ast.AST, what: str, soft: bool) -> None:
        if mode == "fetch":
            if ctx.suppressed(sub, "fetch-ok"):
                ctx.suppression_hits += 1
                return
            msg = (
                f"{what} {where} without the `# harlint: fetch-ok` "
                "annotation — a fetch is the one allowed host-sync "
                "sink, and every sync line in it must be reviewed"
            )
        else:
            if soft and mode == "launch" and ctx.suppressed(sub, "host-ok"):
                ctx.suppression_hits += 1
                return
            msg = (
                f"{what} {where} forces a host sync — the device "
                "idles while the host blocks; move it behind the "
                "retire boundary (or annotate a reviewed "
                "host-origin conversion with `# harlint: host-ok`)"
            )
        out.append(
            Finding(
                rule=rule_id,
                path=ctx.rel,
                line=getattr(sub, "lineno", 1),
                message=msg + reach_note,
                symbol=qual,
                snippet=ctx.snippet(getattr(sub, "lineno", 1)),
            )
        )

    for sub in walk_own(node) if own_statements_only else ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = call_name(sub)
        recv = receiver_name(sub)
        # hard syncs as methods (`t.cpu()`, `torch.cuda.synchronize()`)
        # and the bare `synchronize(...)` of `from torch.cuda import`;
        # a bare `item(...)` / `cpu(...)` is user code, not the method
        if name in _HARD_SYNCS and (
            isinstance(sub.func, ast.Attribute) or name == "synchronize"
        ):
            if (
                name != "synchronize"
                and isinstance(sub.func, ast.Attribute)
                and host_array(graph, fi, sub.func.value)
            ):
                continue  # a numpy array's own method: no device
            flag(sub, f"`.{name}()`", soft=False)
        elif _blocking_copy_in(graph, fi, sub):
            flag(
                sub,
                f"blocking host-to-device `.{name}(...)` (no "
                "`non_blocking=True`; the pageable copy waits for the "
                "stream)",
                soft=False,
            )
        elif name in ("asarray", "array") and recv in _NP_NAMES:
            flag(sub, f"`np.{name}(...)`", soft=True)
        elif (
            isinstance(sub.func, ast.Name)
            and sub.func.id in ("float", "int")
            and len(sub.args) == 1
            and isinstance(
                sub.args[0], (ast.Call, ast.Subscript, ast.Attribute)
            )
        ):
            flag(sub, f"`{sub.func.id}(...)` on a computed value",
                 soft=True)
    return out


def walk_own(node: ast.FunctionDef):
    """ast.walk that does NOT descend into nested function defs — for
    scanning a function's own statements when its closures are separate
    graph nodes (HL006's per-function pass)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        yield sub
        if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(sub))


class HotPathRule(Rule):
    rule_id = "HL001"
    title = "hot-path host-sync"

    def finalize(self, ctxs: list[FileContext]) -> list[Finding]:
        from har_tpu_torch.analyze.core import Project

        project = self.project or Project(ctxs)
        graph = project.callgraph

        launch_roots = [
            fi for fi in graph.functions.values() if fi.name in LAUNCH_ROOTS
        ]
        # the launch surface ends at fetch sinks (scanned separately)
        reach = graph.reachable(
            launch_roots, stop=lambda fi: fi.name in FETCH_SURFACE
        )

        findings: list[Finding] = []
        for key, (parent, root) in reach.items():
            fi = graph.functions[key]
            if fi.ctx.support:
                # subset run: the closure traverses support files (the
                # roots and edges live there) but only requested files
                # are examined
                continue
            note = ""
            if parent is not None:
                chain = graph.chain(reach, key)
                note = (
                    "  [reached from launch root `"
                    + chain[0]
                    + "` via "
                    + " -> ".join(f"`{q}`" for q in chain[1:])
                    + "]"
                )
            # own statements only: a reached function's nested defs are
            # separate entries in the closure (scanning both the parent
            # walk and the nested node would double-flag)
            findings.extend(
                scan_syncs(
                    self.rule_id, fi.ctx, fi.qual, fi.node, "launch",
                    "on the dispatch launch path",
                    own_statements_only=True,
                    reach_note=note,
                    graph=graph,
                    fi=fi,
                )
            )

        # direct compiled bodies (decorator or wrap-by-name), launch surface
        # taking precedence when both apply; their call-graph closure
        # is HL006's surface
        for ctx in ctxs:
            if ctx.support:
                continue
            compiled = wrapped_def_nodes(ctx, COMPILE_MARKS)
            for fi in graph.functions.values():
                if fi.rel != ctx.rel or fi.key in reach:
                    continue
                if fi.name in FETCH_SURFACE:
                    findings.extend(
                        scan_syncs(
                            self.rule_id, ctx, fi.qual, fi.node, "fetch",
                            "in a retire-side fetch",
                            graph=graph, fi=fi,
                        )
                    )
                elif is_compile_marked(fi.node) or id(fi.node) in compiled:
                    # nested scans would double-count: a compiled def
                    # nested under another compiled def is
                    # already covered by the outer walk.  Ancestors are
                    # the proper dotted prefixes of the qualname (class
                    # segments simply miss the function table)
                    parts = fi.qual.split(".")
                    if fi.parent_qual is not None and any(
                        (g := graph.functions.get(
                            (fi.rel, ".".join(parts[:i]))
                        )) is not None
                        and (
                            is_compile_marked(g.node)
                            or id(g.node) in compiled
                        )
                        for i in range(1, len(parts))
                    ):
                        continue
                    findings.extend(
                        scan_syncs(
                            self.rule_id, ctx, fi.qual, fi.node, "traced",
                            "inside a compiled body",
                            graph=graph, fi=fi,
                        )
                    )
        return findings
