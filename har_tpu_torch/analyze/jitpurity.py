"""HL006 — trace purity: everything a traced body can reach must be
pure.

PyTorch traces a function instead of running it in four places the
port uses or may use: ``torch.export.export`` runs a module's
``forward`` once on fake tensors and keeps the graph; ``torch.compile``
captures a body into a graph and replays it; the ``torch.func``
transforms (``vmap``, ``grad``, ``jacrev``, ...) run the body under a
functional transform; a CUDA graph (``with torch.cuda.graph(g):``,
``make_graphed_callables``) records the kernels once and replays them.
A custom op's fake kernel (``@op.register_fake``) runs only while
tracing.  Any side effect in such a closure fires at trace time only:

  - **mutating closed-over state** (``self.hits += 1``, appending to a
    captured list, ``global``/``nonlocal`` writes): once per trace, not
    once per call; counters silently freeze, caches silently corrupt;
  - **wall-clock reads** (``time.time()``, ``perf_counter()``): the
    trace-time value is baked into the graph;
  - **print / logging**: executes during trace only, then vanishes;
  - **host fetches** (``.item()``, ``.cpu()``, ``np.asarray`` of a
    tensor, ``torch.cuda.synchronize``): a fake tensor cannot be read,
    and a CUDA graph cannot capture a synchronize — the same detectors
    as HL001 (``hotpath.scan_syncs``), applied through the call graph.

The traced roots are: defs decorated with ``torch.compile`` or
registered as fake kernels, and defs wrapped by name
(``torch.compile(fn)``); defs handed by name to a ``torch.func``
transform or ``make_graphed_callables``, or so decorated; the
``forward`` of every class the call graph types the first argument of
a ``torch.export.export(...)`` call as; and every project function
called inside a ``with torch.cuda.graph(...)`` block.  The surface is
their call-graph reachability closure (``analyze.callgraph``).  The
syncs of a compiled body itself stay HL001's findings; this rule owns
the purity checks everywhere in the closure and the sync detectors for
everything deeper than the compiled body.

Over the default fileset the port's traced bodies live elsewhere
(``export.py``, ``ops/flash_attention.py``), so the rule may find
nothing there; its fixtures prove that it fires.
"""

from __future__ import annotations

import ast

from har_tpu_torch.analyze.core import FileContext, Finding, Rule, call_name
from har_tpu_torch.analyze.hotpath import (
    COMPILE_MARKS,
    is_compile_marked,
    scan_syncs,
    walk_own,
    wrapped_def_nodes,
)

# torch.func transforms and CUDA-graph capture of a callable, by name
_TRACE_WRAPPERS = {
    "vmap", "grad", "grad_and_value", "jacrev", "jacfwd", "hessian",
    "functionalize", "make_graphed_callables",
}
_CLOCK_ATTRS = {"time", "monotonic", "perf_counter", "process_time"}
_LOG_RECEIVERS = {"logging", "log", "logger", "_log", "_logger"}
# a receiver merely NAMED `log` may be a list — only the logging verbs
# route to the logging finding; `.append` et al. stay container mutation
_LOG_METHODS = {
    "debug", "info", "warning", "warn", "error", "exception",
    "critical", "log",
}
# conservative mutating-method set for closed-over containers; `update`
# is deliberately absent (an optimizer's or a dict's functional
# `update` idioms are common inside traced bodies)
_MUTATORS = {
    "append", "extend", "insert", "pop", "popleft", "clear",
    "remove", "discard", "add", "setdefault",
}


def _trace_marked(node) -> bool:
    """A def decorated with a torch.func transform (``@torch.func.vmap``,
    ``@vmap``)."""
    for dec in node.decorator_list:
        for sub in ast.walk(dec):
            if isinstance(sub, ast.Attribute) and sub.attr in _TRACE_WRAPPERS:
                return True
            if isinstance(sub, ast.Name) and sub.id in _TRACE_WRAPPERS:
                return True
    return False


def _enclosing(graph, rel: str, node) -> object | None:
    """The innermost function of ``rel`` whose span holds ``node``."""
    best, line = None, getattr(node, "lineno", 0)
    for fi in graph.functions.values():
        if fi.rel != rel:
            continue
        n = fi.node
        if n.lineno <= line <= (n.end_lineno or n.lineno) and (
            best is None or n.lineno >= best.node.lineno
        ):
            best = fi
    return best


def _is_export_call(call: ast.Call, ctx: FileContext) -> bool:
    """``torch.export.export(...)`` / ``export.export(...)``, or a bare
    ``export(...)`` imported from ``torch.export``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        v = f.value
        return f.attr == "export" and (
            (isinstance(v, ast.Attribute) and v.attr == "export")
            or (isinstance(v, ast.Name) and v.id == "export")
        )
    if isinstance(f, ast.Name) and f.id == "export":
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "torch.export":
                if any(a.name == "export" and (a.asname or a.name) == "export"
                       for a in node.names):
                    return True
    return False


def _is_cuda_graph_with(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g):`` (or ``cuda.graph`` / ``graph``
    from ``torch.cuda``)."""
    e = item.context_expr
    return (
        isinstance(e, ast.Call)
        and isinstance(e.func, ast.Attribute)
        and e.func.attr == "graph"
        and (
            (isinstance(e.func.value, ast.Attribute)
             and e.func.value.attr == "cuda")
            or (isinstance(e.func.value, ast.Name)
                and e.func.value.id == "cuda")
        )
    )


def traced_roots(graph, ctxs) -> tuple[list, set]:
    """``(roots, compiled)``: the traced roots of the fileset, and the keys
    of the compiled bodies (and their nested defs) whose own syncs
    HL001 scans."""
    from har_tpu_torch.analyze.callgraph import ClassInfo, FuncInfo

    roots, compiled = [], set()
    for ctx in ctxs:
        compiled_nodes = wrapped_def_nodes(ctx, COMPILE_MARKS)
        traced_nodes = wrapped_def_nodes(ctx, _TRACE_WRAPPERS)
        for fi in graph.functions.values():
            if fi.rel != ctx.rel:
                continue
            compiled_root = (
                is_compile_marked(fi.node) or id(fi.node) in compiled_nodes
            )
            if compiled_root:
                compiled.add(fi.key)
                for g in graph.nested_under(fi):
                    compiled.add(g.key)
            if (
                compiled_root
                or id(fi.node) in traced_nodes
                or _trace_marked(fi.node)
            ):
                roots.append(fi)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and node.args and _is_export_call(
                node, ctx
            ):
                holder = _enclosing(graph, ctx.rel, node)
                if holder is None:
                    continue
                for ckey in graph.expr_types(holder, node.args[0]):
                    roots.extend(
                        graph.lookup_method(graph.classes[ckey], "forward")
                    )
            elif isinstance(node, ast.With) and any(
                _is_cuda_graph_with(it) for it in node.items
            ):
                holder = _enclosing(graph, ctx.rel, node)
                if holder is None:
                    continue
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if not isinstance(sub, ast.Call):
                            continue
                        for t in graph._resolve_callee(holder, sub):
                            if isinstance(t, ClassInfo):
                                roots.extend(graph.lookup_method(
                                    t, "__init__", virtual=False))
                            elif isinstance(t, FuncInfo):
                                roots.append(t)
    return roots, compiled


def _bound_names(t):
    """Names a binding target BINDS — the Name/Tuple/Starred structure
    only.  The base of a Subscript/Attribute target (``d[k] = v``,
    ``obj.x = v``) is a MUTATION of an existing object, not a binding:
    walking into it would classify a closed-over dict as local and mask
    the very write this rule exists to flag."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, ast.Starred):
        yield from _bound_names(t.value)
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _bound_names(e)


class JitPurityRule(Rule):
    rule_id = "HL006"
    title = "trace purity"

    def finalize(self, ctxs: list[FileContext]) -> list[Finding]:
        from har_tpu_torch.analyze.core import Project

        project = self.project or Project(ctxs)
        graph = project.callgraph

        roots, compiled = traced_roots(graph, ctxs)
        reach = graph.reachable(roots)
        findings: list[Finding] = []
        for key, (parent, root) in reach.items():
            fi = graph.functions[key]
            if fi.ctx.support:
                # subset run: traced roots and call edges in support
                # files still shape the closure, but only requested
                # files' bodies are scanned
                continue
            chain = graph.chain(reach, key)
            note = (
                ""
                if len(chain) == 1
                else (
                    "  [traced via "
                    + " -> ".join(f"`{q}`" for q in chain)
                    + "]"
                )
            )
            findings.extend(self._purity_scan(fi, note))
            if key not in compiled:
                findings.extend(
                    scan_syncs(
                        self.rule_id, fi.ctx, fi.qual, fi.node, "traced",
                        "inside a traced (export/compile/torch.func/"
                        "CUDA-graph) closure",
                        own_statements_only=True,
                        reach_note=note,
                        graph=graph,
                        fi=fi,
                    )
                )
        return findings

    # ------------------------------------------------------------ purity

    def _purity_scan(self, fi, note: str) -> list[Finding]:
        ctx, node = fi.ctx, fi.node
        # statement-bound names: assignments, loop targets, withitems,
        # comprehension vars, nested def/class names.  Containers BOUND
        # here are this trace's own values — mutating them is fine;
        # containers that arrive as parameters are the caller's, and
        # mutating those is the same trace-time-only trap as a closure.
        bound: set[str] = set()
        for sub in walk_own(node):
            targets = []
            if isinstance(sub, ast.Assign):
                targets = sub.targets
            elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
                targets = [sub.target]
            elif isinstance(sub, ast.For):
                targets = [sub.target]
            elif isinstance(sub, ast.withitem) and sub.optional_vars:
                targets = [sub.optional_vars]
            elif isinstance(sub, ast.comprehension):
                targets = [sub.target]
            elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                bound.add(sub.name)
                continue
            for t in targets:
                bound.update(_bound_names(t))

        out: list[Finding] = []

        def flag(sub, msg):
            # no in-rule disable= check: run_rules' _apply_disable owns
            # the generic suppression for every rule, so HL006 gets the
            # same placement semantics (finding line or the comment-only
            # line above) as the other seven
            line = getattr(sub, "lineno", 1)
            out.append(
                Finding(
                    rule=self.rule_id,
                    path=ctx.rel,
                    line=line,
                    message=msg + note,
                    symbol=fi.qual,
                    snippet=ctx.snippet(line),
                )
            )

        for sub in walk_own(node):
            if isinstance(sub, (ast.Global, ast.Nonlocal)):
                flag(
                    sub,
                    f"`{type(sub).__name__.lower()}` write inside a traced "
                    "body — the mutation fires at trace time only "
                    "(once per trace, not once per call); return the "
                    "value instead",
                )
            elif isinstance(sub, (ast.Assign, ast.AugAssign)):
                targets = (
                    sub.targets if isinstance(sub, ast.Assign)
                    else [sub.target]
                )
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        flag(
                            sub,
                            f"assignment to `self.{t.attr}` inside a "
                            "traced body — the graph replays the "
                            "captured computation, so the attribute "
                            "updates at trace time only (a silently-"
                            "frozen counter/cache); mutate outside the "
                            "traced fn or return the value",
                        )
                    elif isinstance(t, ast.Subscript):
                        base = t.value
                        while isinstance(base, (ast.Subscript,
                                                ast.Attribute)):
                            base = base.value
                        if (
                            isinstance(base, ast.Name)
                            and base.id not in bound
                        ):
                            flag(
                                sub,
                                f"subscript write into closed-over "
                                f"`{base.id}` inside a traced body — "
                                "in-place mutation of captured state "
                                "fires at trace time only (a numpy or "
                                "dict closure silently corrupts); "
                                "return a new value instead",
                            )
            elif isinstance(sub, ast.Call):
                name = call_name(sub)
                f = sub.func
                if isinstance(f, ast.Name) and f.id == "print":
                    flag(
                        sub,
                        "`print(...)` inside a traced body executes at "
                        "trace time only (once per trace) — log "
                        "outside the traced fn",
                    )
                elif (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "time"
                    and f.attr in _CLOCK_ATTRS
                ):
                    flag(
                        sub,
                        f"`time.{f.attr}()` inside a traced body is "
                        "baked in at trace time — every replayed call "
                        "sees the trace-time clock; measure outside "
                        "the traced fn",
                    )
                elif (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in _LOG_RECEIVERS
                    and f.attr in _LOG_METHODS
                ):
                    flag(
                        sub,
                        f"`{f.value.id}.{f.attr}(...)` inside a traced "
                        "body executes at trace time only — log outside "
                        "the traced fn",
                    )
                elif (
                    isinstance(f, ast.Attribute)
                    and name in _MUTATORS
                    and isinstance(f.value, ast.Name)
                    and f.value.id not in bound
                    and f.value.id != "self"
                ):
                    flag(
                        sub,
                        f"`.{name}(...)` on closed-over `{f.value.id}` "
                        "inside a traced body — container mutation "
                        "fires at trace time only; return the value "
                        "instead",
                    )
        return out
