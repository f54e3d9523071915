"""Project-wide call graph: the cross-module layer under harlint.

A hot-path rule that checks a hand-listed set of names closed over
same-class ``self.`` calls misses a host sync TWO calls below
``launch`` (say, inside a scorer constructor reached through
``_get_scorer`` → ``make_scorer``).  Hidden host and serialization
stalls are what dominate distributed-ML latency (arXiv 1612.01437), so
the guarded surface must be *computed*, not curated.

This module computes it.  From the lint fileset's parsed ASTs it
builds:

  - a **function table** — every def/method across the fileset, keyed
    ``(repo-relative-path, dotted-qualname)``, with its true enclosing
    class (nested defs record their class, not their parent function);
  - an **import map** per module — ``from har_tpu_torch.serve.dispatch
    import make_scorer`` and ``import har_tpu_torch.serving as s`` both
    resolve to nodes in other files (one re-export hop through
    ``__init__`` is followed);
  - a **class table** with resolved bases, so method lookup walks the
    MRO *and* the overriding subclasses (a ``self._place()`` inside
    ``DeviceScorer.launch`` reaches ``ShardedScorer._place`` too —
    the receiver may be the subclass);
  - a small **type-inference lattice**: the candidate project classes
    of an expression.  ``self._arena = StagingArena(...)`` types the
    attribute; ``scorer = self._get_scorer()`` follows the method's
    ``return`` expressions into ``make_scorer`` and unions the classes
    it can construct — so ``scorer.pad(...)`` resolves to all three
    scorer families.  The lattice is deliberately an over-approximation
    (a lint wants reachability to be sound-ish, not minimal) and gives
    up — resolving to nothing — on receivers it cannot type.

``reachable(roots)`` is then a plain BFS that also pulls in functions
*nested* under a reached function (closures handed to ``retry_call``
or ``torch.func.vmap`` execute as part of their parent).  Rules
consume the graph through ``core.Project``, so one build serves HL001,
HL006 and HL007.

Pure stdlib (``ast`` only), like everything in
``har_tpu_torch.analyze``: the release gate runs this without importing
torch, inside the lint budget the gate enforces.  Modules are named from
their repo-relative paths, so ``from har_tpu_torch.serve import engine``
resolves against the files under ``har_tpu_torch/`` as the interpreter
would.
"""

from __future__ import annotations

import ast

from har_tpu_torch.analyze.core import FileContext, call_name

# Expression-type recursion cap (cycles give up, not hang).  The
# flagship chain — `scorer = self._get_scorer()` -> return self._scorer
# -> attr expr `make_scorer(...)` -> return `DeviceScorer()` — costs 7
# levels; 16 leaves headroom for one more indirection hop without
# letting a pathological chain walk forever.
_MAX_DEPTH = 16


class FuncInfo:
    """One function/method definition in the fileset."""

    __slots__ = ("ctx", "rel", "qual", "name", "cls", "node", "parent_qual")

    def __init__(self, ctx, qual, name, cls, node, parent_qual):
        self.ctx = ctx
        self.rel = ctx.rel
        self.qual = qual
        self.name = name
        self.cls = cls  # enclosing ClassInfo key (rel, class qual) or None
        self.node = node
        self.parent_qual = parent_qual  # enclosing function qual or None

    @property
    def key(self):
        return (self.rel, self.qual)

    def __repr__(self):  # debugging aid only
        return f"<fn {self.rel}::{self.qual}>"


class ClassInfo:
    """One class definition: methods, raw base expressions, attr writes."""

    __slots__ = ("ctx", "rel", "qual", "name", "node", "base_exprs",
                 "methods", "attr_exprs")

    def __init__(self, ctx, qual, node):
        self.ctx = ctx
        self.rel = ctx.rel
        self.qual = qual
        self.name = node.name
        self.node = node
        self.base_exprs = list(node.bases)
        self.methods: dict[str, FuncInfo] = {}
        # attr name -> [(FuncInfo of the assigning method, value expr)]
        self.attr_exprs: dict[str, list] = {}

    @property
    def key(self):
        return (self.rel, self.qual)


def _module_name(rel: str) -> str:
    """repo-relative path -> dotted module
    (har_tpu_torch/serve/__init__.py -> har_tpu_torch.serve)."""
    mod = rel[:-3] if rel.endswith(".py") else rel
    parts = mod.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _Module:
    __slots__ = ("ctx", "rel", "functions", "classes", "imports", "consts")

    def __init__(self, ctx):
        self.ctx = ctx
        self.rel = ctx.rel
        self.functions: dict[str, FuncInfo] = {}  # top-level name -> info
        self.classes: dict[str, ClassInfo] = {}   # top-level name -> info
        # alias -> ("mod", dotted) | ("sym", dotted, original_name)
        self.imports: dict[str, tuple] = {}
        self.consts: dict[str, str] = {}  # module-level string constants


class CallGraph:
    """Functions, classes, imports and resolved call edges for a fileset."""

    def __init__(self, ctxs: list[FileContext]):
        self.functions: dict[tuple, FuncInfo] = {}
        self.classes: dict[tuple, ClassInfo] = {}
        self.modules: dict[str, _Module] = {}       # dotted name -> module
        self._mod_by_rel: dict[str, _Module] = {}
        self._subclasses: dict[tuple, list[ClassInfo]] = {}
        self._edges: dict[tuple, list] = {}         # fn key -> [(call, [FuncInfo])]
        self._locals: dict[tuple, dict] = {}        # fn key -> {name: [exprs]}
        self._params: dict[tuple, set] = {}         # fn key -> param names
        self._returns: dict[tuple, object] = {}     # fn key -> memoized types
        self._capped = False  # a depth-capped computation is incomplete
        for ctx in ctxs:
            self._index_module(ctx)
        self._resolve_bases()

    # ------------------------------------------------------------ build

    def _index_module(self, ctx: FileContext) -> None:
        mod = _Module(ctx)
        dotted = _module_name(ctx.rel)
        self.modules[dotted] = mod
        self._mod_by_rel[ctx.rel] = mod

        for node in ctx.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Constant
            ) and isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        mod.consts[t.id] = node.value.value

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = (
                        ("mod", a.name) if a.asname
                        else ("mod", a.name.split(".")[0])
                    )
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:  # relative: resolve against this package
                    pkg = dotted.split(".")
                    if not ctx.rel.endswith("__init__.py"):
                        pkg = pkg[:-1]  # the module's own leaf name
                    pkg = pkg[: len(pkg) - (node.level - 1)]
                    base = ".".join(pkg + ([node.module] if node.module else []))
                for a in node.names:
                    mod.imports[a.asname or a.name] = ("sym", base, a.name)

        # functions + classes, with true class context (class frames only)
        def visit(node, qual_stack, cls_key, fn_qual):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = ".".join(qual_stack + [child.name])
                    fi = FuncInfo(ctx, qual, child.name, cls_key, child,
                                  fn_qual)
                    self.functions[fi.key] = fi
                    if cls_key is not None and fn_qual is None:
                        self.classes[cls_key].methods.setdefault(
                            child.name, fi
                        )
                    if fn_qual is None and cls_key is None:
                        mod.functions.setdefault(child.name, fi)
                    visit(child, qual_stack + [child.name], cls_key, qual)
                elif isinstance(child, ast.ClassDef):
                    cqual = ".".join(qual_stack + [child.name])
                    ci = ClassInfo(ctx, cqual, child)
                    self.classes[ci.key] = ci
                    if fn_qual is None and not qual_stack:
                        mod.classes.setdefault(child.name, ci)
                    visit(child, qual_stack + [child.name], ci.key, None)
                else:
                    visit(child, qual_stack, cls_key, fn_qual)

        visit(ctx.tree, [], None, None)

        # self.<attr> = <expr> writes, per class
        for fi in list(self.functions.values()):
            if fi.rel != ctx.rel or fi.cls is None:
                continue
            ci = self.classes[fi.cls]
            for sub in ast.walk(fi.node):
                if not isinstance(sub, ast.Assign):
                    continue
                for t in sub.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        ci.attr_exprs.setdefault(t.attr, []).append(
                            (fi, sub.value)
                        )

    def _resolve_bases(self) -> None:
        for ci in self.classes.values():
            for b in ci.base_exprs:
                base = self._resolve_class_expr(ci.ctx.rel, b)
                if base is not None:
                    self._subclasses.setdefault(base.key, []).append(ci)

    def _resolve_class_expr(self, rel: str, expr) -> ClassInfo | None:
        if isinstance(expr, ast.Name):
            got = self.resolve_symbol(rel, expr.id)
            if isinstance(got, ClassInfo):
                return got
        elif isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ):
            got = self.resolve_symbol(rel, expr.value.id)
            if isinstance(got, _Module):
                return got.classes.get(expr.attr)
        return None

    # -------------------------------------------------------- resolution

    def resolve_symbol(self, rel: str, name: str, _seen=None):
        """A top-level name in module ``rel`` -> FuncInfo | ClassInfo |
        _Module | str-constant | None.  Follows one import hop (plus
        one re-export hop through a package ``__init__``)."""
        mod = self._mod_by_rel.get(rel)
        if mod is None:
            return None
        if name in mod.functions:
            return mod.functions[name]
        if name in mod.classes:
            return mod.classes[name]
        if name in mod.consts:
            return mod.consts[name]
        target = mod.imports.get(name)
        if target is None:
            return None
        _seen = _seen or set()
        if (rel, name) in _seen:
            return None
        _seen.add((rel, name))
        if target[0] == "mod":
            return self.modules.get(target[1])
        dotted, orig = target[1], target[2]
        tmod = self.modules.get(dotted)
        if tmod is None:
            # `from har_tpu_torch.serve import engine` — the symbol may be a
            # submodule rather than a name inside __init__
            return self.modules.get(f"{dotted}.{orig}")
        got = self.resolve_symbol(tmod.rel, orig, _seen)
        if got is None:
            return self.modules.get(f"{dotted}.{orig}")
        return got

    def resolve_const(self, rel: str, name: str) -> str | None:
        """Module-level string constant by name, following imports —
        HL007 resolves ``P(None, TP_AXIS)`` through this."""
        got = self.resolve_symbol(rel, name)
        return got if isinstance(got, str) else None

    # MRO-ish method lookup: own class, then bases depth-first; with
    # virtual=True the overriding subclasses join (the receiver may be
    # any subclass instance)
    def lookup_method(
        self, ci: ClassInfo, name: str, virtual: bool = True
    ) -> list[FuncInfo]:
        out, seen = [], set()

        def mro(c: ClassInfo):
            if c.key in seen:
                return None
            seen.add(c.key)
            if name in c.methods:
                return c.methods[name]
            for b in c.base_exprs:
                base = self._resolve_class_expr(c.ctx.rel, b)
                if base is not None:
                    got = mro(base)
                    if got is not None:
                        return got
            return None

        got = mro(ci)
        if got is not None:
            out.append(got)
        if virtual:
            stack, visited = [ci], set()
            while stack:
                c = stack.pop()
                if c.key in visited:
                    continue
                visited.add(c.key)
                for sub in self._subclasses.get(c.key, ()):
                    if name in sub.methods:
                        out.append(sub.methods[name])
                    stack.append(sub)
        uniq, keys = [], set()
        for fi in out:
            if fi.key not in keys:
                keys.add(fi.key)
                uniq.append(fi)
        return uniq

    # ---------------------------------------------------- type inference

    def _fn_locals(self, fi: FuncInfo) -> tuple[dict, set]:
        if fi.key not in self._locals:
            assigns: dict[str, list] = {}
            for sub in ast.walk(fi.node):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            assigns.setdefault(t.id, []).append(sub.value)
                elif isinstance(sub, ast.AnnAssign) and isinstance(
                    sub.target, ast.Name
                ) and sub.value is not None:
                    assigns.setdefault(sub.target.id, []).append(sub.value)
            a = fi.node.args
            params = {
                p.arg
                for p in (
                    a.posonlyargs + a.args + a.kwonlyargs
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else [])
                )
            }
            self._locals[fi.key] = assigns
            self._params[fi.key] = params
        return self._locals[fi.key], self._params[fi.key]

    def expr_types(self, fi: FuncInfo, expr, depth: int = 0) -> set:
        """Candidate project-class keys an expression may evaluate to."""
        if depth > _MAX_DEPTH:
            self._capped = True  # truncated, not resolved-to-nothing
            return set()
        if expr is None:
            return set()
        if isinstance(expr, ast.Call):
            out = set()
            for target in self._resolve_callee(fi, expr, depth + 1):
                if isinstance(target, ClassInfo):
                    out.add(target.key)
                elif isinstance(target, FuncInfo):
                    out |= self.return_types(target, depth + 1)
            return out
        if isinstance(expr, ast.Name):
            # own locals, then each enclosing function's (closure
            # capture: `scorer` inside `_attempt` is `_launch_batch`'s
            # local), then module scope
            holder = fi
            while holder is not None:
                assigns, params = self._fn_locals(holder)
                if expr.id in assigns:
                    out = set()
                    for val in assigns[expr.id]:
                        if val is not expr:
                            out |= self.expr_types(holder, val, depth + 1)
                    return out
                if expr.id in params:
                    return set()
                holder = (
                    self.functions.get((holder.rel, holder.parent_qual))
                    if holder.parent_qual is not None
                    else None
                )
            got = self.resolve_symbol(fi.rel, expr.id)
            return {got.key} if isinstance(got, ClassInfo) else set()
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                if fi.cls is not None:
                    return self._attr_types(
                        self.classes[fi.cls], expr.attr, depth
                    )
                return set()
            out = set()
            for ckey in self.expr_types(fi, expr.value, depth + 1):
                out |= self._attr_types(self.classes[ckey], expr.attr, depth)
            return out
        if isinstance(expr, ast.BoolOp):
            out = set()
            for v in expr.values:
                out |= self.expr_types(fi, v, depth + 1)
            return out
        if isinstance(expr, ast.IfExp):
            return self.expr_types(fi, expr.body, depth + 1) | self.expr_types(
                fi, expr.orelse, depth + 1
            )
        return set()

    def _attr_types(self, ci: ClassInfo, attr: str, depth: int) -> set:
        out, stack, seen = set(), [ci], set()
        while stack:  # own class + bases contribute attr assignments
            c = stack.pop()
            if c.key in seen:
                continue
            seen.add(c.key)
            for owner_fi, val in c.attr_exprs.get(attr, ()):
                out |= self.expr_types(owner_fi, val, depth + 1)
            for b in c.base_exprs:
                base = self._resolve_class_expr(c.ctx.rel, b)
                if base is not None:
                    stack.append(base)
        return out

    def return_types(self, fi: FuncInfo, depth: int = 0) -> set:
        memo = self._returns.get(fi.key)
        if memo == "busy":  # recursion cycle: give up on this branch
            return set()
        if memo is not None:
            return memo
        self._returns[fi.key] = "busy"
        outer_capped = self._capped
        self._capped = False
        out = set()
        for sub in ast.walk(fi.node):
            if isinstance(sub, ast.Return) and sub.value is not None:
                out |= self.expr_types(fi, sub.value, depth + 1)
        if self._capped:
            # the walk hit the depth cap: `out` is a truncation artifact
            # of THIS query's starting depth, not this function's return
            # types — memoizing it would poison every shallower query
            del self._returns[fi.key]
        else:
            self._returns[fi.key] = out
        self._capped = self._capped or outer_capped
        return out

    # --------------------------------------------------------- call edges

    def _resolve_callee(
        self, fi: FuncInfo, call: ast.Call, depth: int = 0
    ) -> list:
        """FuncInfo/ClassInfo targets of one call expression.

        ``depth`` continues the calling type query's depth budget: a
        receiver-type resolution spawned from inside ``expr_types``
        must NOT restart at zero, or two modules whose type lattices
        reference each other (e.g. the serve.dispatch ↔ quantize int8
        tier) recurse past the interpreter limit instead of truncating
        at ``_MAX_DEPTH`` like every other deep chain."""
        f = call.func
        if isinstance(f, ast.Name):
            # lexical scoping: own nested defs first, then each
            # enclosing function's, then module scope
            scope = fi.qual
            while scope is not None:
                cand = self.functions.get((fi.rel, f"{scope}.{f.id}"))
                if cand is not None:
                    return [cand]
                holder = self.functions.get((fi.rel, scope))
                scope = holder.parent_qual if holder is not None else None
            got = self.resolve_symbol(fi.rel, f.id)
            return [got] if isinstance(got, (FuncInfo, ClassInfo)) else []
        if not isinstance(f, ast.Attribute):
            return []
        recv = f.value
        if isinstance(recv, ast.Name):
            if recv.id == "self" and fi.cls is not None:
                return self.lookup_method(self.classes[fi.cls], f.attr)
            got = self.resolve_symbol(fi.rel, recv.id)
            if isinstance(got, _Module):
                fn = got.functions.get(f.attr)
                if fn is not None:
                    return [fn]
                cls = got.classes.get(f.attr)
                return [cls] if cls is not None else []
            if isinstance(got, ClassInfo):
                return self.lookup_method(got, f.attr, virtual=False)
        out = []
        for ckey in self.expr_types(fi, recv, depth + 1):
            out.extend(self.lookup_method(self.classes[ckey], f.attr))
        uniq, keys = [], set()
        for t in out:
            if t.key not in keys:
                keys.add(t.key)
                uniq.append(t)
        return uniq

    def calls_from(self, fi: FuncInfo) -> list:
        """Cached ``(call_node, [FuncInfo targets])`` for one function,
        excluding calls that belong to functions nested inside it (they
        get their own node in the graph)."""
        if fi.key not in self._edges:
            edges = []
            nested_spans = [
                sub for sub in ast.walk(fi.node)
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                and sub is not fi.node
            ]

            def in_nested(node):
                return any(
                    n.lineno <= getattr(node, "lineno", 0)
                    and getattr(node, "end_lineno", 0)
                    <= (n.end_lineno or n.lineno)
                    and n is not node
                    for n in nested_spans
                )

            for sub in ast.walk(fi.node):
                if isinstance(sub, ast.Call) and not in_nested(sub):
                    targets = [
                        t
                        for t in self._resolve_callee(fi, sub)
                        if isinstance(t, FuncInfo)
                        or isinstance(t, ClassInfo)
                    ]
                    # constructor call: edge into __init__
                    expanded = []
                    for t in targets:
                        if isinstance(t, ClassInfo):
                            init = self.lookup_method(
                                t, "__init__", virtual=False
                            )
                            expanded.extend(init)
                        else:
                            expanded.append(t)
                    if expanded:
                        edges.append((sub, expanded))
            self._edges[fi.key] = edges
        return self._edges[fi.key]

    def nested_under(self, fi: FuncInfo) -> list[FuncInfo]:
        prefix = fi.qual + "."
        return [
            g
            for g in self.functions.values()
            if g.rel == fi.rel and g.qual.startswith(prefix)
        ]

    def reachable(self, roots, stop=None) -> dict:
        """BFS closure: ``fn key -> (parent key | None, root key)``.

        ``stop(fi)`` prunes traversal INTO a target (the function is
        not added and not expanded) — HL001 uses it to end the launch
        surface at ``fetch`` sinks, which are scanned separately.
        Nested defs ride with their parent (closures run inside it).
        """
        out: dict = {}
        queue = []
        for fi in roots:
            if fi.key not in out:
                out[fi.key] = (None, fi.key)
                queue.append((fi, fi.key))
        while queue:
            fi, root = queue.pop(0)
            for g in self.nested_under(fi):
                if g.key not in out and not (stop and stop(g)):
                    out[g.key] = (fi.key, root)
                    queue.append((g, root))
            for _call, targets in self.calls_from(fi):
                for t in targets:
                    if t.key in out or (stop and stop(t)):
                        continue
                    out[t.key] = (fi.key, root)
                    queue.append((t, root))
        return out

    def chain(self, reach: dict, key) -> list:
        """Qualname path root → … → key for a ``reachable`` result."""
        names, cur, seen = [], key, set()
        while cur is not None and cur not in seen:
            seen.add(cur)
            names.append(self.functions[cur].qual)
            cur = reach[cur][0]
        return list(reversed(names))
