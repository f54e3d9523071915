"""HL007 — placement coverage: every placement in the parallel package
is declared for each input and output, every axis a ``PartitionSpec``
or a rule table names is a declared mesh axis, and the tables and spec
builders actually shard the >1-D kernels they exist to shard.

The port keeps the JAX package's ``PartitionSpec`` / ``P`` in
``parallel/rules.py`` and turns a spec into DTensor placements
(``rules.placements``: one ``Shard(dim)`` or ``Replicate()`` per mesh
axis), so the invariants are checked without importing torch:

  1. **placements for all inputs and outputs.**  A
     ``distribute_tensor(x, mesh, placements)`` must pass its
     placements (a call without them replicates silently); a
     ``local_map(fn, out_placements, in_placements, ...)`` must declare
     both sides, and when ``in_placements`` is a literal tuple and the
     wrapped callable resolves in the call graph to a fixed-arity
     function, the tuple length must match its positional parameter
     count (a silently recycled placement after an added argument is
     the drift this catches).  A ``local_map`` whose literal
     ``in_placements`` are ALL ``None`` maps nothing.

  2. **axis names exist.**  Every axis a ``P(...)``/``PartitionSpec``
     names — a string literal, a ``*_AXIS`` constant (resolved through
     the import map), or a parameter default — must be one of the axes
     the parallel package declares (``mesh.py``'s ``dp``/``tp``/
     ``dp_dcn`` plus the ``ep``/``pp`` linear-mesh axes).  Rule tables
     are ``P`` literals too, so a typo in ``DENSE_MLP_RULES`` et al. is
     caught here.  An axis typo does not error when the spec is built;
     it surfaces later as a failed placement or, worse, silent
     replication.

  3. **no implicit full replication of a >1-D kernel.**  A spec
     builder (a function named ``*specs*``, e.g.
     ``dense_alternating_specs``) whose assigned/returned specs never
     include a ≥2-dim ``P`` carrying a real axis has lost its kernel
     branch.  Likewise for the literal rule tables (module-level
     ``*_RULES`` tuples of ``(pattern, P(...))`` rows, and the entries
     of ``RULE_TABLES``): a table must shard something, a table that
     shards over the model axis (``TP_AXIS``) must do so for at least
     one ≥2-dim kernel (a deleted kernel rule leaves only the biases
     split — every kernel serves fully replicated), every pattern must
     compile, and the table must end in the replicating
     ``(r".*", P())`` catch-all (an unmatched leaf then replicates by
     policy instead of raising at placement time).

Scope: ``har_tpu_torch/parallel/*.py`` + ``har_tpu_torch/serve/
dispatch.py`` (the serving-side placement).  Pure stdlib, like every
harlint rule.
"""

from __future__ import annotations

import ast
import re

from har_tpu_torch.analyze.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    walk_scopes,
)

_SCOPE_PREFIX = "har_tpu_torch/parallel/"
_SCOPE_FILES = {"har_tpu_torch/serve/dispatch.py"}
_SPEC_NAMES = {"P", "PartitionSpec"}
# the constant naming the model (tensor-parallel) axis
_MODEL_AXIS_CONST = "TP_AXIS"

# The files whose module-level ``*_AXIS`` constants define the declared
# mesh axes this rule validates against.  Path-subset runs (``lint
# --changed``) load these as support contexts so an edited parallel
# module is judged against the real axis table instead of an empty one
# (see ``run_harlint``).
AXIS_DECLARERS = (
    "har_tpu_torch/parallel/mesh.py",
    "har_tpu_torch/parallel/expert_parallel.py",
    "har_tpu_torch/parallel/pipeline_parallel.py",
)


def _is_spec(node) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in _SPEC_NAMES
    )


class PartitionSpecRule(Rule):
    rule_id = "HL007"
    title = "placement coverage"

    def applies(self, rel: str) -> bool:
        return rel.startswith(_SCOPE_PREFIX) or rel in _SCOPE_FILES

    def finalize(self, ctxs: list[FileContext]) -> list[Finding]:
        from har_tpu_torch.analyze.core import Project

        project = self.project or Project(ctxs)
        graph = project.callgraph

        # declared axes: module-level `*_AXIS = "name"` constants across
        # the scope (mesh.py's dp/tp/dp_dcn + expert/pipeline ep/pp)
        declared: dict[str, str] = {}
        for ctx in ctxs:
            for node in ctx.tree.body:
                if (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id.endswith("_AXIS"):
                            declared[node.value.value] = t.id
        axis_list = ", ".join(sorted(declared)) or "<none declared>"

        findings: list[Finding] = []
        for ctx in ctxs:
            # support ctxs (subset runs) contribute their axis table
            # above but are not themselves examined
            if not ctx.support:
                findings.extend(
                    self._check_file(ctx, graph, declared, axis_list)
                )
        return findings

    # ------------------------------------------------------------- file

    def _check_file(self, ctx, graph, declared, axis_list):
        findings: list[Finding] = []
        functions = walk_scopes(ctx.tree)

        def symbol_at(line: int) -> str:
            best = ""
            for qual, node in functions:
                if node.lineno <= line <= (node.end_lineno or node.lineno):
                    best = qual  # innermost wins: keep overwriting
            return best

        def flag(node, msg, symbol=None):
            if ctx.suppressed(node, "spec-ok"):
                ctx.suppression_hits += 1
                return
            findings.append(
                ctx.finding(
                    self.rule_id, node, msg,
                    symbol if symbol is not None
                    else symbol_at(getattr(node, "lineno", 1)),
                )
            )

        def resolve_axis(expr, line) -> list[str]:
            """Axis strings an expression can name; [] when opaque."""
            if expr is None or (
                isinstance(expr, ast.Constant) and expr.value is None
            ):
                return []
            if isinstance(expr, ast.Constant) and isinstance(
                expr.value, str
            ):
                return [expr.value]
            if isinstance(expr, (ast.Tuple, ast.List)):
                out = []
                for e in expr.elts:
                    out.extend(resolve_axis(e, line))
                return out
            if isinstance(expr, ast.BoolOp):
                out = []
                for e in expr.values:
                    out.extend(resolve_axis(e, line))
                return out
            if isinstance(expr, ast.Name):
                got = graph.resolve_const(ctx.rel, expr.id)
                if got is not None:
                    return [got]
                # parameter default: `def f(..., tp_axis=TP_AXIS)`
                for qual, node in functions:
                    if not isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        continue
                    if not (
                        node.lineno <= line
                        <= (node.end_lineno or node.lineno)
                    ):
                        continue
                    a = node.args
                    pos = a.posonlyargs + a.args
                    for p, d in zip(pos[len(pos) - len(a.defaults):],
                                    a.defaults):
                        if p.arg == expr.id:
                            return resolve_axis(d, node.lineno)
                    for p, d in zip(a.kwonlyargs, a.kw_defaults):
                        if d is not None and p.arg == expr.id:
                            return resolve_axis(d, node.lineno)
                return []
            return []

        # ---- P(...) axis-name validation
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in _SPEC_NAMES
            ):
                continue
            axes = []
            for arg in node.args:
                if isinstance(arg, ast.Starred):
                    continue
                for ax in resolve_axis(arg, node.lineno):
                    axes.append((ax, arg))
            for ax, arg in axes:
                if ax not in declared:
                    flag(
                        arg if hasattr(arg, "lineno") else node,
                        f"PartitionSpec axis `{ax}` is not a declared "
                        f"mesh axis (declared: {axis_list}) — a typo "
                        "here surfaces later as a mesh-resolution "
                        "failure or silent replication",
                    )

        # ---- distribute_tensor / local_map call sites
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            if name == "distribute_tensor":
                if len(node.args) < 3 and "placements" not in kw:
                    flag(
                        node,
                        "`distribute_tensor(...)` without placements — "
                        "the tensor replicates on every rank by default; "
                        "declare its placements (rules.placements(spec, "
                        "mesh))",
                    )
            elif name == "local_map":
                outs = node.args[1] if len(node.args) > 1 else kw.get(
                    "out_placements"
                )
                ins = node.args[2] if len(node.args) > 2 else kw.get(
                    "in_placements"
                )
                missing = [
                    k for k, v in (("out_placements", outs),
                                   ("in_placements", ins))
                    if v is None
                    or (isinstance(v, ast.Constant) and v.value is None)
                ]
                if missing:
                    flag(
                        node,
                        f"`local_map(...)` without {' / '.join(missing)} "
                        "— every input and output of a local program "
                        "must declare its placement",
                    )
                if isinstance(ins, ast.Tuple) and ins.elts:
                    self._arity_check(ctx, graph, node, ins, flag, functions)
                    if all(
                        isinstance(e, ast.Constant) and e.value is None
                        for e in ins.elts
                    ):
                        flag(
                            node,
                            "every `in_placements` entry of this "
                            "local_map is `None` — the map places "
                            "nothing; at least the sharded input must "
                            "declare its placements",
                        )

        # ---- rule tables (the match_partition_rules layer)
        self._table_audit(ctx, declared, flag, resolve_axis)

        # ---- spec-builder replication check (`*specs*` functions)
        for qual, fnode in functions:
            if not isinstance(fnode, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            if "specs" not in fnode.name:
                continue
            produced = []  # P calls in assignment/return value position
            for sub in ast.walk(fnode):
                vals = []
                if isinstance(sub, (ast.Assign, ast.Return)):
                    vals = [sub.value] if sub.value is not None else []
                elif isinstance(sub, ast.AnnAssign) and sub.value:
                    vals = [sub.value]
                for v in vals:
                    for c in ast.walk(v):
                        if (
                            isinstance(c, ast.Call)
                            and isinstance(c.func, ast.Name)
                            and c.func.id in _SPEC_NAMES
                        ):
                            produced.append(c)
            if not produced:
                continue
            def _sharded_multidim(c):
                # a ≥2-dim spec (two positional entries) naming at
                # least one real axis — the kernel-spec shape
                if len(c.args) < 2:
                    return False
                axes = []
                for arg in c.args:
                    axes.extend(resolve_axis(arg, c.lineno))
                return any(ax in declared for ax in axes)
            if not any(_sharded_multidim(c) for c in produced):
                flag(
                    fnode,
                    f"spec builder `{fnode.name}` produces no ≥2-dim "
                    "PartitionSpec carrying a declared axis — every "
                    ">1-D kernel it covers is implicitly FULLY "
                    "REPLICATED (the lost-kernel-branch failure mode); "
                    "restore the sharded kernel spec",
                    symbol=qual,
                )
        return findings

    # ------------------------------------------------------------ tables

    def _table_audit(self, ctx, declared, flag, resolve_axis):
        """Check 3's table half: every literal rule table compiles, ends
        in the replicating catch-all, shards something, and shards a
        ≥2-dim kernel when it uses the model axis."""
        lits: dict[str, ast.AST] = {}
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        lits[t.id] = node.value
        tables: dict[str, ast.AST] = {
            name: val for name, val in lits.items()
            if name.endswith("_RULES") and isinstance(val, (ast.Tuple,
                                                           ast.List))
        }
        registry = lits.get("RULE_TABLES")
        if isinstance(registry, ast.Dict):
            for k, v in zip(registry.keys, registry.values):
                if isinstance(v, (ast.Tuple, ast.List)) and isinstance(
                    k, ast.Constant
                ):
                    tables.setdefault(str(k.value), v)
        model_axes = {
            ax for ax, const in declared.items()
            if const == _MODEL_AXIS_CONST
        }

        for family, table in tables.items():
            rules = []
            for entry in table.elts:
                if not (
                    isinstance(entry, ast.Tuple) and len(entry.elts) == 2
                ):
                    continue
                pat_node, spec_node = entry.elts
                if not (
                    isinstance(pat_node, ast.Constant)
                    and isinstance(pat_node.value, str)
                    and _is_spec(spec_node)
                ):
                    continue
                try:
                    re.compile(pat_node.value)
                except re.error as exc:
                    flag(
                        pat_node,
                        f"rule pattern {pat_node.value!r} in `{family}` "
                        f"does not compile: {exc}",
                    )
                    continue
                axes = [
                    ax
                    for a in spec_node.args
                    if not isinstance(a, ast.Starred)
                    for ax in resolve_axis(a, spec_node.lineno)
                    if ax in declared
                ]
                rules.append((pat_node.value, axes, len(spec_node.args),
                              entry))
            if not rules:
                continue
            last_pat, last_axes, _, last_node = rules[-1]
            if last_pat != r".*" or last_axes:
                flag(
                    last_node,
                    f"rule table `{family}` does not end in the "
                    'replicating `(r".*", P())` catch-all — an '
                    "unmatched leaf raises at placement time instead "
                    "of replicating by policy",
                )
            if not any(axes for _, axes, _, _ in rules):
                flag(
                    table,
                    f"rule table `{family}` shards nothing — every "
                    "leaf it covers, >1-D kernels included, is FULLY "
                    "REPLICATED; restore its sharded kernel rules",
                )
            elif any(
                set(axes) & model_axes for _, axes, _, _ in rules
            ) and not any(
                n >= 2 and set(axes) & model_axes
                for _, axes, n, _ in rules
            ):
                flag(
                    table,
                    f"rule table `{family}` splits the model axis only "
                    "on 1-D leaves — no ≥2-dim kernel rule carries it, "
                    "so every kernel serves FULLY REPLICATED (a deleted "
                    "kernel rule); restore the sharded kernel specs",
                )

    # ------------------------------------------------------------ arity

    def _arity_check(self, ctx, graph, call, in_places, flag, functions):
        wrapped = call.args[0] if call.args else None
        if not isinstance(wrapped, ast.Name):
            return
        fi = None
        # nested def resolved LEXICALLY: the innermost def/class scope
        # enclosing the call, walked outward — never a same-named def
        # from an unrelated function (wrong arity both ways: spurious
        # findings AND masked genuine drift)
        enclosing = ""
        for qual, node in functions:
            if node.lineno <= call.lineno <= (node.end_lineno
                                              or node.lineno):
                enclosing = qual  # innermost wins: keep overwriting
        while enclosing:
            fi = graph.functions.get(
                (ctx.rel, f"{enclosing}.{wrapped.id}")
            )
            if fi is not None:
                break
            enclosing = (
                enclosing.rsplit(".", 1)[0] if "." in enclosing else ""
            )
        if fi is None:
            got = graph.resolve_symbol(ctx.rel, wrapped.id)
            from har_tpu_torch.analyze.callgraph import FuncInfo

            if isinstance(got, FuncInfo):
                fi = got
        if fi is None:
            return
        a = fi.node.args
        if a.vararg is not None:
            return  # *args: arity is dynamic, nothing to pin
        n_pos = len(a.posonlyargs) + len(a.args)
        if len(in_places.elts) != n_pos:
            flag(
                call,
                f"local_map in_placements declares {len(in_places.elts)} "
                f"placements but `{fi.name}` takes {n_pos} positional "
                "arguments — an added argument is silently riding a "
                "recycled placement (declare one per argument)",
            )
