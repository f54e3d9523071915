"""Partition-rule tables: parameter names to placements on a mesh.

Port of ``har_tpu/parallel/rules.py``.  One table per model family maps
parameter names to a :class:`PartitionSpec`; :func:`match_partition_rules`
resolves a table against a concrete parameter tree and
:func:`make_shard_and_gather_fns` turns the resolved specs into per-leaf
placement (``distribute_tensor``) and fetch (``full_tensor``) closures.

Rule semantics are the JAX package's:

- a rule is ``(regex, PartitionSpec)``, ``re.search``-ed against a leaf's
  name: a ``state_dict`` key (``blocks.0.qkv.weight``), or the
  ``/``-joined path of a nested dict or list (an optimizer state, a list
  of serving leaves addressed ``"0"``, ``"1"``, ...);
- first match wins; scalar leaves (ndim 0, or one element) replicate
  whatever the table says;
- a leaf no rule matches is a ``ValueError``: every table ends with the
  catch-all ``(".*", P())``.

A :class:`PartitionSpec` names, for each tensor dim, the mesh axis it
shards over (or ``None``), as JAX's does; :func:`placements` turns it into
one ``Shard``/``Replicate`` per mesh axis.  The port's tables key on the
port's names and layouts (``convert.transformer_params_from_flax`` and
``convert.mlp_params_from_flax`` give the mapping): a torch ``Linear``
weight is ``(out, in)``, the transpose of a flax kernel, so the JAX spec
``P(None, "tp")`` of a column-parallel kernel is ``P("tp", None)`` on the
port's weight, and every spec of a 2-D leaf here is the JAX spec reversed.

``DENSE_MLP_RULES`` shards the MLP's hidden stack ``layers.<i>`` by layer
parity.  The port's MLP names its last layer ``head`` where flax counts it
as ``Dense_<L>``, so the table cannot tell the head's parity and leaves it
replicated; :func:`rules_for_params` gives an MLP the generated
:func:`alternating_rules` table, which walks the layers in forward order
and shards the head as the JAX table does.
"""

from __future__ import annotations

import re

import numpy as np

from har_tpu_torch.parallel.mesh import TP_AXIS, mesh_shape


class PartitionSpec(tuple):
    """Per tensor dim: the mesh axis (or tuple of axes) it shards over, or
    ``None``; dims past the end are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def placements(spec, mesh) -> tuple:
    """One placement per mesh axis for a leaf laid out by ``spec``: the
    tensor dim an axis shards, or ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [
            d for d, entry in enumerate(spec)
            if axis in (entry if isinstance(entry, tuple) else (entry,))
        ]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _walk(tree, path=()):
    """(path, leaf) pairs of a nested dict/list/tuple tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_map(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _as_tree(params):
    """A module's parameters as its ``state_dict``-named dict."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return params


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else np.ndim(leaf)


def _size(leaf) -> int:
    # a leaf's shape metadata, read when a scorer places its weights
    # harlint: host-ok
    return int(np.prod(leaf.shape)) if hasattr(leaf, "shape") else np.size(leaf)


def match_rule(rules, name: str):
    """First-match-wins lookup of one name in a rule table."""
    for pattern, spec in rules:
        if re.search(pattern, name) is not None:
            return spec
    raise ValueError(
        f"no partition rule matched {name!r} — every rule table must "
        "end with a terminal catch-all ('.*', P())"
    )


def match_partition_rules(rules, params):
    """Resolve a rule table against a parameter tree (a module, a
    ``state_dict``, or nested dicts and lists) → the same tree of
    :class:`PartitionSpec`; scalar leaves replicate."""

    def assign(path, leaf):
        if _ndim(leaf) == 0 or _size(leaf) == 1:
            return P()
        return match_rule(rules, tree_path_str(path))

    return _map(assign, _as_tree(params))


def place_local(mesh, spec, x):
    """One leaf on a single-controller :class:`~har_tpu_torch.parallel.mesh.
    ServingMesh`: an object array of the mesh's grid shape whose cell holds
    that device's local tensor — ``x`` sliced by ``spec`` (each dim an axis
    shards, cut into equal blocks, the block index the cell's coordinate
    along that axis, several axes of one dim major first) and moved to the
    cell's device.  A replicated dim is whole; a tensor already on the
    cell's device is not copied, so a mesh that repeats one device holds
    views of ``x``."""
    names = mesh.mesh_dim_names
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(out.shape):
        coord = dict(zip(names, idx))
        local = x
        for dim, entry in enumerate(tuple(spec)):
            axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
                    if a is not None]
            if not axes:
                continue
            parts, block = 1, 0
            for ax in axes:
                n = mesh.shape[names.index(ax)]
                parts, block = parts * n, block * n + coord[ax]
            size = local.shape[dim] // parts
            local = local.narrow(dim, block * size, size)
        out[idx] = local.to(mesh.devices[idx])
    return out


def make_shard_fns(mesh, partition_specs):
    """Per-leaf placement closures for a resolved spec tree: each puts a
    whole tensor (the same on every rank) onto the mesh in its layout."""
    from torch.distributed.tensor import distribute_tensor

    def shard_fn(spec):
        where = placements(spec, mesh)
        return lambda x: distribute_tensor(x, mesh, where)

    return _map(lambda _, spec: shard_fn(spec), partition_specs)


def make_shard_and_gather_fns(mesh, partition_specs):
    """``(shard_fns, gather_fns)``: the gather half fetches a placed leaf
    back whole (``full_tensor``, a collective over the mesh)."""

    def gather_fn(spec):
        del spec  # full_tensor assembles any layout
        return lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x

    return (
        make_shard_fns(mesh, partition_specs),
        _map(lambda _, spec: gather_fn(spec), partition_specs),
    )


def respec_axis(spec, old: str, new: str):
    """A table spec with one mesh-axis name substituted."""
    if old == new:
        return spec
    return P(*[new if entry == old else entry for entry in tuple(spec)])


def spec_shard_count(mesh, spec) -> int:
    """How many ways one leaf splits under ``spec`` on ``mesh`` (the
    mesh's shape only)."""
    shape = mesh_shape(mesh)
    n = 1
    for entry in tuple(spec):
        for ax in entry if isinstance(entry, tuple) else (entry,):
            if ax is not None:
                n *= int(shape[ax])
    return n


# --------------------------------------------------------------------
# family tables (literal, as in the JAX package); specs are on the
# port's (out, in) weights

# the MLP's hidden stack (models.neural.MLP: layers.<i>, then head):
# Megatron alternation by layer parity, even layers column-parallel (the
# output dim sharded, the bias with it), odd layers row-parallel
DENSE_MLP_RULES = (
    (r"layers\.\d*[02468]\.weight$", P(TP_AXIS, None)),
    (r"layers\.\d*[13579]\.weight$", P(None, TP_AXIS)),
    (r"layers\.\d*[02468]\.bias$", P(TP_AXIS)),
    (r".*", P()),
)

# Transformer1D's encoder blocks: attention qkv column-parallel, proj
# row-parallel closing the pair with one all-reduce; the MLP pair
# mlp_in / mlp_out likewise (flax's Dense_0 / Dense_1 of a block).
# Embedding, norms and the head stay replicated.
TRANSFORMER_RULES = (
    (r"qkv\.weight$", P(TP_AXIS, None)),
    (r"qkv\.bias$", P(TP_AXIS)),
    (r"proj\.weight$", P(None, TP_AXIS)),
    (r"mlp_in\.weight$", P(TP_AXIS, None)),
    (r"mlp_in\.bias$", P(TP_AXIS)),
    (r"mlp_out\.weight$", P(None, TP_AXIS)),
    (r".*", P()),
)

# int8 serving leaves: a flat list addressed by position (the JAX
# package's table, for the serving layer of the port)
INT8_RULES = (
    (r"^1$", P(None, TP_AXIS)),
    (r"^2$", P(TP_AXIS, None)),
    (r".*", P()),
)


def zero1_rules(axes):
    """ZeRO-1's optimizer state: every array leaf of the flat state shards
    its leading axis over the data axes ``axes``; scalars replicate."""
    return ((r".*", P(tuple(axes))),)


MOE_RULES = (
    (r"^router$", P()),
    (r"^experts(/|$)", P("ep")),
    (r".*", P()),
)

PIPELINE_RULES = (
    (r"^stacked_params$", P("pp")),
    (r".*", P()),
)

RULE_TABLES = {
    "dense_mlp": DENSE_MLP_RULES,
    "transformer": TRANSFORMER_RULES,
    "int8": INT8_RULES,
    "moe": MOE_RULES,
}


def natural_key(path: str) -> tuple:
    """The JAX walk's sort key of a ``/``-joined path: each component as
    (prefix, numeric suffix), so ``Dense_10`` follows ``Dense_9``."""

    def component(k):
        head, _, tail = k.rpartition("_")
        return (head, int(tail)) if tail.isdigit() else (k, -1)

    return tuple(component(k) for k in path.split("/"))


def alternating_rules(params, tp_axis: str = TP_AXIS, *, kernels_only: bool = False,
                      walk=None, in_out: bool = False):
    """Generated table: Megatron alternation over any parameter tree.

    Walks the leaves in the tree's own order (a module's registration
    order: the forward order) and emits one exact-name rule per 2-D
    kernel-like leaf — even ordinals column-parallel ``P(tp, None)``, odd
    row-parallel ``P(None, tp)`` — a rule for the bias of each
    column-parallel kernel, and the catch-all.  ``kernels_only`` counts
    only leaves named ``weight`` (or ``kernel``).  ``in_out`` reads the
    kernels in flax's ``(in, out)`` layout (an int8 tier's stored leaf
    list), where the specs are the JAX package's: column-parallel
    ``P(None, tp)``, row-parallel ``P(tp, None)``.

    ``walk`` replaces the tree's own walk: ``(name, path, ndim)`` a leaf,
    in the order to walk, where ``name`` is what the rule matches and the
    leaf is classified by ``path`` (its last part) and ``ndim``, as
    ``tensor_parallel.dense_alternating_specs`` walks a module by the flax
    tree that holds its values."""
    if walk is None:
        walk = [(tree_path_str(p), tree_path_str(p), _ndim(leaf))
                for p, leaf in _walk(_as_tree(params))]
    rules = []
    kernel_index = 0
    column_prefixes = set()
    prev_was_column = False
    for name, path, ndim in walk:
        tail = path.rsplit(".", 1)[-1].rsplit("/", 1)[-1]
        is_kernel = tail in ("weight", "kernel") if kernels_only else tail != "bias"
        if ndim == 2 and is_kernel:
            column = kernel_index % 2 == 0
            if column:
                column_prefixes.add(name.rsplit(".", 1)[0])
            kernel_index += 1
            rules.append((
                rf"^{re.escape(name)}$",
                P(tp_axis, None) if column != in_out else P(None, tp_axis),
            ))
            prev_was_column = column
        elif ndim == 1 and tail.isdigit() and prev_was_column:
            # positional (list) form: the 1-D follower of a
            # column-parallel kernel is its bias
            rules.append((rf"^{re.escape(name)}$", P(tp_axis)))
            prev_was_column = False
        else:
            prev_was_column = False
    for name, _, _ in walk:
        if name.endswith(".bias") and name.rsplit(".", 1)[0] in column_prefixes:
            rules.append((rf"^{re.escape(name)}$", P(tp_axis)))
    rules.append((r".*", P()))
    return tuple(rules)


def rules_for_params(params, tp_axis: str = TP_AXIS):
    """The table a parameter tree trains and serves under: a transformer
    (``qkv.weight``) gets ``TRANSFORMER_RULES``; a tree whose every
    ≥2-dim leaf is ``layers.<i>.weight`` gets ``DENSE_MLP_RULES``;
    anything else (the MLP with its head, demo models, leaf lists) a
    generated :func:`alternating_rules` table."""
    flat = list(_walk(_as_tree(params)))
    names = [tree_path_str(p) for p, _ in flat]
    if any(n.endswith("qkv.weight") for n in names):
        return TRANSFORMER_RULES
    multi = [n for (_, leaf), n in zip(flat, names) if _ndim(leaf) >= 2]
    if multi and all(re.search(r"layers\.\d+\.weight$", n) for n in multi):
        return DENSE_MLP_RULES
    return alternating_rules(params, tp_axis)


def shard_divisibility_check(params, specs, mesh) -> None:
    """Refuse layouts whose sharded dims do not divide their mesh axis."""
    shape = mesh_shape(mesh)
    spec_leaves = [s for _, s in _walk(specs)]
    for (path, leaf), s in zip(_walk(_as_tree(params)), spec_leaves):
        for dim, entry in zip(tuple(leaf.shape), tuple(s)):
            for ax in entry if isinstance(entry, tuple) else (entry,):
                # host-side mesh-shape arithmetic at scorer
                # construction — no device value is touched
                # harlint: host-ok
                if ax is not None and dim % int(shape[ax]):
                    raise ValueError(
                        f"param {tree_path_str(path)!r} dim {dim} not "
                        f"divisible by mesh axis {ax!r}={shape[ax]} (spec {s})"
                    )
