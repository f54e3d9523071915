"""Tensor-parallel forwards of served models on a single-controller mesh.

The JAX package's ``ModelParallelScorer`` places a checkpoint's leaves by
its family's partition-rule table and lets GSPMD insert the collectives
the layout implies.  The port has no compiler to do that, so this module
runs the layout itself, one data shard (one row of ``tp`` devices of a
:class:`~har_tpu_torch.parallel.mesh.ServingMesh`) at a time, for every
model a fleet serves on a device:

- ``JitDemoModel``'s ``tanh(x @ w1 + b1) @ w2``, placed by the generated
  ``alternating_rules`` table on its weights in ``(out, in)`` layout, and
  its int8 tier (``quantize_serving``) by ``INT8_RULES`` on the stored
  int8 leaves in their ``(in, out)`` layout;
- the neural MLP, CNN1D and BiLSTM, placed by the table the JAX package
  generates for their flax tree (``alternating_rules`` walked in the
  natural order of the flax paths, ``convert.flax_leaf_names``: the
  conv stack and the recurrence, 3-D, stay replicated), and any
  transformer-shaped module (parameter names that select
  ``TRANSFORMER_RULES``, ``blocks`` of encoder blocks: ``Transformer1D``,
  the bench's ``WideTransformerDemoModel``): the model's own forward runs
  on a copy of the module whose ``Dense`` layers are swapped for layers
  of the table's layout and whose encoder blocks attend on each device's
  heads (K2 where the block uses it; the wide demo's plain attention, as
  the JAX model's);
- the int8 tier of each of those four neural families: its stored
  leaves (int8 kernels and float32 rest, in flax's layout and
  ``jax.tree_util``'s order) placed by position, as the JAX package's
  generated table places ``_Int8Inner.params``.  Each device keeps its
  blocks of the int8 values, in the port's layout, and of their scales,
  and dequantizes them at every call, as the single-device program does;
  the copy of the module then runs as for float32.  The positional
  alternation ignores what a leaf is: a sharded 1-D leaf need not be the
  bias of the column-parallel kernel before it, and a transformer's
  ``qkv`` comes out row-parallel;
- an exported artifact (``export.ExportedPredictor``), as the JAX package
  serves its StableHLO program: a float artifact's weights are constants
  of its program, so each row's first device runs the whole program on
  its data shard; an int8 artifact's weight buffers are placed by the
  same positional table over the JAX package's weight list (the meta's
  ``int8_leaves`` record names them), and each row runs the artifact's
  own graph rewritten for its devices (:func:`_row_graph`): no model
  class is rebuilt.

Each weight leaf sits on each device as its block of the table's spec
(``rules.place_local``); activations are whole on the row's first device
between layers.  A column-parallel layer (output dim sharded) runs on
each device over the whole input and its output blocks are gathered in
device order; a row-parallel layer (input dim sharded) runs on each
device over its block of the input, and the partial sums, taken in
float32 over the operands rounded to the layer's dtype, are added on the
first device in device order (so one mesh gives the same bits twice),
the bias after and the sum rounded once; a replicated layer runs on the
first device.  A sharded leaf used whole (a bias of a row-parallel
layer, a norm, the recurrence's bias) is concatenated there.  The
attention always runs on each device's heads: the ``(B, T, 3E)``
projection is whole on the first device (gathered where ``qkv`` is
column-parallel, summed there where it is row-parallel), and each device
runs kernel K2 on its own heads, ``(B/dp, T, H/tp, D)``.  On CUDA
tensors K2 launches or raises; nothing falls back to the plain
attention.

A layout whose sharded dims or heads do not divide the mesh raises
:class:`NotModelParallel` (a ``ValueError``), and ``dispatch.make_scorer``
then takes the batch-only rung, as the JAX package does.  A program with
no tensor-parallel forward here (a sequence-sharded transformer, which
the JAX package cannot serve either; an int8 artifact exported without
its leaf record) raises :class:`NoTensorParallelForward`, which
``make_scorer`` lets through: a model axis that was asked for is never
quietly dropped.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from har_tpu_torch.parallel.mesh import TP_AXIS
from har_tpu_torch.parallel.rules import (
    INT8_RULES,
    TRANSFORMER_RULES,
    P,
    alternating_rules,
    match_partition_rules,
    natural_key,
    place_local,
    rules_for_params,
    shard_divisibility_check,
    spec_shard_count,
)


class NotModelParallel(ValueError):
    """The layout does not divide this mesh: serve the model
    batch-sharded instead."""


class NoTensorParallelForward(ValueError):
    """The model's family has no tensor-parallel forward in the port:
    serve it on a mesh with no model axis."""


def _padded(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _kind(spec, ndim: int) -> str:
    """How a weight of the port's ``(out, in)`` layout is split: ``col``
    (output dim over ``tp``), ``row`` (input dim) or ``rep``."""
    entries = _padded(spec, ndim)
    if all(e is None for e in entries):
        return "rep"
    if ndim == 2 and entries == (TP_AXIS, None):
        return "col"
    if ndim == 2 and entries == (None, TP_AXIS):
        return "row"
    raise NoTensorParallelForward(f"no tensor-parallel layer for a weight placed {spec}")


class _Row:
    """One data shard: its tp devices and each leaf's local tensors."""

    def __init__(self, devices, leaves: dict, specs: dict):
        self.devices = devices
        self.leaves = leaves
        self.specs = specs

    def leaf(self, name: str):
        """A leaf whole, on the row's first device (a block-split leaf is
        concatenated along the dim its spec shards)."""
        parts = self.leaves[name]
        sharded = [d for d, e in enumerate(tuple(self.specs[name])) if e is not None]
        if not sharded:
            return parts[0]
        if len(sharded) > 1:
            raise NoTensorParallelForward(f"leaf {name!r} is split over several dims")
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=sharded[0])

    def _bias_block(self, name, j: int, size: int):
        parts = self.leaves[name]
        if any(e is not None for e in tuple(self.specs[name])):
            return parts[j]
        return parts[j].narrow(0, j * size, size)

    def linear(self, x, weight: str, bias: str | None, dtype):
        """``x @ Wᵀ + b`` (``Dense``'s cast to ``dtype`` at use) in the
        layout of ``weight``'s spec; ``x`` and the result whole on the
        row's first device."""
        ws = self.leaves[weight]
        d0 = self.devices[0]
        kind = _kind(self.specs[weight], ws[0].dim())
        if kind == "col":
            return torch.cat([
                F.linear(x.to(d).to(dtype), w.to(dtype),
                         None if bias is None
                         else self._bias_block(bias, j, w.shape[0]).to(dtype)).to(d0)
                for j, (d, w) in enumerate(zip(self.devices, ws))
            ], -1)
        if kind == "row":
            size = ws[0].shape[1]
            total = None
            for j, (d, w) in enumerate(zip(self.devices, ws)):
                # partial sums of the dtype-rounded operands in float32,
                # added in device order and rounded once, as the
                # unsharded layer accumulates its one product
                xj = x.narrow(-1, j * size, size).to(d)
                part = F.linear(xj.to(dtype).float(), w.to(dtype).float()).to(d0)
                total = part if total is None else total + part
            if bias is not None:
                total = total + self.leaf(bias).to(dtype).float()
            return total.to(dtype)
        return F.linear(x.to(dtype), ws[0].to(dtype),
                        None if bias is None else self.leaf(bias).to(dtype))

    def attention(self, attend, q, k, v, seg=None):
        """``attend`` on each device's heads of (B, T, H, D) ``q``, ``k``,
        ``v`` (views the kernel reads through their strides); the heads
        come back to the first device in order."""
        hl = q.shape[2] // len(self.devices)
        d0 = self.devices[0]
        return torch.cat([
            attend(*(u[:, :, j * hl:(j + 1) * hl].to(d) for u in (q, k, v)), seg).to(d0)
            for j, d in enumerate(self.devices)
        ], dim=2)


class _RowDense(nn.Module):
    """A ``Dense`` of a placed copy: ``_Row.linear`` on the row's blocks
    of its weight and bias."""

    def __init__(self, row: _Row, name: str, dtype):
        super().__init__()
        self.row, self.name, self.dtype = row, name, dtype

    def forward(self, x):
        return self.row.linear(x, f"{self.name}.weight", f"{self.name}.bias", self.dtype)


def _placed_module(module, row: _Row, *, bound: bool = True):
    """A copy of ``module`` for one row, none of its weights copied: each
    ``Dense`` swapped for a :class:`_RowDense`, every other parameter the
    row's leaf whole on its first device (``bound=False``: an empty
    placeholder, the caller passing the leaves at every call), and each
    encoder block's ``attend`` run on the devices' heads."""
    from har_tpu_torch.models.transformer import Dense, EncoderBlock

    placed = copy.deepcopy(module, {id(p): None for p in module.parameters()})
    for name, sub in list(placed.named_modules()):
        if isinstance(sub, Dense):
            parent, _, child = name.rpartition(".")
            setattr(placed.get_submodule(parent), child, _RowDense(row, name, sub.dtype))
    for name, sub in placed.named_modules():
        if isinstance(sub, _RowDense):
            continue
        for key in sub._parameters:
            full = f"{name}.{key}" if name else key
            value = row.leaf(full) if bound else torch.empty(0)
            sub._parameters[key] = nn.Parameter(value, requires_grad=False)
        if isinstance(sub, EncoderBlock):
            sub.attend = functools.partial(row.attention, type(sub).attend.__get__(sub))
    return placed.to(row.devices[0])


def _demo_forward(row: _Row, x):
    h = torch.tanh(row.linear(x.reshape(x.shape[0], -1), "w1", "b1", torch.float32))
    return row.linear(h, "w2", None, torch.float32)


def _specs(table, tree, mesh):
    """``table`` resolved against ``tree``; a sharded dim that does not
    divide its mesh axis refuses the placement."""
    specs = match_partition_rules(table, tree)
    try:
        shard_divisibility_check(tree, specs, mesh)
    except ValueError as exc:
        raise NotModelParallel(str(exc)) from exc
    return specs


class TPProgram:
    """A model's forward over a serving mesh: its leaves placed once by a
    rule table, one data shard run at a time (:meth:`forward_row`).
    ``row_forward`` makes a row's forward from its :class:`_Row`.
    ``tree`` and ``specs`` are the model's weight leaves and their specs
    (what ``params_bytes`` counts); ``leaves`` (name -> (tensor, spec),
    default the tree itself) are what the rows hold."""

    def __init__(self, row_forward, tree: dict, specs: dict, mesh, rules, leaves=None):
        self.rules = rules
        self.tree = tree
        self.specs = specs
        self.mesh = mesh
        if leaves is None:
            leaves = {name: (t, specs[name]) for name, t in tree.items()}
        tp = mesh.devices.shape[-1]
        rows = mesh.devices.reshape(-1, tp)
        # leaf name -> (data shard, tp index) grid of local tensors
        self.placed = {name: place_local(mesh, spec, t).reshape(-1, tp)
                       for name, (t, spec) in leaves.items()}
        row_specs = {name: spec for name, (_, spec) in leaves.items()}
        self._forwards = [
            row_forward(_Row(list(devices), {n: c[i] for n, c in self.placed.items()},
                             row_specs))
            for i, devices in enumerate(rows)
        ]

    def forward_row(self, i: int, x):
        """Logits of data shard ``i``'s rows (on that row's first
        device)."""
        return self._forwards[i](x)

    def params_bytes(self) -> dict:
        """The placed leaves' bytes: total, and one device's share (each
        leaf divided by its spec's shard count)."""
        total = per_device = 0
        for name, t in self.tree.items():
            nbytes = int(t.numel()) * t.element_size()
            total += nbytes
            per_device += nbytes // spec_shard_count(self.mesh, self.specs[name])
        return {"total": total, "per_device": per_device}


def _int8_demo(model, mesh, rules):
    """The int8 tier of ``JitDemoModel``: the stored leaves ``[b1, w1,
    w2]`` (int8 kernels in their ``(in, out)`` layout) placed by
    position (``INT8_RULES``), each scale with its kernel's output dim;
    a device dequantizes its blocks (``int8 → f32 × scale``, as the
    single-device forward does) into the ``(out, in)`` leaves of the
    demo's forward."""
    stored = list(model.stored)
    names = ("b1", "w1", "w2")
    if len(stored) != 3:
        raise NoTensorParallelForward("an int8 program of an unexpected shape")
    tree, kernels = {}, {}
    for i, (name, s) in enumerate(zip(names, stored)):
        tree[str(i)] = torch.from_numpy(np.ascontiguousarray(s.value))
        if s.kind == "q8":
            kernels[str(i)] = name
    table = INT8_RULES if rules is None else rules
    specs = dict(zip(tree, _specs(table, list(tree.values()), mesh)))
    leaves = {key: (t, specs[key]) for key, t in tree.items()}
    for key in kernels:
        out_spec = (tuple(specs[key]) + (None, None))[1]
        scale = torch.from_numpy(np.ascontiguousarray(stored[int(key)].scale))
        leaves[f"s{key}"] = (scale, P(out_spec))

    def dequant(grid):
        leaves, out_specs = {}, {}
        for key, name in zip(("0", "1", "2"), names):
            if key in kernels:
                leaves[name] = [(q.to(torch.float32) * s).t()
                                for q, s in zip(grid[key], grid[f"s{key}"])]
                out_specs[name] = P(*reversed((tuple(specs[key]) + (None, None))[:2]))
            else:
                leaves[name], out_specs[name] = grid[key], specs[key]
        return leaves, out_specs

    def row_forward(row):
        # dequantized at every call, as the single-device forward does:
        # the int8 blocks are what stays on the devices
        return lambda x: _demo_forward(_Row(row.devices, *dequant(row.leaves)), x)

    return TPProgram(row_forward, tree, specs, mesh, table, leaves)


def _check_heads(module, mesh) -> None:
    """Each device attends on H / tp heads: heads that do not divide the
    model axis refuse the placement."""
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(TP_AXIS, 1)
    blocks = getattr(module, "blocks", ())
    heads = blocks[0].num_heads if len(blocks) else tp
    if heads % tp:
        raise NotModelParallel(
            f"num_heads {heads} not divisible by mesh axis {TP_AXIS!r}={tp}"
        )


def _int8_neural(model, fwd, mesh, rules):
    """The int8 tier of a neural family: the stored leaves (``model.
    stored``, at ``model.paths`` in flax's tree) placed by position —
    the JAX package's generated table over its leaf list, or ``rules`` —
    and the module's forward run on them.  Each of the port's parameters
    holds the values of one flax leaf (``convert.flax_leaf_names``): a
    Dense weight the transpose of its kernel, so it takes the kernel's
    spec reversed, any other leaf its own layout and spec.  The rows keep
    the int8 values in the port's layout with their scales (each scale
    split where it spans the split dim) and dequantize them at every
    call."""
    from har_tpu_torch.convert import flax_leaf_names
    from har_tpu_torch.quantize import _model_name

    module = fwd.core.module
    if getattr(module, "sp_axis", None) is not None:
        raise NoTensorParallelForward("a sequence-sharded transformer has no "
                                      "tensor-parallel forward")
    family = _model_name(module)
    tree = {str(i): torch.from_numpy(np.ascontiguousarray(s.value))
            for i, s in enumerate(model.stored)}
    leaf_list = list(tree.values())
    table = alternating_rules(leaf_list, in_out=True) if rules is None else rules
    specs = dict(zip(tree, _specs(table, leaf_list, mesh)))
    position = {"/".join(path): i for i, path in enumerate(model.paths)}
    values = dict(zip((n for n, _ in fwd.names), fwd.stored_values()))
    origin = flax_leaf_names(family, module, values)
    leaves, port_specs, quantized = {}, {}, dict(fwd.names)
    for i, (name, q) in enumerate(fwd.names):
        path, ndim = origin[name]
        k = position[path]
        spec = _padded(specs[str(k)], ndim)
        w = values[name]
        if any(e is not None for e in spec):
            if path.endswith("/kernel") and ndim == 2 and w.dim() == 2:
                spec = spec[::-1]  # a Dense weight: the kernel's transpose
            elif tuple(w.shape) != model.stored[k].value.shape:
                raise NoTensorParallelForward(f"no tensor-parallel layout for {name!r}")
        if w.dim() == 2:
            _kind(spec, 2)
        port_specs[name] = P(*spec)
        leaves[f"w:{name}"] = (w, P(*spec))
        if q:
            scale = getattr(fwd, f"s{i}")
            leaves[f"s:{name}"] = (scale, P(*(e if scale.shape[d] > 1 else None
                                              for d, e in enumerate(spec))))
    if family == "transformer":
        _check_heads(module, mesh)

    def row_forward(row):
        live = _Row(row.devices, {}, port_specs)
        placed = _placed_module(module, live, bound=False)
        direct = [n for n, _ in placed.named_parameters()]

        def dequant(name):
            parts = row.leaves[f"w:{name}"]
            if not quantized[name]:
                return parts
            scales = row.leaves[f"s:{name}"]
            if all(e is None for e in tuple(port_specs[name])):
                # used whole on the first device only
                return [parts[0].to(torch.float32) * scales[0]]
            return [w.to(torch.float32) * s for w, s in zip(parts, scales)]

        def forward(x):
            # dequantized at every call, as the single-device forward
            # does: the int8 blocks are what stays on the devices
            live.leaves = {name: dequant(name) for name in quantized}
            return torch.func.functional_call(placed, {n: live.leaf(n) for n in direct}, (x,))

        return forward

    return TPProgram(row_forward, tree, specs, mesh, table, leaves)


def _transformer_shaped(module: nn.Module, tree: dict) -> bool:
    """A module served head-parallel: its parameter names select
    ``TRANSFORMER_RULES`` and its ``blocks`` are encoder blocks."""
    from har_tpu_torch.models.transformer import EncoderBlock

    blocks = getattr(module, "blocks", None)
    return (rules_for_params(tree) is TRANSFORMER_RULES and isinstance(blocks, nn.ModuleList)
            and all(isinstance(b, EncoderBlock) for b in blocks))


def _flax_walk(module) -> list:
    """(name, flax path, flax ndim) of each parameter of a neural module,
    in the natural order of the flax paths: the order the JAX package
    walks its tree in."""
    from har_tpu_torch.convert import flax_leaf_names
    from har_tpu_torch.transfer import model_family

    leaves = flax_leaf_names(model_family(module), module)
    return sorted(((name, path, ndim) for name, (path, ndim) in leaves.items()),
                  key=lambda leaf: natural_key(leaf[1]))


# ------------------------------------------------------------ exported artifacts

# ops a placed buffer runs through block by block (its dequantization)
_BLOCKWISE = (torch.ops.aten.to.dtype, torch.ops.aten._to_copy.default,
              torch.ops.aten.mul.Tensor)


def _each(op, *args, **kwargs):
    """``op`` on each device's block: a list argument gives its j-th
    entry, any other argument is passed as it is."""
    n = next(len(a) for a in args if isinstance(a, list))
    return [op(*(a[j] if isinstance(a, list) else a for a in args), **kwargs)
            for j in range(n)]


def _whole(parts: list, dim, device):
    """A placed value whole on ``device`` (the row's first): its blocks
    concatenated along ``dim`` in device order, or, replicated (``dim``
    None), the first device's own copy — as :meth:`_Row.leaf`."""
    if dim is None:
        return parts[0]
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _linear_col(x, ws, b, b_split: bool, devices):
    """``aten.linear`` with its weight split by output rows: each device
    runs its block over the whole input (the bias's block beside it: a
    split bias's own block, else a slice of the whole one), and the
    output blocks are gathered in device order on the first device."""
    d0, outs = devices[0], []
    for j, (d, w) in enumerate(zip(devices, ws)):
        bj = None
        if b is not None:
            full = b[j] if isinstance(b, list) else b
            bj = full if b_split else full.narrow(0, j * w.shape[0], w.shape[0])
        outs.append(F.linear(x.to(d), w, None if bj is None else bj.to(d)).to(d0))
    return torch.cat(outs, -1)


def _linear_row(x, ws, b, devices):
    """``aten.linear`` with its weight split by input columns: each
    device's product over its block of the input, the partial sums in
    float32 added on the first device in device order, the bias after,
    rounded once — as :meth:`_Row.linear`."""
    d0, total, at = devices[0], None, 0
    for d, w in zip(devices, ws):
        xj = x.narrow(-1, at, w.shape[1]).to(d)
        at += w.shape[1]
        part = F.linear(xj.float(), w.float()).to(d0)
        total = part if total is None else total + part
    if b is not None:
        total = total + b.float()
    return total.to(torch.promote_types(x.dtype, ws[0].dtype))


def _flash_heads(q, k, v, with_lse: bool, devices):
    """K2's op on each device's heads of (B, T, H, D) ``q``, ``k``, ``v``
    (views the kernel reads through their strides), out and lse gathered
    on the first device in head order — as :meth:`_Row.attention`."""
    from har_tpu_torch.ops import flash_attention as flash

    hl, d0 = q.shape[2] // len(devices), devices[0]
    outs, lses = [], []
    for j, d in enumerate(devices):
        out, lse = flash.flash_attention_fwd(
            *(u[:, :, j * hl:(j + 1) * hl].to(d) for u in (q, k, v)), with_lse)
        outs.append(out.to(d0))
        lses.append(lse.to(d0))
    return torch.cat(outs, 2), torch.cat(lses, 1) if with_lse else lses[0]


def _blockwise_dim(node, env: dict, placed: dict):
    """The split dim of ``node``'s result where it can run block by block
    (every tensor operand placed, the split ones along one dim, the
    replicated ones of size 1 there), else None."""
    out = tuple(node.meta["val"].shape)
    dims, whole = set(), []
    for a in node.all_input_nodes:
        new = env[a]
        if new not in placed:
            return None
        shape = tuple(a.meta["val"].shape)
        offset = len(out) - len(shape)
        if placed[new] is None:
            whole.append((shape, offset))
        elif shape[placed[new]] != out[placed[new] + offset]:
            return None
        else:
            dims.add(placed[new] + offset)
    if len(dims) != 1:
        return None
    dim = dims.pop()
    if any(0 <= dim - offset and shape[dim - offset] != 1 for shape, offset in whole):
        return None
    return dim


def _row_graph(gm, dims: dict, devices):
    """The exported graph ``gm`` rewritten for one row of devices.  A
    placeholder named in ``dims`` takes a list of per-device blocks (its
    split dim, or None replicated).  The rewrite:

    - a dequantization op (``to``, ``mul``) of placed blocks runs block
      by block (:func:`_each`), its result placed;
    - ``aten.linear`` whose weight is split by output rows or input
      columns runs column- or row-parallel (:func:`_linear_col`,
      :func:`_linear_row`);
    - K2's op runs on each device's heads (:func:`_flash_heads`);
    - any other use of a placed value takes it whole on the first device
      (:func:`_whole`, once a value);
    - ``_assert_tensor_metadata`` (the traced device and dtype) is
      dropped and every ``device=`` is the row's first device."""
    from torch import fx

    aten = torch.ops.aten
    flash_op = torch.ops.har_tpu_torch.flash_attention_fwd.default
    d0 = devices[0]
    graph = fx.Graph()
    env, placed, wholes = {}, {}, {}

    def whole(new):
        if new not in placed:
            return new
        if new not in wholes:
            wholes[new] = graph.call_function(_whole, (new, placed[new], d0))
        return wholes[new]

    def arg(a):
        return fx.map_arg(a, lambda n: env[n])

    for n in gm.graph.nodes:
        if n.op == "placeholder":
            new = graph.placeholder(n.name)
            if n.name in dims:
                placed[new] = dims[n.name]
        elif n.target is aten._assert_tensor_metadata.default:
            continue
        else:
            kwargs = dict(n.kwargs)
            if "device" in kwargs:
                kwargs["device"] = d0
            args, new = arg(n.args), None
            dim = _blockwise_dim(n, env, placed) if n.target in _BLOCKWISE else None
            if dim is not None:
                new = graph.call_function(_each, (n.target, *args), arg(kwargs))
                placed[new] = dim
            elif n.target is aten.linear.default and placed.get(args[1]) is not None:
                x, w, b = whole(args[0]), args[1], (args[2] if len(args) > 2 else None)
                if placed[w] == 0:
                    new = graph.call_function(_linear_col, (
                        x, w, b, b is not None and placed.get(b) is not None, devices))
                else:
                    new = graph.call_function(_linear_row, (
                        x, w, None if b is None else whole(b), devices))
            elif n.target is flash_op:
                new = graph.call_function(_flash_heads, (
                    *(whole(u) for u in args[:3]), args[3], devices))
            if new is None:
                new = graph.create_node(n.op, n.target, fx.map_arg(args, whole),
                                        fx.map_arg(arg(kwargs), whole), n.name)
        new.meta = dict(n.meta)
        env[n] = new
    graph.lint()
    return fx.GraphModule(gm, graph)


def _program_tensors(program) -> dict:
    """An ExportedProgram's parameters, buffers and lifted constants by
    their target names."""
    return {**program.state_dict, **program.constants}


def _artifact_program(art, program, mesh, rules):
    """A loaded artifact (``export.ExportedPredictor``) on a model axis,
    as the JAX package serves its exported program there.

    A float artifact's weights are constants of its program (the JAX
    package's leaf tree is empty): each row's first device runs the
    whole program on its data shard (``program.replicate`` on another
    device), weight bytes 0.  An int8 artifact's weight leaves are its
    program's buffers: the meta's ``int8_leaves`` record names them in
    the JAX package's weight-list order, the list is placed by that
    package's generated table (``alternating_rules(leaf_list,
    in_out=True)``, or ``rules``) on flax's layout, each buffer takes its
    leaf's spec through its ``perm`` and each scale its buffer's where it
    spans the split dim, and every row runs the artifact's own graph
    rewritten by :func:`_row_graph`: each device keeps only its blocks of
    the split leaves."""
    from har_tpu_torch.export import pad_to_packs
    from har_tpu_torch.serve.dispatch import _canonical

    if not art.int8_weights:
        def row_forward(row):
            if _canonical(row.devices[0]) == _canonical(program.device):
                return program.forward
            return program.replicate(row.devices[0])

        table = alternating_rules([]) if rules is None else rules
        return TPProgram(row_forward, {}, {}, mesh, table)
    record = art.meta.get("int8_leaves")
    if record is None:
        raise NoTensorParallelForward(
            f"the int8 artifact {art.path} holds no record of its weight leaves "
            "(written before it was kept): export it again to serve it on a model axis"
        )
    leaf_list = [torch.empty(r["shape"], dtype=getattr(torch, r["dtype"]), device="meta")
                 for r in record]
    tree = {str(k): t for k, t in enumerate(leaf_list)}
    table = alternating_rules(leaf_list, in_out=True) if rules is None else rules
    specs = dict(zip(tree, _specs(table, leaf_list, mesh)))
    ep = art.program
    tensors = _program_tensors(ep)
    leaves = {}
    for k, r in enumerate(record):
        spec = _padded(specs[str(k)], len(r["shape"]))
        split = any(e is not None for e in spec)
        if split and (len(r["buffers"]) != 1 or r["buffers"][0]["perm"] is None):
            raise NoTensorParallelForward(
                f"no tensor-parallel layout for {r['path']!r}: its buffers do not "
                "permute the whole leaf"
            )
        for b in r["buffers"]:
            own = tuple(spec[p] for p in b["perm"]) if split else ()
            leaves[b["value"]] = (tensors[b["value"]], P(*own))
            if b["scale"] is not None:
                scale = tensors[b["scale"]]
                leaves[b["scale"]] = (scale, P(*(e if scale.shape[d] > 1 else None
                                                 for d, e in enumerate(own))))
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(TP_AXIS, 1)
    flash_op = torch.ops.har_tpu_torch.flash_attention_fwd.default
    for n in ep.graph_module.graph.nodes:
        if n.target is flash_op and n.args[0].meta["val"].shape[2] % tp:
            raise NotModelParallel(
                f"num_heads {n.args[0].meta['val'].shape[2]} not divisible by "
                f"mesh axis {TP_AXIS!r}={tp}"
            )
    inputs = [(spec.arg.name, spec.kind, spec.target)
              for spec in ep.graph_signature.input_specs]
    # the artifact's JSON meta, read when the scorer is built
    # harlint: host-ok
    pack = int(art.meta.get("window_pack", 1))

    def row_forward(row):
        from torch.export.graph_signature import InputKind

        d0 = row.devices[0]
        dims = {}
        for name, _, target in inputs:
            if target in leaves:
                dims[name] = next((d for d, e in enumerate(tuple(leaves[target][1]))
                                   if e is not None), None)
        gm = _row_graph(ep.graph_module, dims, row.devices)
        args = [None if kind == InputKind.USER_INPUT
                else list(row.leaves[target]) if target in leaves
                else tensors[target].to(d0)
                for _, kind, target in inputs]
        slot = next(i for i, (_, kind, _) in enumerate(inputs) if kind == InputKind.USER_INPUT)

        def call(x):
            return gm(*args[:slot], x, *args[slot + 1:])

        fn = pad_to_packs(call, pack) if pack > 1 else call
        return lambda x: fn(x)[0]

    return TPProgram(row_forward, tree, specs, mesh, table, leaves)


def tp_program(model, program, mesh, rules=None) -> TPProgram:
    """The tensor-parallel program of a served model on ``mesh``.
    ``program`` is the model's ``dispatch.DeviceProgram``; ``rules``
    overrides the family's table.  Raises :class:`NotModelParallel` for
    a layout whose sharded dims do not divide the mesh or heads that do
    not divide ``tp``, and :class:`NoTensorParallelForward` for a
    program with no tensor-parallel forward here."""
    from har_tpu_torch.models.neural import MLP, BiLSTM, CNN1D
    from har_tpu_torch.quantize import Int8Forward
    from har_tpu_torch.serve.loadgen import _DemoMLP

    fwd = program.forward
    if isinstance(fwd, Int8Forward):
        if isinstance(fwd.core.module, _DemoMLP) and hasattr(model, "stored"):
            return _int8_demo(model, mesh, rules)
        if getattr(model, "paths", None) is not None:
            return _int8_neural(model, fwd, mesh, rules)
        raise NoTensorParallelForward(f"{type(model).__name__}'s int8 program has no "
                                      "tensor-parallel forward")
    if not isinstance(fwd, nn.Module):
        art = getattr(program.owner, "art", None)
        if art is None:
            raise NoTensorParallelForward(f"{type(model).__name__}'s program has no "
                                          "tensor-parallel forward")
        return _artifact_program(art, program, mesh, rules)
    transformer = False
    if isinstance(fwd, _DemoMLP):
        # the demo keeps JAX's (in, out) weights: its table is read on
        # the (out, in) layout every other family has
        tree = {"w1": fwd.w1.detach().t(), "b1": fwd.b1.detach(), "w2": fwd.w2.detach().t()}
        row_forward = lambda row: functools.partial(_demo_forward, row)  # noqa: E731
        table = rules_for_params(tree)
    else:
        tree = {k: v.detach() for k, v in fwd.named_parameters()}
        transformer = _transformer_shaped(fwd, tree)
        if not (transformer or isinstance(fwd, (MLP, CNN1D, BiLSTM))):
            raise NoTensorParallelForward(
                f"{type(fwd).__name__} has no tensor-parallel forward"
            )
        if getattr(fwd, "sp_axis", None) is not None:
            raise NoTensorParallelForward("a sequence-sharded transformer has no "
                                          "tensor-parallel forward")
        row_forward = functools.partial(_placed_module, fwd)
        # a transformer's table keys on names; the other families' is
        # generated over their flax tree, as the JAX package's is
        table = (rules_for_params(tree) if transformer
                 else alternating_rules(tree, walk=_flax_walk(fwd)))
    table = table if rules is None else rules
    specs = _specs(table, tree, mesh)
    for name, spec in specs.items():
        if tree[name].dim() == 2:
            _kind(spec, 2)
    if transformer:
        _check_heads(fwd, mesh)
    return TPProgram(row_forward, tree, specs, mesh, table)
