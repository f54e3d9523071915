"""Device meshes over ``torch.distributed`` process groups.

Port of ``har_tpu/parallel/mesh.py``.  A JAX mesh is single-controller: one
process lays every device of ``jax.devices()`` on a grid.  Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
spans it, one rank per device (``nccl`` for CUDA, ``gloo`` for the CPU),
with the axis names ``("dp", "tp")`` or, for the hybrid layout,
``("dp_dcn", "dp", "tp")``.  Every rank runs the same program; a rank's
place on the grid is its coordinate in the mesh.

- :func:`create_mesh` and :func:`create_multihost_mesh` need a process
  group whose world size equals the grid's size (start the ranks with
  ``--distributed`` or ``torchrun``); :func:`single_device_mesh` starts a
  one-rank group when none is running.
- :func:`data_shard_count` and :func:`model_shard_count` read the mesh's
  shape only (a ``DeviceMesh`` or a mapping of axis name to size): no
  collective runs.
- :func:`use_mesh` makes a mesh current, so modules that name a mesh axis
  (``Transformer1D(sp_axis=...)``) find its group with :func:`axis_group`,
  as a JAX axis name is bound inside ``shard_map``.

Serving is single-controller, as in the JAX package: one engine process
drives every device.  Its mesh is a :class:`ServingMesh`, a ``(dp, tp)``
grid of ``torch.device`` objects with no process group and no
collective (:func:`create_serving_mesh`, the counterpart of JAX's
``create_mesh(dp, tp, devices=)``).  An entry may repeat: the CPU tests
lay 2×4 over torch's one ``cpu`` device, as JAX's dry-run mesh splits the
host, and one card can hold a 2×2 layout.  :func:`serving_devices` picks
the devices: distinct visible cards on CUDA, the CPU repeated on the CPU.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"
DP_DCN_AXIS = "dp_dcn"

RANK_HINT = (
    "start one process per device with `har train --distributed "
    "--coordinator HOST:PORT --num-processes N --process-id I` or with "
    "`torchrun --nproc-per-node N`"
)


def _device_type(device) -> str:
    return torch.device(device).type if device is not None else "cuda"


def backend_for(device_type: str) -> str:
    """The collective backend of a device type: NCCL on CUDA, gloo on the
    CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def world_size() -> int:
    """Ranks in the default process group (1 when none is running)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _init_mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise ValueError(
                f"a mesh of shape {dict(zip(names, shape))} needs "
                f"{math.prod(shape)} ranks and no process group is running: "
                + RANK_HINT
            )
        _init_one_rank_group(device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _init_one_rank_group(device_type: str) -> None:
    """A world of one, rendezvous in memory."""
    dist.init_process_group(
        backend_for(device_type), store=dist.HashStore(), rank=0, world_size=1
    )


def create_mesh(dp: int = -1, tp: int = 1, device=None):
    """A 2-D ``(dp, tp)`` mesh over every rank of the process group.

    ``dp=-1`` takes every rank left after ``tp``.  ``tp`` ranks are
    adjacent (the fastest-varying axis), so tensor-parallel collectives
    stay between neighbouring devices.  ``device`` (default CUDA) picks the
    mesh's device type."""
    n = world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} must divide device count {n}")
    if dp == -1:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(
            f"dp*tp={dp * tp} != device count {n} (the ranks of the process "
            "group): " + RANK_HINT
        )
    return _init_mesh(_device_type(device), (dp, tp), (DP_AXIS, TP_AXIS))


def create_multihost_mesh(num_slices: int, tp: int = 1, device=None):
    """A 3-D ``(dp_dcn, dp, tp)`` mesh: slices outermost, so data
    parallelism across slices reduces once per step while tensor
    parallelism stays on the innermost axis.  Ranks are ordered
    slice-major."""
    n = world_size()
    if num_slices < 1 or n % num_slices:
        raise ValueError(f"num_slices={num_slices} must divide device count {n}")
    per_slice = n // num_slices
    if tp < 1 or per_slice % tp:
        raise ValueError(f"tp={tp} must divide per-slice device count {per_slice}")
    return _init_mesh(
        _device_type(device), (num_slices, per_slice // tp, tp),
        (DP_DCN_AXIS, DP_AXIS, TP_AXIS),
    )


class ServingMesh:
    """A single-controller mesh: a grid of ``torch.device`` objects with
    named axes (``("dp", "tp")``), read as a ``DeviceMesh`` is read
    (``mesh_dim_names``, ``shape``) but holding no process group: the
    engine process places and launches on every device itself."""

    def __init__(self, grid, axis_names=(DP_AXIS, TP_AXIS)):
        import numpy as np

        cells = np.empty(np.shape(grid)[: len(axis_names)], dtype=object)
        for idx in np.ndindex(cells.shape):
            cells[idx] = torch.device(np.asarray(grid, dtype=object)[idx])
        if cells.ndim != len(axis_names) or cells.size == 0:
            raise ValueError(
                f"a serving mesh needs a non-empty {len(axis_names)}-D device "
                f"grid for axes {axis_names}"
            )
        self.devices = cells
        self.mesh_dim_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in cells.shape)

    def __repr__(self) -> str:
        cells = ", ".join(str(d) for d in self.devices.flat)
        return f"ServingMesh({dict(zip(self.mesh_dim_names, self.shape))}, [{cells}])"


def create_serving_mesh(dp: int = -1, tp: int = 1, devices=None, device=None) -> ServingMesh:
    """A ``(dp, tp)`` serving mesh over ``devices`` (default: every
    device :func:`serving_devices` finds for ``device``), the JAX
    package's ``create_mesh`` rules: ``dp=-1`` takes every device left
    after ``tp``, and ``tp`` devices are adjacent (the fastest-varying
    axis)."""
    import numpy as np

    devices = serving_devices(-1, device) if devices is None else list(devices)
    n = len(devices)
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} must divide device count {n}")
    if dp == -1:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != device count {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return ServingMesh(grid.reshape(dp, tp))


def serving_devices(n: int, device=None) -> list:
    """``n`` devices for a serving mesh (``-1``: as many as there are).

    On CUDA, distinct visible cards ``cuda:0 … cuda:n-1``; a ``ValueError``
    names the shortfall when fewer are visible.  On the CPU, torch's one
    ``cpu`` device repeated ``n`` times (``-1``: once), as the JAX
    package's dry-run mesh splits the host."""
    dev = torch.device(_device_type(device))
    if dev.type == "cpu":
        return [torch.device("cpu")] * (1 if n == -1 else int(n))
    count = torch.cuda.device_count()
    n = count if n == -1 else int(n)
    if n > count:
        raise ValueError(f"needs {n} devices but only {count} are visible")
    return [torch.device("cuda", i) for i in range(n)]


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`ServingMesh`,
    or the mapping itself."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def data_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes present in a mesh, outermost (DCN) first."""
    shape = mesh_shape(mesh)
    return tuple(a for a in (DP_DCN_AXIS, DP_AXIS) if a in shape)


def data_shard_count(mesh) -> int:
    """How many ways the batch dimension splits on this mesh."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in data_axes(mesh))


def model_shard_count(mesh) -> int:
    """How many ways the model (hidden) dimension splits: the ``tp``
    extent, 1 when the mesh has no model axis."""
    # host-side mesh-shape arithmetic (a dict of ints), evaluated once
    # at scorer construction — no device value is touched
    # harlint: host-ok
    return int(mesh_shape(mesh).get(TP_AXIS, 1))


def linear_data_shard_index(mesh) -> int:
    """This rank's linear data-shard id across every data axis,
    slice-major (the order :func:`create_multihost_mesh` lays out)."""
    shape = mesh_shape(mesh)
    idx = mesh.get_local_rank(DP_AXIS) if DP_AXIS in shape else 0
    if DP_DCN_AXIS in shape:
        idx = mesh.get_local_rank(DP_DCN_AXIS) * shape.get(DP_AXIS, 1) + idx
    return idx


def data_groups(mesh) -> list:
    """The process groups of the data axes, outermost first: a sum over
    each in turn is a sum over every data shard."""
    if mesh is None:
        return []
    return [mesh.get_group(a) for a in data_axes(mesh) if mesh_shape(mesh)[a] > 1]


def linear_mesh(n: int, axis: str, device=None):
    """A 1-D mesh over ``n`` ranks with one named axis (``-1``: all)."""
    world = world_size()
    if n == -1:
        n = world
    if n != world:
        raise ValueError(
            f"{axis}={n} needs the process group's {world} ranks exactly: "
            + RANK_HINT
        )
    return _init_mesh(_device_type(device), (n,), (axis,))


def single_device_mesh(device=None):
    """A 1x1 ``(dp, tp)`` mesh, so every code path can be mesh-shaped on
    one device; starts a one-rank group when none is running."""
    return create_mesh(dp=1, tp=1, device=device)


_CURRENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current inside the block (:func:`axis_group`)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    return _CURRENT[-1] if _CURRENT else None


def resolve_group(axis):
    """A process group given as itself or named by a mesh axis of the
    current mesh (:func:`axis_group`)."""
    return axis_group(axis) if isinstance(axis, str) else axis


def axis_group(axis: str):
    """The process group of mesh axis ``axis`` in the current mesh."""
    mesh = current_mesh()
    if mesh is None or axis not in mesh_shape(mesh):
        raise ValueError(
            f"mesh axis {axis!r} is not bound: run inside "
            "`with parallel.use_mesh(mesh):` over a mesh that names it"
        )
    return mesh.get_group(axis)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> torch.device:
    """Join the process group of a multi-process run (once per process,
    before any mesh is built) and return this rank's device.

    The arguments default to torchrun's environment: ``MASTER_ADDR`` /
    ``MASTER_PORT`` (the coordinator), ``WORLD_SIZE`` and ``RANK``.  On
    CUDA the rank binds ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to
    the process id), and the group's backend is NCCL; on the CPU, gloo.
    """
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a distributed run needs a coordinator, a process count and a "
            "process id: pass --coordinator/--num-processes/--process-id or "
            "run under torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, {num_processes})")
    device_type = _device_type(device)
    dev = torch.device(device_type)
    if device_type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    dist.init_process_group(
        backend_for(device_type),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    return dev
