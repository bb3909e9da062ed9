"""Multi-slice meshes: the DCN tier of the fabric, over rank rows.

The counterpart of ``accl_tpu/parallel/multislice.py``. A slice's ranks
share a fast fabric (ICI on the TPU); slices meet over a slower one
(DCN). Here the ranks are virtual ranks on one device, as elsewhere in
:mod:`accl_tpu_torch.parallel`, and the slices are either all in this
process or one a process of a ``torch.distributed`` group:

* :func:`hybrid_mesh`: a :class:`HybridMesh` of shape ``(n_slices,
  *ici_shape)`` on axes ``(dcn_axis, *ici_axes)``. When ``n_slices``
  equals the size of an initialized process group, each process holds
  one slice (its rank's dcn row) and passes only its own rows.
* :func:`hierarchical_allreduce`: reduce-scatter inside each ici group
  (the ring: one B1 launch a hop), the owned shard reduced across the
  slices in a fixed slice order (B1, in the ``wire_dtype`` where one is
  given: a B2 cast down, B1 in the wire dtype, a B2 cast back; on an fp8
  wire a SUM folds in f16, as XLA's psum of fp8 does), then an
  allgather inside each ici group. Across processes the dcn hop moves
  the owned shards with ``all_gather`` over gloo, staged through pinned
  host memory as bytes, and the combine runs on this process's device.
* :func:`distributed_init`: ``torch.distributed`` over gloo from
  explicit arguments or torchrun's environment (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), where the reference reads
  ``JAX_COORDINATOR_ADDRESS``.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..arith import dtype_name, to_torch_dtype
from ..constants import ReduceFunc
from .collectives import (KERNELS, WIRE_LANE_NAMES, Kernels,
                          RankCollectives, ordered_fold, recast)
from .mesh import RankGroup, RankMesh, resolve_device

__all__ = ["HybridMesh", "hybrid_mesh", "hierarchical_allreduce",
           "hierarchical_allreduce_sharded", "distributed_init",
           "slice_count"]

# the dcn hop's wires: the per-tensor lanes' (f16, bf16, e4m3fn, e5m2),
# all of which B1 combines in; int8 is refused, as the lanes refuse it
DCN_WIRES = WIRE_LANE_NAMES
# the virtual ranks of a CPU process: the reference's 8-device CPU test
# mesh, and cpu_mesh's default
CPU_RANKS = 8


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize ``torch.distributed`` (gloo) for a multi-process run.

    Returns True if the process group is (or already was) initialized,
    False when running as one process: no arguments and no launcher
    environment (``MASTER_ADDR``). Arguments default to torchrun's
    ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``."""
    dist = _dist()
    if dist is None:
        raise RuntimeError("torch.distributed is not available")
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and num_processes is None \
            and "MASTER_ADDR" not in env:
        return False
    if coordinator_address is None:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def slice_count() -> int:
    """The number of processes (slices) of the initialized process group,
    1 when there is none."""
    dist = _dist()
    if dist is None or not dist.is_initialized():
        return 1
    return dist.get_world_size()


class HybridMesh(RankMesh):
    """A ``(dcn, *ici)`` :class:`RankMesh`. ``local_slice`` is None when
    every slice is in this process; across processes it is this process's
    dcn row, whose ranks alone it holds (``local_size`` of them)."""

    def __init__(self, shape, axis_names, device, local_slice=None):
        super().__init__(shape, axis_names, device)
        self.dcn_axis = axis_names[0]
        self.local_slice = local_slice
        self.local_size = (self.size if local_slice is None
                           else self.size // shape[0])

    def __repr__(self):
        where = ("" if self.local_slice is None
                 else f", local slice {self.local_slice}")
        return f"HybridMesh({self.shape}, device={self.device}{where})"


def hybrid_mesh(ici_shape: tuple[int, ...] | None = None,
                n_slices: int | None = None,
                ici_axes: tuple[str, ...] = ("ici",),
                dcn_axis: str = "dcn", device="cuda") -> HybridMesh:
    """A ``(n_slices, *ici_shape)`` mesh on axes ``(dcn_axis,
    *ici_axes)``, on ``device`` (``"cuda"`` by default, which raises
    without CUDA). ``n_slices`` defaults to :func:`slice_count`;
    ``ici_shape`` to ``CPU_RANKS`` ranks a process split over the slices.
    On the CPU a mesh holds at most ``CPU_RANKS`` ranks a process, as
    :func:`~accl_tpu_torch.parallel.cpu_mesh` does; on the card it holds
    any number. When ``n_slices`` is the size of an initialized process
    group of more than one process, each process holds its rank's
    slice."""
    dev = resolve_device(device)
    procs = slice_count()
    if n_slices is None:
        n_slices = procs
    spans = procs > 1 and n_slices == procs
    if ici_shape is None:
        per = CPU_RANKS if spans else CPU_RANKS // max(n_slices, 1)
        ici_shape = (per,)
    if len(ici_axes) != len(ici_shape):
        raise ValueError(
            f"ici_axes {ici_axes} must name every ici_shape axis "
            f"{ici_shape} (pass e.g. ici_axes=('x','y') for a 2-D slice)")
    per_slice = int(math.prod(ici_shape))
    need = per_slice if spans else n_slices * per_slice
    if dev.type == "cpu" and need > CPU_RANKS:
        raise ValueError(f"hybrid mesh {n_slices}x{ici_shape} needs "
                         f"{need} devices, have {CPU_RANKS}")
    local = _dist().get_rank() if spans else None
    return HybridMesh((n_slices,) + tuple(ici_shape),
                      (dcn_axis,) + tuple(ici_axes), dev, local)


def _local_groups(mesh: HybridMesh, axis: str) -> list[list[int]]:
    """``mesh.groups(axis)`` in the indices of the rows this process
    holds (the whole mesh, or its local slice's rows)."""
    groups = mesh.groups(axis)
    if mesh.local_slice is None:
        return groups
    lo = mesh.local_slice * mesh.local_size
    return [[r - lo for r in g] for g in groups
            if all(lo <= r < lo + mesh.local_size for r in g)]


def _exchange_slices(owned: torch.Tensor) -> torch.Tensor:
    """Every process's ``owned`` tensor, stacked in slice order: an
    all_gather over the process group, staged through (pinned) host
    memory as bytes."""
    dist = _dist()
    pin = owned.device.type == "cuda"
    raw = owned.contiguous().view(torch.uint8).reshape(-1)
    host = torch.empty(raw.numel(), dtype=torch.uint8, pin_memory=pin)
    host.copy_(raw)
    got = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(got, host)
    dev = torch.stack(got).to(owned.device)
    return dev.view(owned.dtype).reshape(len(got), *owned.shape)


def hierarchical_allreduce(rows, mesh: HybridMesh, ici_axis: str = "ici",
                           dcn_axis: str = "dcn",
                           func: ReduceFunc = ReduceFunc.SUM,
                           wire_dtype=None,
                           kernels: Kernels = KERNELS) -> torch.Tensor:
    """Two-level allreduce of the mesh's rank rows, minimizing dcn bytes.

    ``rows``: (R, n) or R tensors of n elements, rank i the row-major
    index of the mesh, R its size (or, across processes, this process's
    slice's ranks). Phase 1: a ring reduce-scatter inside each ici group
    leaves each rank shard i of its group's reduction, padded to a
    multiple of the ici size (the reference's ``psum_scatter`` for SUM;
    its full reduce and slice for MAX, MIN and PROD owns the same
    shard). Phase 2: the owned shard is reduced across the dcn groups in
    slice order (one launch a step; in ``wire_dtype`` where given, cast
    down and back with B2; an fp8 SUM folds in f16, see
    ``collectives.ordered_fold``). Phase 3: an allgather inside each ici
    group.
    Every rank gets the reduction over the ici and dcn axes. Returns a
    fresh (R, n) tensor."""
    if not isinstance(mesh, HybridMesh):
        raise TypeError("hierarchical_allreduce needs a hybrid_mesh")
    if mesh.dcn_axis != dcn_axis:
        raise ValueError(f"dcn axis {dcn_axis!r} is not the mesh's outer "
                         f"axis {mesh.dcn_axis!r}")
    func = ReduceFunc(func)
    rows = (list(rows) if not isinstance(rows, torch.Tensor)
            or rows.dim() > 1 else None)
    R = mesh.local_size
    if rows is None or len(rows) != R:
        raise ValueError(f"expected {R} rank rows")
    rows = [r.reshape(-1) for r in rows]
    n = rows[0].numel()
    W = mesh.shape[ici_axis]
    pad = (-n) % W
    if pad:
        rows = [F.pad(r, (0, pad)) for r in rows]
    c = (n + pad) // W
    dt = rows[0].dtype
    dev = rows[0].device
    wire = None if wire_dtype is None else dtype_name(wire_dtype)
    if wire == dtype_name(dt):
        wire = None
    if wire is not None and wire not in DCN_WIRES:
        raise NotImplementedError(
            f"a {wire} dcn wire: the hop takes {', '.join(DCN_WIRES)} "
            f"(a plain int8 cast truncates; the per-tensor lanes refuse "
            f"int8 too)")
    # phase 1: ring reduce-scatter inside each ici group
    owned = torch.empty((R, c), dtype=dt, device=dev)
    ici = _local_groups(mesh, ici_axis)
    coll = RankCollectives(RankGroup(W, dev), kernels)
    for g in ici:
        coll.reduce_scatter([rows[r] for r in g], func, "ring",
                            out=[owned[r] for r in g])
    # phase 2: the owned shards across the slices, in slice order
    k = kernels
    send = owned
    if wire is not None:    # one rounding to the wire (by f32 from f16/bf16)
        send = torch.empty((R, c), dtype=to_torch_dtype(wire), device=dev)
        recast(k, list(owned), send.dtype, list(send))
    if mesh.local_slice is None:
        S = mesh.shape[dcn_axis]
        per = R // S                   # a slice's rows: row-major, dcn outer
        shards = [list(send[s * per:(s + 1) * per]) for s in range(S)]
    else:
        per = R
        shards = [list(t) for t in _exchange_slices(send)]
    reduced = ordered_fold(shards, func, k)
    if wire is not None:
        reduced = recast(k, reduced, dt)
    # every slice's rank at the same ici position owns the same shard
    mine = [reduced[r % per] for r in range(R)]
    # phase 3: allgather inside each ici group
    full = torch.empty((R, n + pad), dtype=dt, device=dev)
    for g in ici:
        coll.allgather([mine[r] for r in g], "ring",
                       out=[full[r] for r in g])
    return full[:, :n].contiguous() if pad else full


def hierarchical_allreduce_sharded(x: torch.Tensor, mesh: HybridMesh,
                                   ici_axis: str = "ici",
                                   dcn_axis: str = "dcn",
                                   func: ReduceFunc = ReduceFunc.SUM,
                                   wire_dtype=None,
                                   kernels: Kernels = KERNELS
                                   ) -> torch.Tensor:
    """Rank-major form: ``x`` is (n_ranks, n), one row a rank of the mesh
    (of this process's slice, across processes); every rank gets the
    reduction. See :func:`hierarchical_allreduce`."""
    if x.shape[0] != mesh.local_size:
        raise ValueError(
            f"x must be rank-major with shape[0] == mesh size "
            f"({mesh.local_size}), got {tuple(x.shape)}")
    return hierarchical_allreduce(x, mesh, ici_axis, dcn_axis, func,
                                  wire_dtype, kernels)
