"""Rank groups and named-axis rank meshes: W virtual ranks on one device.

The counterpart of ``accl_tpu/parallel/mesh.py``. The JAX tier has one
SPMD controller over a device mesh; this port keeps the single
controller and places all W ranks on one device (``cuda:0`` by
default), each rank's operand its own tensor. :class:`RankGroup` is one
axis of ranks (what the collectives run over); :class:`RankMesh` lays
the ranks out on named axes (``make_mesh`` / ``cpu_mesh``), as the
reference's ``Mesh`` does with devices, and ``group(axis)`` gives the
ranks of one axis. ``mesh_from_communicator`` / ``communicator_from_mesh``
bind a communicator's ranks to a 1-D mesh and back.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..communicator import Communicator, Rank


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. ``"cuda"`` (the default)
    raises when CUDA is unavailable: nothing quietly falls back to the
    CPU. Pass ``"cpu"`` explicitly for the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """W ranks sharing one torch device."""

    size: int
    device: torch.device


def make_group(world_size: int, device="cuda") -> RankGroup:
    if world_size < 1:
        raise ValueError("a rank group needs at least one rank")
    return RankGroup(int(world_size), resolve_device(device))


class RankMesh:
    """Ranks laid out on named axes, all on one device. ``shape`` maps
    each axis name to its size (in axis order, as the reference's
    ``Mesh.shape``); ``size`` is the number of ranks. Rank ``i`` of the
    mesh is index ``i`` of the row-major flattening of ``shape``."""

    def __init__(self, shape, axis_names, device):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names {axis_names} repeat")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.size = math.prod(shape)
        self.device = torch.device(device)

    def group(self, axis: str) -> RankGroup:
        """The ranks along ``axis`` (one group per index of the other
        axes; all share the mesh's device)."""
        if axis not in self.shape:
            raise ValueError(f"axis {axis!r} not in mesh "
                             f"{tuple(self.shape)}")
        return RankGroup(self.shape[axis], self.device)

    def groups(self, axis: str) -> list[list[int]]:
        """The flattened rank indices of each group along ``axis``: one
        list for each index of the other axes (in their row-major
        order), ordered by the position along ``axis``."""
        if axis not in self.shape:
            raise ValueError(f"axis {axis!r} not in mesh "
                             f"{tuple(self.shape)}")
        ids = torch.arange(self.size).reshape(tuple(self.shape.values()))
        k = self.axis_names.index(axis)
        return ids.movedim(k, -1).reshape(-1, self.shape[axis]).tolist()

    def __repr__(self):
        return f"RankMesh({self.shape}, device={self.device})"


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...] = ("rank",),
              device="cuda") -> RankMesh:
    """A mesh of ``prod(shape)`` ranks on one device (``"cuda"`` by
    default, which raises without CUDA)."""
    return RankMesh(shape, axis_names, resolve_device(device))


def cpu_mesh(n: int = 8, shape: tuple[int, ...] | None = None,
             axis_names: tuple[str, ...] = ("rank",)) -> RankMesh:
    """A mesh of (at most) ``n`` ranks on the CPU: the plain versions."""
    shape = shape or (n,)
    if math.prod(shape) > n:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, have {n}")
    return make_mesh(shape, axis_names, "cpu")


def mesh_from_communicator(comm: Communicator, axis_name: str = "rank",
                           device="cuda") -> RankMesh:
    """Bind a communicator to a 1-D mesh: rank i of the communicator is
    rank i of the mesh. Ranks without a device get ``device`` (resolved
    only then); the ranks must share one device."""
    if any(r.device is None for r in comm.ranks):
        dev = resolve_device(device)
        for r in comm.ranks:
            if r.device is None:
                r.device = dev
    devices = sorted({str(torch.device(r.device)) for r in comm.ranks})
    if len(devices) != 1:
        raise ValueError(f"a rank mesh lies on one device; the "
                         f"communicator's ranks are on {devices}")
    comm.mesh_axis = axis_name
    return RankMesh((comm.size,), (axis_name,), devices[0])


def communicator_from_mesh(mesh: RankMesh, axis_name: str = "rank",
                           local_rank: int = 0) -> Communicator:
    """The inverse binding: a communicator whose ranks are the mesh's
    ranks (row-major over its axes), all on the mesh's device."""
    ranks = [Rank(device=mesh.device, global_rank=i)
             for i in range(mesh.size)]
    return Communicator(ranks=ranks, local_rank=local_rank,
                        mesh_axis=axis_name)
