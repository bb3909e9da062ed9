"""Communicators: the rank group a call runs over.

``comm_id`` is derived from the membership (+ ``key``), so every member
computes the same id without a handshake: the reference's crc32 of the
global ranks and the key, so the two packages agree on every id. A
communicator splits into sub-communicators (:meth:`Communicator.split`),
grows (:func:`grown_communicator`) and may be revoked (the driver then
refuses calls on it). The port's ranks share one controller and have no
address: a :class:`Rank` holds its device and global rank only.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Sequence


@dataclasses.dataclass
class Rank:
    """Per-peer state within a communicator."""

    device: Any = None     # torch.device of the rank's tensors
    global_rank: int = -1  # world rank; the comm-local rank is this
    #                        Rank's index in Communicator.ranks


@dataclasses.dataclass
class Communicator:
    """A group of ranks with a distinguished local rank."""

    ranks: list[Rank]
    local_rank: int
    comm_id: int | None = None
    key: int = 0
    mesh_axis: str | None = None  # the mesh axis name when bound to a mesh
    # set by ACCL.revoke: the driver refuses further calls on it (rank-
    # local, like the failure it answers); splits never inherit it
    revoked: bool = False

    def __post_init__(self):
        for i, r in enumerate(self.ranks):
            if r.global_rank < 0:
                r.global_rank = i
        if self.comm_id is None:
            members = ",".join(str(r.global_rank) for r in self.ranks)
            self.comm_id = zlib.crc32(f"{members}#{self.key}".encode())

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def my_global_rank(self) -> int:
        return self.ranks[self.local_rank].global_rank

    def split(self, members: Sequence[int], new_local: int | None = None,
              key: int = 0) -> "Communicator":
        """The sub-communicator of the comm-local ranks ``members``."""
        sub = [dataclasses.replace(self.ranks[m]) for m in members]
        if new_local is None:
            if self.local_rank not in members:
                raise ValueError("local rank not in sub-communicator")
            new_local = list(members).index(self.local_rank)
        return Communicator(ranks=sub, local_rank=new_local,
                            mesh_axis=self.mesh_axis, key=key)

    def describe(self) -> str:
        """Human-readable dump (the reference's ``dump_communicator``,
        with the fields a port rank has)."""
        lines = [f"Communicator {self.comm_id}: size={self.size} "
                 f"local_rank={self.local_rank} mesh_axis={self.mesh_axis}"
                 + (" revoked" if self.revoked else "")]
        for i, r in enumerate(self.ranks):
            lines.append(f"  rank {i}: global_rank={r.global_rank}"
                         + (f" device={r.device}" if r.device is not None
                            else ""))
        return "\n".join(lines)


def grown_communicator(rank_records: Sequence[Rank], my_global_rank: int,
                       mesh_axis: str | None = None,
                       key: int = 0) -> Communicator:
    """A grown communicator from per-member Rank records, ordered by
    global rank, so every member, survivor or joiner, derives the same
    numbering and comm id."""
    by_g: dict[int, Rank] = {}
    for r in rank_records:
        if r.global_rank < 0:
            raise ValueError("grown members need explicit global ranks")
        by_g.setdefault(r.global_rank, r)
    ranks = [dataclasses.replace(by_g[g]) for g in sorted(by_g)]
    local = next((i for i, r in enumerate(ranks)
                  if r.global_rank == my_global_rank), None)
    if local is None:
        raise ValueError(f"local global rank {my_global_rank} is not a "
                         f"member of the grown communicator "
                         f"{sorted(by_g)}")
    return Communicator(ranks=ranks, local_rank=local,
                        mesh_axis=mesh_axis, key=key)
