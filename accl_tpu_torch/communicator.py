"""Communicators: the rank group a call runs over.

``comm_id`` is derived from the membership (+ ``key``), so every member
computes the same id without a handshake.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any


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
