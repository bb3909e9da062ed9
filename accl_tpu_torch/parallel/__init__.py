"""The dataplane: dense collectives over W ranks on one device."""

from .collectives import RankCollectives
from .mesh import RankGroup, make_group

__all__ = ["RankCollectives", "RankGroup", "make_group"]
