"""The dataplane: collectives over W ranks on one device."""

from .collectives import RankCollectives
from .mesh import RankGroup, make_group
from .tree import Tree2DCollectives

__all__ = ["RankCollectives", "RankGroup", "Tree2DCollectives", "make_group"]
