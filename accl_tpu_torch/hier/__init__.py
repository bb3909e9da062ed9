"""N-tier hierarchical collectives, sharding specs and the array-
redistribution compiler: the port of ``accl_tpu/hier``.

* :class:`~accl_tpu_torch.hier.topology.MeshTopology` — a nested-tier
  link descriptor (per-tier alpha/beta from a rank->host mapping plus
  optional coarser :class:`~accl_tpu_torch.hier.topology.TierSpec`
  boundaries) the tuner's cost models price against;
* :class:`~accl_tpu_torch.hier.engine.Hierarchy` — the driver-level
  lowering of ``CollectiveAlgorithm.HIERARCHICAL`` to waitfor-chained
  phase programs of flat collectives over per-tier sub-communicators,
  recursively over the nest, with a per-tier quantize predicate
  (``compress_phases``); :func:`plan_phases` is its pure planner;
* :class:`ShardSpec` lays a 1-D global vector out over a communicator's
  ranks; :func:`plan_redistribute` lowers a change of spec to the least
  program it admits, which ``ACCL.redistribute`` issues, and
  :func:`redistribute_oracle` is the serial gather-reshard-scatter
  result every execution must equal.
"""

from .engine import Hierarchy, Phase, phase_tier_level, plan_phases
from .redistribute import (RedistPlan, RedistStep, plan_redistribute,
                           redistribute_oracle)
from .sharding import ShardSpec
from .topology import (MeshTopology, TierSpec, groups_from_hosts,
                       validate_nest)

__all__ = [
    "MeshTopology", "TierSpec", "groups_from_hosts", "validate_nest",
    "Hierarchy", "plan_phases", "Phase", "phase_tier_level",
    "ShardSpec", "plan_redistribute", "redistribute_oracle",
    "RedistPlan", "RedistStep",
]
