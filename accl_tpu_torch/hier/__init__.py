"""Sharding specs and the array-redistribution compiler.

:class:`ShardSpec` lays a 1-D global vector out over a communicator's
ranks (block, even, balanced, cyclic, block-cyclic, replicated);
:func:`plan_redistribute` lowers a change of spec to the least program
it admits, which ``ACCL.redistribute`` issues, and
:func:`redistribute_oracle` is the serial gather-reshard-scatter result
every execution must equal. The port of ``accl_tpu/hier``'s sharding and
redistribution modules; the N-tier hierarchy is not ported yet.
"""

from .redistribute import (RedistPlan, RedistStep, plan_redistribute,
                           redistribute_oracle)
from .sharding import ShardSpec

__all__ = ["ShardSpec", "plan_redistribute", "redistribute_oracle",
           "RedistPlan", "RedistStep"]
