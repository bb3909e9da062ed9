"""Models on the port's kernels: the Llama (dense or Mixtral-style
mixture of experts) and the expert block with its expert-parallel
entry."""

from .llama import Llama, LlamaConfig
from .moe import MoEConfig, MoELayer, moe_apply_sharded

__all__ = ["Llama", "LlamaConfig", "MoEConfig", "MoELayer",
           "moe_apply_sharded"]
