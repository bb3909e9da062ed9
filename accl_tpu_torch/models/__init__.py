"""Models on the port's kernels: the Llama serving path."""

from .llama import Llama, LlamaConfig

__all__ = ["Llama", "LlamaConfig"]
