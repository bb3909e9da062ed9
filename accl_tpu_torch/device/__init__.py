"""Device backends: the abstract interface and the CUDA tier."""

from .base import Device

__all__ = ["Device"]
