"""The rank group: W virtual ranks on one torch device.

The counterpart of ``accl_tpu/parallel/mesh.py``'s ``make_mesh`` /
``cpu_mesh``. The JAX tier has one SPMD controller over a device mesh;
this port keeps the single controller and places all W ranks on one
device (``cuda:0`` by default), each rank's operand its own tensor.
"""

from __future__ import annotations

import dataclasses

import torch


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
