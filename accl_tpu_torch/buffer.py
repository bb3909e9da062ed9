"""Buffers: tensors registered with a rank's device backend.

A buffer is either

* a **host-mirror** buffer: a CPU tensor; calls stage it to the rank's
  device and back (the default), or
* a **device-resident** buffer: a tensor on the rank's device
  (``.tensor``); calls read and write it in place with no host copy (the
  reference's ``to_from_fpga=False`` mode).

Calls pass integer addresses (4 KiB aligned, like the reference's
SimBuffer); the backend resolves an address back to its buffer.
``.data`` returns numpy where numpy has the dtype (a view of a host
mirror, a fresh snapshot of a device-resident tensor), else a CPU tensor.
"""

from __future__ import annotations

import math
import threading
from typing import Any

import torch

_ALIGNMENT = 4096
_alloc_lock = threading.Lock()
_next_page = 1

# dtypes numpy cannot hold
_NO_NUMPY = {torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2}


def _alloc_addr(nbytes: int) -> int:
    """Fake physical address allocator, 4 KiB aligned, thread-safe."""
    global _next_page
    pages = max(1, -(-nbytes // _ALIGNMENT))
    with _alloc_lock:
        page = _next_page
        _next_page += pages
    return page * _ALIGNMENT


def to_numpy(t: torch.Tensor):
    """numpy view/copy of a tensor where numpy has its dtype, else the
    CPU tensor itself."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    return t if t.dtype in _NO_NUMPY else t.numpy()


class ACCLBuffer:
    """A tensor registered with a device backend (see module docstring).

    ``tensor`` is the storage; ``device_resident`` says whether calls
    operate on it in place on the rank's device (True) or stage it
    through the host (False, ``tensor`` is then a CPU tensor)."""

    def __init__(self, tensor: torch.Tensor, device: Any = None,
                 device_resident: bool = False,
                 address: int | None = None):
        if not tensor.is_contiguous():
            raise ValueError("buffers must be contiguous tensors")
        if not device_resident and tensor.device.type != "cpu":
            raise ValueError("host-mirror buffers hold CPU tensors")
        self._t = tensor
        self._resident = bool(device_resident)
        self._shape = tuple(tensor.shape)
        self._dtype = tensor.dtype
        self._size = math.prod(self._shape)
        self.device = device
        self.address = (address if address is not None
                        else _alloc_addr(self.nbytes))
        if device is not None:
            device.register_buffer(self)

    @property
    def is_device_resident(self) -> bool:
        return self._resident

    @property
    def tensor(self) -> torch.Tensor:
        """The live device tensor (device-resident buffers only)."""
        if not self._resident:
            raise ValueError("not a device-resident buffer; use .data")
        return self._t

    @property
    def storage(self) -> torch.Tensor:
        """The backing tensor, host mirror or device tensor alike."""
        return self._t

    @property
    def data(self):
        """numpy view of a host mirror (writes reach the buffer) or a
        fresh snapshot of a device tensor; a CPU tensor where numpy has
        no such dtype."""
        return to_numpy(self._t)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def size(self) -> int:
        return self._size

    @property
    def nbytes(self) -> int:
        return self._t.element_size() * self._size

    def __len__(self) -> int:
        return self._shape[0]

    def free_buffer(self):
        if self.device is not None:
            self.device.deregister_buffer(self)

    def __repr__(self):
        kind = "dev" if self._resident else "host"
        return (f"ACCLBuffer(shape={self.shape}, "
                f"dtype={str(self.dtype).removeprefix('torch.')}, "
                f"addr=0x{self.address:x}, {kind})")
