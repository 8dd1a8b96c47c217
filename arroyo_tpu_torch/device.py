"""Device resolution for the port's entry points.

``LocalRunner`` and ``KeyedBinState`` take ``device=None``, which means
the CUDA device.  A caller who wants the host passes ``device="cpu"``
(the CPU tests do).  Asking for CUDA on a machine without it raises: the
port never moves to the CPU on its own, so a run that claims the card
really ran there.

``LocalRunner`` also takes a sequence of devices: the devices of its key
mesh (``parallel/mesh_window.py``), one key shard on each entry, the first
the runner's device for everything else.  A device may repeat — the port's
counterpart of the JAX tests' forced host device count — so the CPU tests
run the mesh at 2, 4 and 8 shards and one card holds four."""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]
# a device, or the devices of a key mesh (``LocalRunner(device=...)``)
DevicesLike = Union[DeviceLike, Sequence[Union[str, torch.device]]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def is_sequence(device: DevicesLike) -> bool:
    return isinstance(device, (list, tuple))


def resolve_devices(device: DevicesLike = None) -> List[torch.device]:
    """A device or a sequence of devices as a list of devices, each
    checked as :func:`resolve_device` checks one.  An entry may repeat:
    the mesh then holds several logical shards on that device."""
    if not is_sequence(device):
        return [resolve_device(device)]
    if not device:
        raise ValueError("an empty device sequence")
    return [resolve_device(d) for d in device]


def mesh_devices(device: DevicesLike = None) -> List[torch.device]:
    """The devices of a runner's key mesh: the sequence itself when one
    is given, else the distinct visible devices of the device's type
    (every CUDA card; the CPU once)."""
    if is_sequence(device):
        return resolve_devices(device)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def on_device(dev: torch.device):
    """The context under which launches for ``dev`` run: the card made
    current (``build.launch`` refuses tensors on another card), nothing
    on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# a readback at least this large goes through pinned host memory
PINNED_READ_BYTES = 1 << 16


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as a numpy array, in one device-to-host copy.
    A large buffer lands in pinned memory from PyTorch's caching host
    allocator: a fresh pageable buffer of tens of megabytes comes from
    mmap and faults in every page during the copy (20x slower at 42 MB
    on an H100 host, PERF.md)."""
    if t.device.type != "cuda" or t.numel() * t.element_size() < \
            PINNED_READ_BYTES:
        return t.cpu().numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


# the dtypes the port uploads (kernel buffers ride u8/i32/i64 words;
# SQL expressions upload their columns' own dtypes)
_TORCH_DTYPES = {np.dtype(np.bool_): torch.bool,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` as a tensor on ``device``.  On the card: one non-blocking
    host-to-device copy from a pinned buffer of PyTorch's caching host
    allocator, filled through its numpy view, so the upload does not
    hold the host (a copy from pageable memory synchronizes the stream).
    The allocator records the copy's event and hands the buffer out again
    only after the copy has landed.  On the CPU: a plain copy (pinning
    needs CUDA)."""
    if device.type != "cuda":
        return torch.tensor(arr)
    host = torch.empty(arr.shape, dtype=_TORCH_DTYPES[np.dtype(arr.dtype)],
                       pin_memory=True)
    host.numpy()[...] = arr
    return host.to(device, non_blocking=True)
