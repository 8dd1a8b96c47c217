"""K15 ``join_sort``: the stable ascending order of u64 keys and the keys
in that order — the legacy join layout's sort of each side's key hashes.

Replaces arroyo_tpu/ops/join.py:66 ``_sort_kernel`` (``jnp.argsort(keys,
stable=True)``, ``keys[order]``).

Key convention: a u64 key travels as the RAW BITS of an i64 tensor
(``np.uint64`` arrays viewed as ``np.int64``), and the kernel and its
plain version order those bits as UNSIGNED integers: a key at or above
2^63 (a negative i64) sorts after every key below it, and the padding
SENTINEL (all ones, -1 as i64) sorts last.  Equal keys keep their input
order.  The order is i64, as the JAX kernel returns it under x64.

On the H100 it is bound by memory: at least 24 bytes a key (read 8,
write 8 for the sorted keys and 8 for the order), 7.5 us at 1,048,576
keys.  The CUDA kernel (``csrc/join_sort.cu``) is a least-significant-
digit radix sort over the 8-bit digits that vary, stable because each
warp ranks its keys in order among equal digits (found by ballots, or
by a shared atomic on a match word), never by the order of atomics.  Up
to :data:`ONE_BLOCK_MAX` keys it is ONE launch of one block that keeps
the keys and an i32 order in shared memory; above, a onesweep sort: a
memset, one launch for all eight digit histograms and the varying-digit
word, then one launch a digit, whose tiles find their offsets by a
decoupled look-back and write each digit's run contiguously from shared
memory (passes of digits that do not vary return on the device: no host
sync).  The call works in ONE buffer
(:func:`join_sort` returns two views of it): one allocation, 0 syncs.

``join_sort_reference`` is the plain PyTorch version (the same
least-significant-digit passes over the digits that vary, each a stable
sort of one 8-bit digit); the wrapper takes it only for tensors on the
CPU."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

_SIGN = -(1 << 63)  # i64 with only the top bit set
# keys a card call sorts in one launch (csrc/join_sort.cu kSmallMax);
# above it a memset and 9 launches
ONE_BLOCK_MAX = 8_192
MAX_KEYS = (1 << 31) - 1 - 4_096  # csrc/join_sort.cu: INT_MAX - kTile


def unsigned_order(keys: torch.Tensor) -> torch.Tensor:
    """An i64 tensor whose SIGNED order is the UNSIGNED order of the u64
    bits in ``keys`` (the top bit flipped)."""
    return keys ^ _SIGN


def _check(keys: torch.Tensor) -> int:
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError("keys must be i64 [n] (the bits of u64 keys)")
    if not keys.is_contiguous():
        raise ValueError("join_sort needs a contiguous tensor")
    n = keys.shape[0]
    if n > MAX_KEYS:
        raise ValueError(f"join_sort: {n} keys (at most {MAX_KEYS})")
    return n


def join_sort_reference(keys: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (order i64[n], keys[order] i64[n])."""
    n = keys.shape[0]
    order = torch.arange(n, dtype=torch.int64, device=keys.device)
    if n == 0:
        return order, keys.clone()
    digits = [(keys >> (8 * d)) & 0xFF for d in range(8)]
    varying = [d for d in range(8) if bool((digits[d] != digits[d][0]).any())]
    for d in varying:  # least significant first: each pass is stable
        perm = torch.sort(digits[d][order], stable=True).indices
        order = order[perm]
    return order, keys[order]


@functools.lru_cache(maxsize=None)
def _c_fns():
    lib = build.load()
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = lib.arroyo_join_sort
    fn.argtypes = [p, ll, p, p]
    fn.restype = ctypes.c_int
    words = lib.arroyo_join_sort_words
    words.argtypes = [ll]
    words.restype = ll
    return fn, words


def join_sort(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order i64[n], keys[order] i64[n]) of the u64 keys ``keys`` (i64
    bits), stable, ascending as unsigned; on the card two views of one
    buffer."""
    n = _check(keys)
    dev = keys.device
    if dev.type == "cpu":
        return join_sort_reference(keys)
    if dev.type != "cuda":
        raise ValueError(f"join_sort: unsupported device {dev}")
    fn, words = _c_fns()
    buf = torch.empty(max(words(n), 2 * n), dtype=torch.int64, device=dev)
    if n:
        build.launch("join_sort", fn, dev, keys.data_ptr(), n,
                     buf.data_ptr())
        join_sort.launches += 1
    return buf[:n], buf[n:2 * n]


join_sort.launches = 0
