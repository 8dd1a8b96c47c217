"""The host library of the windowing hot path: ctypes bindings for
``host_ops.cpp`` (a copy of the JAX package's ``native/src/host_ops.cpp``)
beside numpy versions of the same semantics.

The library is built at first import with the host compiler
(``g++ -O3 -fPIC -shared -std=c++17 -Wall``) into
``build/arroyo_tpu_torch/libarroyo_host-<hash>.so`` at the repository
root; the name carries a hash of the source, compiler and flags, so an
edited source never loads a stale binary.  An exclusive ``fcntl`` lock
serializes concurrent first builds and the file is published by an
atomic rename.  A failed build or load logs a warning and leaves
``HAVE_NATIVE`` False: every binding then runs its numpy version, as
``ARROYO_NATIVE=0`` forces.

The library's key directory (:class:`NativeDir`) gives new keys slots in
first-seen order and :func:`agg_cells` returns cells in first-appearance
order, as the JAX package's library does; the numpy versions (the sorted
directory of ``ops.keyed_bins.directory_insert`` and ``preaggregate``)
give ascending hash order."""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..types import _py_hash_u64, server_for_hash_array

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "arroyo_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
_ABI_VERSION = 2  # arroyo_abi_version() in host_ops.cpp


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libarroyo_host-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The library's path, compiling it first unless a process already
    did; None when there is no compiler or the build fails."""
    cxx = _compiler()
    if cxx is None:
        logger.warning("no C++ compiler (g++ or $CXX): the host library "
                       "runs its numpy versions")
        return None
    out = library_path(cxx)
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "libarroyo_host.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():  # another process built it meanwhile
                return out
            tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
            return out
    except (subprocess.SubprocessError, OSError) as e:
        logger.warning("host library build failed, numpy versions: %s", e)
        return None


def _abi_ok(lib: ctypes.CDLL) -> bool:
    try:
        fn = lib.arroyo_abi_version
        fn.restype = ctypes.c_int64
        return int(fn()) == _ABI_VERSION
    except (AttributeError, OSError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("ARROYO_NATIVE", "1") in ("0", "false", "no"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        logger.warning("host library unusable, numpy versions: %s", e)
        return None
    if not _abi_ok(lib):
        logger.warning("host library ABI is not v%d, numpy versions",
                       _ABI_VERSION)
        return None

    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.arroyo_hash_u64.argtypes = [u64p, u64p, ctypes.c_int64]
    lib.arroyo_hash_combine.argtypes = [u64p, u64p, ctypes.c_int64]
    lib.arroyo_partition_route.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_int32, i32p, i64p, i64p]
    lib.arroyo_assign_bins.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i32p, u8p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.arroyo_assign_bins.restype = ctypes.c_int64
    lib.arroyo_dir_new.argtypes = [ctypes.c_int64]
    lib.arroyo_dir_new.restype = ctypes.c_void_p
    lib.arroyo_dir_free.argtypes = [ctypes.c_void_p]
    lib.arroyo_dir_load.argtypes = [ctypes.c_void_p, u64p, i64p,
                                    ctypes.c_int64]
    lib.arroyo_dir_insert.argtypes = [ctypes.c_void_p, u64p, ctypes.c_int64,
                                      ctypes.c_int64, i64p, u64p]
    lib.arroyo_dir_insert.restype = ctypes.c_int64
    lib.arroyo_dir_lookup.argtypes = [ctypes.c_void_p, u64p, ctypes.c_int64,
                                      i64p]
    lib.arroyo_agg_cells.argtypes = [
        i64p, i32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        f64p, u8p, ctypes.c_int32, i64p, i32p, f64p, f64p]
    lib.arroyo_agg_cells.restype = ctypes.c_int64
    global LIBRARY
    LIBRARY = str(path)
    return lib


LIBRARY: Optional[str] = None  # the loaded library's path
# the one switch: setting ``_lib`` to None turns every binding, and every
# keyed state built after it, to the numpy versions
_lib: Optional[ctypes.CDLL] = _load()


def __getattr__(name: str):
    if name == "HAVE_NATIVE":  # read from ``_lib``, never set on its own
        return _lib is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# -- hashing -------------------------------------------------------------------


def hash_u64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over an integer array, elementwise."""
    arr = np.asarray(x)
    if _lib is None or arr.ndim == 0:
        return _py_hash_u64(arr)
    xs = np.ascontiguousarray(arr.reshape(-1), dtype=np.uint64)
    out = np.empty_like(xs)
    _lib.arroyo_hash_u64(xs, out, len(xs))
    return out.reshape(arr.shape)


def hash_combine(acc: np.ndarray, h: np.ndarray) -> np.ndarray:
    """acc = splitmix64(acc * 31 + h), elementwise, on a copy."""
    a = np.ascontiguousarray(acc, dtype=np.uint64).copy()
    hs = np.ascontiguousarray(h, dtype=np.uint64)
    if _lib is None:
        with np.errstate(over="ignore"):
            return _py_hash_u64(a * np.uint64(31) + hs)
    _lib.arroyo_hash_combine(a, hs, len(a))
    return a


# -- routing and bins ----------------------------------------------------------


def partition_route(key_hash: np.ndarray, n_parts: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dest[n] i32, order[n] i64 stable by dest, bounds[n_parts+1] i64):
    ``order[bounds[p]:bounds[p+1]]`` are the rows destined for shard p —
    one counting-sort pass in the library."""
    kh = np.ascontiguousarray(key_hash, dtype=np.uint64)
    n = len(kh)
    if _lib is None:
        dest = server_for_hash_array(kh, n_parts).astype(np.int32)
        order = np.argsort(dest, kind="stable").astype(np.int64)
        bounds = np.searchsorted(
            dest[order], np.arange(n_parts + 1)).astype(np.int64)
        return dest, order, bounds
    dest = np.empty(n, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)
    bounds = np.empty(n_parts + 1, dtype=np.int64)
    _lib.arroyo_partition_route(kh, n, n_parts, dest, order, bounds)
    return dest, order, bounds


def assign_bins(ts: np.ndarray, slide: int, ring: int,
                threshold: Optional[int]
                ) -> Tuple[np.ndarray, np.ndarray, int, Optional[int],
                           Optional[int]]:
    """Window-bin assignment + liveness: (bins i32, live bool, n_live,
    abs_min, abs_max) where abs_* cover live rows only."""
    t = np.ascontiguousarray(ts, dtype=np.int64)
    n = len(t)
    thr = -(2**63) if threshold is None else int(threshold)
    if _lib is None:
        abs_bins = t // slide
        live = abs_bins >= thr
        bins = (abs_bins % ring).astype(np.int32)
        n_live = int(live.sum())
        if n_live:
            lo = int(abs_bins[live].min())
            hi = int(abs_bins[live].max())
        else:
            lo = hi = None
        return bins, live, n_live, lo, hi
    bins = np.empty(n, dtype=np.int32)
    live = np.empty(n, dtype=np.uint8)
    lo = ctypes.c_int64()
    hi = ctypes.c_int64()
    n_live = _lib.arroyo_assign_bins(t, n, slide, ring, thr, bins, live,
                                     ctypes.byref(lo), ctypes.byref(hi))
    if n_live == 0:
        return bins, live.view(bool), 0, None, None
    return bins, live.view(bool), int(n_live), lo.value, hi.value


# -- the key directory and cell pre-aggregation -------------------------------


class NativeDir:
    """Persistent open-addressing key directory (key hash -> slot) in the
    library; ``NativeDir.create`` returns None on the numpy versions."""

    __slots__ = ("_h", "_lib")

    @classmethod
    def create(cls, cap_hint: int = 1024) -> Optional["NativeDir"]:
        return cls(cap_hint) if _lib is not None else None

    def __init__(self, cap_hint: int = 1024):
        # the library that made the table frees it, even if the module's
        # is switched off meanwhile
        self._lib = _lib
        self._h = _lib.arroyo_dir_new(int(cap_hint))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.arroyo_dir_free(self._h)
            self._h = None

    def __deepcopy__(self, memo):
        raise TypeError("a NativeDir owns a C table: rebuild it with load()")

    def load(self, keys: np.ndarray, slots: np.ndarray) -> None:
        """Bulk-load explicit (key, slot) pairs (checkpoint restore)."""
        k = np.ascontiguousarray(keys, dtype=np.uint64)
        s = np.ascontiguousarray(slots, dtype=np.int64)
        self._lib.arroyo_dir_load(self._h, k, s, len(k))

    def insert(self, kh: np.ndarray, next_slot: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Lookup-or-insert: (slots[n], new_keys) where unknown keys got
        sequential slots from ``next_slot`` in first-seen order."""
        k = np.ascontiguousarray(kh, dtype=np.uint64)
        n = len(k)
        slots = np.empty(n, dtype=np.int64)
        new_keys = np.empty(n, dtype=np.uint64)
        n_new = self._lib.arroyo_dir_insert(self._h, k, n, int(next_slot),
                                            slots, new_keys)
        return slots, new_keys[:n_new]

    def lookup(self, kh: np.ndarray) -> np.ndarray:
        """Slots for known keys, -1 for unknown."""
        k = np.ascontiguousarray(kh, dtype=np.uint64)
        out = np.empty(len(k), dtype=np.int64)
        self._lib.arroyo_dir_lookup(self._h, k, len(k), out)
        return out


def agg_cells(slots: np.ndarray, bins: np.ndarray,
              live: Optional[np.ndarray], ring: int,
              vals: np.ndarray, ch_kinds: Tuple[str, ...]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(slot, bin)-cell pre-aggregation in one hash pass of the library:
    (cell_slots, cell_bins, cell_rowcounts f64, cell_vals [n_ch, m]) in
    first-appearance order, rows with ``live`` False left out — the fast
    twin of ``ops.keyed_bins.preaggregate`` (which sorts by (slot, bin)).
    Accumulation is f64.  Needs the library."""
    if _lib is None:
        raise RuntimeError("agg_cells needs the host library, which is "
                           "not loaded")
    s = np.ascontiguousarray(slots, dtype=np.int64)
    b = np.ascontiguousarray(bins, dtype=np.int32)
    n = len(s)
    v = np.ascontiguousarray(vals, dtype=np.float64)
    kinds = np.array([1 if k == "min" else 2 if k == "max" else 0
                      for k in ch_kinds], dtype=np.uint8)
    n_ch = len(ch_kinds)
    out_slot = np.empty(n, dtype=np.int64)
    out_bin = np.empty(n, dtype=np.int32)
    out_cnt = np.empty(n, dtype=np.float64)
    out_vals = np.empty((n_ch, n), dtype=np.float64)
    lv = (None if live is None
          else np.ascontiguousarray(live, dtype=np.uint8))
    lp = lv.ctypes.data_as(ctypes.c_void_p) if lv is not None else None
    m = _lib.arroyo_agg_cells(s, b, lp, n, int(ring), v, kinds, n_ch,
                              out_slot, out_bin, out_cnt, out_vals)
    return out_slot[:m], out_bin[:m], out_cnt[:m], out_vals[:, :m]
