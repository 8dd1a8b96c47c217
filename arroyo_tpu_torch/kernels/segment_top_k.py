"""K12 ``segment_top_k``: per segment, the rows whose rank by value
(descending; ties by original index) is below ``k``, returned as their
indices in ascending original order.

Replaces arroyo_tpu/ops/topk.py:25 ``_topk_kernel`` (and the host sort of
its output, topk.py:65).  -0.0 equals +0.0 and NaN of either sign ranks
last, as ``lax.sort`` orders them.

On the H100 it is bound by memory — 12 bytes read per row and 4 written
per kept row — and, at TopN's sizes, by its launches and readbacks.
The CUDA kernels (``csrc/segment_top_k.cu``) first run an exact
prefilter: each round keeps every tile's local top k per segment (a
register sort of 128-row chunks per warp, then a shared-memory sort of
their survivors in tiles of 2,048), compacted in original order with a
decoupled look-back, and one final block ranks the last <= 8,192
candidates and writes the kept indices — at TopN's sizes one zero-fill,
two rounds and the final launch, and one readback (the kept count).
Candidates that do not shrink that far (many segments with fewer than k
rows a tile, or k >= 2,048) take the general path: an LSD radix sort of
them by (segment, value) over the 8-bit digits that vary (a mask read
back after the key pass picks them), the rank test on the sorted order,
and compaction in original order.  No step works per segment, so one
segment holding every row costs what many small ones do.

``segment_top_k.last_launches`` and ``segment_top_k.last_syncs`` hold
the kernel launches (zero-fills included) and host syncs of the last
call on the card.

``segment_top_k_reference`` is the plain PyTorch version (two stable
sorts); the wrapper takes it only for tensors on the CPU."""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

THREADS = 256  # rows per block of the select/gather kernels
TILE = 4096  # rows per tile of a radix pass (csrc/segment_top_k.cu)
TILE_ROWS = 2048  # candidates per prefilter tile (kTileRows)
FINAL_ROWS = 8192  # candidates the final block ranks (kFinalRows)
MAX_ROUNDS = 4
_SIGN = -(2**63)


def _check(seg: torch.Tensor, val: torch.Tensor, k: int) -> int:
    if seg.dtype != torch.int32 or seg.dim() != 1:
        raise TypeError("seg must be i32 [n]")
    if val.dtype != torch.float64 or tuple(val.shape) != tuple(seg.shape):
        raise TypeError("val must be f64 [n], like seg")
    if seg.device != val.device:
        raise ValueError(f"tensors on several devices: "
                         f"{{{seg.device}, {val.device}}}")
    if not (seg.is_contiguous() and val.is_contiguous()):
        raise ValueError("segment_top_k needs contiguous tensors")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    n = seg.shape[0]
    if n >= 2**31:
        raise ValueError("segment_top_k takes fewer than 2^31 rows")
    return n


def order_keys(val: torch.Tensor) -> torch.Tensor:
    """i64 keys that sort ascending as ``val`` sorts descending, with -0.0
    equal to +0.0 and every NaN last (the sign-flipped form of the
    kernel's u64 keys)."""
    bits = (-val).view(torch.int64)
    bits = torch.where(bits == _SIGN, 0, bits)  # -0.0 -> +0.0
    key = torch.where(bits < 0, bits ^ (2**63 - 1), bits)
    return torch.where(torch.isnan(val), 2**63 - 1, key)


def segment_top_k_reference(seg: torch.Tensor, val: torch.Tensor, k: int
                            ) -> torch.Tensor:
    """Plain PyTorch version: a stable sort by value key, then a stable
    sort by segment, rank by the k-th predecessor's segment, keep flags
    at original positions, ``nonzero``."""
    n = seg.shape[0]
    by_val = torch.sort(order_keys(val), stable=True).indices
    by_seg = torch.sort(seg[by_val], stable=True).indices
    perm = by_val[by_seg]
    s = seg[perm]
    keep_sorted = torch.zeros(n, dtype=torch.bool, device=seg.device)
    keep_sorted[:k] = True
    if 0 < k < n:
        keep_sorted[k:] = s[k:] != s[:-k]
    flags = torch.zeros(n, dtype=torch.bool, device=seg.device)
    flags[perm] = keep_sorted
    return torch.nonzero(flags).squeeze(1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _c_fns():
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    round_ = lib.arroyo_topk_round
    round_.argtypes = [p, p, i, i, i, p, p, p, p, p, i, p]
    round_.restype = i
    final = lib.arroyo_topk_final
    final.argtypes = [p, p, i, i, i, p, p, p, p, p, p]
    final.restype = i
    keys = lib.arroyo_topk_keys
    keys.argtypes = [p, p, p, i, p, p, p, p, p]
    keys.restype = i
    pass_ = lib.arroyo_topk_pass
    pass_.argtypes = [p, p, i, i, p, i, p, p, p]
    pass_.restype = i
    select = lib.arroyo_topk_select
    select.argtypes = [p, p, i, i, p, p, p, p]
    select.restype = i
    gather = lib.arroyo_topk_gather
    gather.argtypes = [p, i, p, p, p, p]
    gather.restype = i
    return round_, final, keys, pass_, select, gather


@functools.lru_cache(maxsize=None)
def _round_grid_cap(index: int) -> int:
    """Round blocks resident on the card at once (the occupancy the
    compiled round kernel allows, times the SMs): blocks beyond them
    would start only to find every tile taken."""
    fn = build.load().arroyo_topk_round_blocks_per_sm
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    build.check(fn(ctypes.byref(blocks)), "segment_top_k occupancy")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return blocks.value * sms


def prefilter_rounds(n: int, k: int, tile_rows: int = TILE_ROWS,
                     final_rows: int = FINAL_ROWS) -> int:
    """Prefilter rounds launched for ``n`` rows and ``1 <= k <= n``: as
    many as it takes, if every tile kept only k rows, to come down to one
    tile, while each round would at least halve the candidates.  Tiles
    that hold several segments keep more; the final block takes up to
    ``final_rows``, and the rounds pass their input on once it fits a
    tile or stops halving, so the count is decided on the host from n and
    k alone.  0 when the rows fit the final block or k fills a tile."""
    if k >= tile_rows or n <= final_rows:
        return 0
    rounds, m = 0, n
    while m > tile_rows and rounds < MAX_ROUNDS:
        nxt = -(-m // tile_rows) * k
        if 2 * nxt > m:
            break
        m, rounds = nxt, rounds + 1
    return rounds


def _digits(mask: int, width: int) -> list:
    """Bit shifts of the 8-bit digits of a ``width``-bit mask that vary."""
    return [s for s in range(0, width, 8) if (mask >> s) & 0xFF]


def _prefilter(seg: torch.Tensor, val: torch.Tensor, n: int, k: int,
               rounds: int, fns, tally: list):
    """The rounds and the final block.  Returns (kept indices, None, 0),
    or, when more than FINAL_ROWS candidates are left, (None, the
    candidates' row indices or None for every row, their count).  One i32
    buffer holds the kept indices, the final block's info words and the
    rounds' two candidate buffers, so the kept indices are a view of it."""
    round_fn, final_fn = fns[0], fns[1]
    dev = seg.device
    work = torch.empty(FINAL_ROWS + 4 + (2 * n if rounds else 0),
                       dtype=torch.int32, device=dev)
    out = work.data_ptr()
    info = out + 4 * FINAL_ROWS
    a = b = ctl = None
    if rounds:
        a = info + 16
        b = a + 4 * n
        ntiles = -(-n // TILE_ROWS)
        # per round: look-back status u64[ntiles] and a tile counter; then
        # the rounds' control words i32[2 * (rounds + 1)]
        ws = torch.zeros(rounds * ntiles + (3 * rounds + 3) // 2,
                         dtype=torch.int64, device=dev)
        tally[0] += 1
        status = ws.data_ptr()
        counters = status + 8 * rounds * ntiles
        ctl = counters + 4 * rounds
        grid = min(ntiles, _round_grid_cap(dev.index))
        for r in range(rounds):
            build.launch("segment_top_k round", round_fn, dev,
                         seg.data_ptr(), val.data_ptr(), n, k, r, a, b,
                         status + 8 * r * ntiles, counters + 4 * r, ctl,
                         grid)
        tally[0] += rounds
    build.launch("segment_top_k final", final_fn, dev, seg.data_ptr(),
                 val.data_ptr(), n, k, rounds, a, b, ctl, out, info)
    tally[0] += 1
    kept, m, sel = work[FINAL_ROWS:FINAL_ROWS + 3].tolist()
    tally[1] += 1
    if kept >= 0:
        return work[:kept], None, 0
    if sel == 0:
        return None, None, m
    start = FINAL_ROWS + 4 + (sel - 1) * n
    return None, work[start:start + m], m


def _radix(seg: torch.Tensor, val: torch.Tensor, k: int, cand, m: int, fns,
           tally: list) -> torch.Tensor:
    """The general path over ``m`` candidates (rows ``cand``, or every
    row when ``cand`` is None)."""
    keys_fn, pass_fn, select_fn, gather_fn = fns[2:]
    dev = seg.device
    key = torch.empty(m, dtype=torch.int64, device=dev)
    idx = torch.empty((2, m), dtype=torch.int32, device=dev)
    seg_c = seg if cand is None else torch.empty(m, dtype=torch.int32,
                                                 device=dev)
    cand_p = None if cand is None else cand.data_ptr()
    masks = torch.zeros(2, dtype=torch.int64, device=dev)
    ntiles = -(-m // TILE)
    hist = torch.empty(2 * 256 * ntiles + 1, dtype=torch.int32, device=dev)
    nblocks = -(-m // THREADS)
    flags = torch.empty(m, dtype=torch.uint8, device=dev)
    scan = torch.empty(2 * nblocks + 1, dtype=torch.int32, device=dev)
    build.launch("segment_top_k keys", keys_fn, dev, val.data_ptr(),
                 seg.data_ptr(), cand_p, m, key.data_ptr(), seg_c.data_ptr(),
                 idx[0].data_ptr(), masks.data_ptr())
    m_val, m_seg = (int(x) & (2**64 - 1) for x in masks.tolist())
    passes = ([(0, s) for s in _digits(m_val, 64)]
              + [(1, s) for s in _digits(m_seg, 32)])
    src = 0
    for use_seg, shift in passes:
        build.launch("segment_top_k pass", pass_fn, dev, key.data_ptr(),
                     seg_c.data_ptr(), use_seg, shift, idx[src].data_ptr(),
                     m, hist.data_ptr(), idx[1 - src].data_ptr())
        src = 1 - src
    build.launch("segment_top_k select", select_fn, dev, idx[src].data_ptr(),
                 seg_c.data_ptr(), m, k, flags.data_ptr(), scan.data_ptr(),
                 scan[nblocks:].data_ptr())
    kept = int(scan[2 * nblocks].item())
    out = torch.empty(kept, dtype=torch.int32, device=dev)
    build.launch("segment_top_k gather", gather_fn, dev, flags.data_ptr(), m,
                 cand_p, scan[nblocks:].data_ptr(), out.data_ptr())
    # the zero-fill, keys, three a pass, three to select, the gather
    tally[0] += 1 + 1 + 3 * len(passes) + 3 + 1
    tally[1] += 2
    return out


def segment_top_k(seg: torch.Tensor, val: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Kept row indices i32[m], ascending, for dense segment ids ``seg``
    i32[n] (>= 0) and values ``val`` f64[n]: the rows ranked below ``k``
    in their segment by ``val`` descending, ties by index."""
    n = _check(seg, val, k)
    dev = seg.device
    if dev.type == "cpu":
        return segment_top_k_reference(seg, val, k)
    if dev.type != "cuda":
        raise ValueError(f"segment_top_k: unsupported device {dev}")
    tally = [0, 0]  # launches, host syncs
    if n == 0 or k == 0:
        out = torch.zeros(0, dtype=torch.int32, device=dev)
    else:
        k = min(k, n)  # every row of a segment of n rows ranks below n
        fns = _c_fns()
        rounds = prefilter_rounds(n, k)
        cand, m = None, n
        out = None
        if rounds or n <= FINAL_ROWS:
            out, cand, m = _prefilter(seg, val, n, k, rounds, fns, tally)
        if out is None:
            out = _radix(seg, val, k, cand, m, fns, tally)
        segment_top_k.launches += 1
    segment_top_k.last_launches, segment_top_k.last_syncs = tally
    return out


segment_top_k.launches = 0
segment_top_k.last_launches = 0
segment_top_k.last_syncs = 0
