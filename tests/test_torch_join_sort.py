"""The legacy join layout's device pieces against arroyo_tpu's, on the CPU:

* ``join_sort_reference`` (the plain version of the ``join_sort`` kernel)
  against ``_sort_kernel(n)``: the order and the sorted keys equal, with
  duplicates, keys at and above 2^63 and SENTINEL padding;
* the u64 form of ``join_probe_reference`` against ``_probe_kernel`` in
  both of its forms (``ARROYO_JOIN_PROBE=search`` and ``merged``);
* the port's ``join_pairs`` under ``ARROYO_DEVICE_JOIN=on`` (the device
  branch through the kernels' plain versions) against the JAX
  ``join_pairs`` under the same setting: all five outputs, and the
  cases both packages send to the host (a side empty, a real key equal
  to SENTINEL)."""

import numpy as np
import pytest
import torch

from arroyo_tpu.ops import join as jax_join
from arroyo_tpu_torch.kernels.join_probe import join_probe
from arroyo_tpu_torch.kernels.join_sort import (join_sort,
                                                join_sort_reference,
                                                unsigned_order)
from arroyo_tpu_torch.obs import perf
from arroyo_tpu_torch.ops.join import SENTINEL, join_pairs

KINDS = ["hash", "duplicates", "high_bit", "few_digits"]


def _keys(rng, n, kind, pad):
    """u64 keys of one kind with ``pad`` SENTINEL rows at the end."""
    m = n - pad
    k = np.full(n, SENTINEL, np.uint64)
    if kind == "hash":
        k[:m] = rng.integers(0, 2**64 - 1, m, dtype=np.uint64)
    elif kind == "duplicates":
        k[:m] = rng.choice(rng.integers(0, 2**64 - 1, 12, dtype=np.uint64),
                           m)
    elif kind == "high_bit":  # straddling 2^63: the signed order differs
        k[:m] = (np.uint64(2**63) - np.uint64(50)
                 + rng.integers(0, 100, m).astype(np.uint64))
    else:
        k[:m] = rng.integers(0, 4, m).astype(np.uint64) << np.uint64(56)
    return k


def _t(keys):
    return torch.from_numpy(np.ascontiguousarray(keys).view(np.int64).copy())


@pytest.mark.parametrize("n", [512, 4096])
@pytest.mark.parametrize("kind", KINDS)
def test_join_sort_plain_matches_jax_sort_kernel(n, kind):
    rng = np.random.default_rng(n + len(kind))
    k = _keys(rng, n, kind, n // 9)
    order, keys = join_sort_reference(_t(k))
    want_o, want_k = jax_join._sort_kernel(n)(k)
    assert order.dtype == torch.int64
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(keys.numpy().view(np.uint64),
                                  np.asarray(want_k))
    # the wrapper takes the plain version for CPU tensors
    o2, k2 = join_sort(_t(k))
    assert torch.equal(o2, order) and torch.equal(k2, keys)


def _edge_keys(rng, n, kind):
    """Keys whose passes the card's kernel treats apart: only the top
    digit varying, all equal, or straddling 2^63 with a SENTINEL tail."""
    if kind == "top_digit":
        return (rng.integers(0, 256, n).astype(np.uint64) << np.uint64(56)) \
            | np.uint64(0x0012345678ABCDEF)
    if kind == "equal":
        return np.full(n, 2**63 + 5, np.uint64)
    k = np.full(n, SENTINEL, np.uint64)
    m = n - n // 7
    k[:m] = (np.uint64(2**63) - np.uint64(300)
             + rng.integers(0, 600, m).astype(np.uint64))
    return k


@pytest.mark.parametrize("n", [1, 4097, 8193])
@pytest.mark.parametrize("kind", ["top_digit", "equal", "straddle"])
def test_join_sort_plain_matches_jax_sort_kernel_edges(n, kind):
    """The plain version against ``_sort_kernel`` at the card kernel's
    path edges (one key; one above its 4,096-key block form; one above its
    one-block limit) on keys whose digit passes it skips or runs alone."""
    rng = np.random.default_rng(n * 3 + len(kind))
    k = _edge_keys(rng, n, kind)
    order, keys = join_sort_reference(_t(k))
    want_o, want_k = jax_join._sort_kernel(n)(k)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(keys.numpy().view(np.uint64),
                                  np.asarray(want_k))


def test_unsigned_order_orders_as_u64():
    k = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1], np.uint64)
    flipped = unsigned_order(_t(k))
    assert torch.equal(torch.argsort(flipped, stable=True),
                       torch.arange(len(k)))


@pytest.mark.parametrize("mode", ["search", "merged"])
@pytest.mark.parametrize("kind", KINDS)
def test_join_probe_u64_plain_matches_jax_probe_kernel(mode, kind,
                                                       monkeypatch):
    monkeypatch.setenv("ARROYO_JOIN_PROBE", mode)
    rng = np.random.default_rng(len(mode) * 7 + len(kind))
    nl, nr = 1024, 4096
    lk = _keys(rng, nl, kind, 100)
    rk = np.full(nr, SENTINEL, np.uint64)
    rk[:3000] = rng.choice(lk[:nl - 100], 3000)
    lks = np.sort(lk)
    rks = np.sort(rk)
    want = jax_join._probe_kernel(nl, nr, jax_join._merged_probe())(
        lks, rks, nl - 100, 3000)
    got = join_probe(_t(lks), _t(rks), nl - 100, 3000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2][-1]) > 0


def _pair_keys(rng, nl, nr, kind):
    pool = _keys(rng, 64, kind, 0)
    return rng.choice(pool, nl), rng.choice(pool, nr)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nl,nr", [(700, 1500), (3000, 200)])
def test_join_pairs_device_branch_matches_jax(kind, nl, nr, monkeypatch):
    """All five outputs equal the JAX device branch's (the JAX package's
    own tests drive ``_sort_kernel`` under ``ARROYO_DEVICE_JOIN=on``)."""
    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "on")
    rng = np.random.default_rng(nl + len(kind))
    lk, rk = _pair_keys(rng, nl, nr, kind)
    perf.reset()
    got = join_pairs(lk, rk, torch.device("cpu"))
    assert perf.counter("join_pairs_device") == 1
    assert perf.counter("join_pairs_host") == 0
    want = jax_join.join_pairs(lk, rk)
    assert len(want[2]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.int64),
                                      np.asarray(w, np.int64))
    over = len(want[2]) > max(jax_join._bucket(nl), jax_join._bucket(nr))
    assert perf.counter("join_pairs_overflows") == int(over)


@pytest.mark.parametrize("case", ["left_empty", "right_empty",
                                  "sentinel_key", "device_join_off"])
def test_join_pairs_host_branch_matches_jax(case, monkeypatch):
    """Where the JAX package joins on the host, so does the port, with the
    same five outputs."""
    monkeypatch.setenv("ARROYO_DEVICE_JOIN",
                       "off" if case == "device_join_off" else "on")
    rng = np.random.default_rng(3)
    lk, rk = _pair_keys(rng, 900, 1100, "hash")
    if case == "left_empty":
        lk = lk[:0]
    elif case == "right_empty":
        rk = rk[:0]
    elif case == "sentinel_key":
        rk[7] = SENTINEL
    perf.reset()
    got = join_pairs(lk, rk, torch.device("cpu"))
    assert perf.counter("join_pairs_host") == 1
    want = jax_join.join_pairs(lk, rk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.int64),
                                      np.asarray(w, np.int64))


def test_join_pairs_auto_stays_on_the_host_on_the_cpu(monkeypatch):
    """``auto`` takes the device branch only on CUDA (from 2,048 rows)."""
    monkeypatch.setenv("ARROYO_DEVICE_JOIN", "auto")
    rng = np.random.default_rng(4)
    lk, rk = _pair_keys(rng, 3000, 3000, "hash")
    perf.reset()
    join_pairs(lk, rk, torch.device("cpu"))
    assert perf.counter("join_pairs_host") == 1
    assert perf.counter("join_pairs_device") == 0
