"""The port's page-pool allocator (``workloads/kv_pool.py``, its own
copy of the JAX package's) against the reference's.

Every case of tests/test_kv_pool.py runs on the port, its free-list fuzz
included; then the same random op sequences (alloc, map, share, cow,
clear, unshare, exhaustion) drive one reference pool and one port pool
side by side, and their tables, refcounts, free lists, copy counts and
errors must be equal after every op."""

import os

import numpy as np
import pytest

from tpu_k8s_device_plugin.workloads import kv_pool as ref_pool
from tpu_k8s_device_plugin_torch.workloads.kv_pool import (
    PagePool,
    PagePoolExhausted,
)


def test_ctor_validation():
    with pytest.raises(ValueError):
        PagePool(8, 7, 2, 64)       # page must divide max_len
    with pytest.raises(ValueError):
        PagePool(3, 16, 2, 64)      # < one full-length sequence
    with pytest.raises(ValueError):
        PagePool(8, 0, 2, 64)


def test_alloc_map_unmap_roundtrip():
    p = PagePool(8, 8, 2, 64)
    assert p.free_pages() == 8
    a = p.alloc()
    p.map(0, 0, a)
    assert p.free_pages() == 7
    assert p.entry(0, 0) == a
    assert p.writable(0, 0)
    p.unmap(0, 0)
    assert p.free_pages() == 8
    assert p.entry(0, 0) == p.scratch
    p.check()


def test_alloc_order_is_deterministic():
    p = PagePool(8, 8, 2, 64)
    got = [p.alloc() for _ in range(8)]
    assert got == list(range(8))
    with pytest.raises(PagePoolExhausted):
        p.alloc()
    for g in got:
        p.give_back(g)
    assert p.free_pages() == 8


def test_share_refcounts_and_cow():
    p = PagePool(8, 8, 2, 64)
    for idx in range(3):
        p.map(0, idx, p.alloc())
    shared = p.share(0, 2)
    p.map_shared(1, shared)
    assert p.shared_pages() == 2
    assert not p.writable(1, 0)          # shared: CoW before write
    assert not p.writable(0, 0)          # the donor side too
    assert p.writable(0, 2)              # unshared suffix stays
    new = p.alloc()
    old = p.cow(1, 0, new)
    assert old == shared[0]
    assert p.writable(1, 0)
    assert p.cow_copies == 1
    assert p.shared_pages() == 1
    p.check()


def test_clear_slot_frees_only_last_reference():
    p = PagePool(8, 8, 2, 64)
    for idx in range(2):
        p.map(0, idx, p.alloc())
    p.map_shared(1, p.share(0, 2))
    free_before = p.free_pages()
    p.clear_slot(0)
    # slot 1 still references both pages: nothing freed
    assert p.free_pages() == free_before
    p.clear_slot(1)
    assert p.free_pages() == 8
    p.check()


def test_self_share_survives_clear():
    # the begin-time incref / finish-time clear+reinstall dance, with
    # the donor slot being the destination itself
    p = PagePool(8, 8, 2, 64)
    for idx in range(2):
        p.map(0, idx, p.alloc())
    pages = p.share(0, 2)     # refs 2
    p.clear_slot(0)           # refs 1, NOT freed
    assert p.free_pages() == 6
    p.map_shared(0, pages)    # refs stay 1, table re-installed
    assert p.writable(0, 0) and p.writable(0, 1)
    p.check()


def test_unshare_rolls_back_aborted_share():
    p = PagePool(8, 8, 2, 64)
    p.map(0, 0, p.alloc())
    pages = p.share(0, 1)
    p.unshare(pages)
    assert p.writable(0, 0)
    p.clear_slot(0)
    assert p.free_pages() == 8
    p.check()


def test_double_free_and_underflow_raise():
    p = PagePool(8, 8, 2, 64)
    a = p.alloc()
    p.map(0, 0, a)
    with pytest.raises(RuntimeError):
        p.map(0, 0, a)            # remap without unmap
    with pytest.raises(RuntimeError):
        p.give_back(a)            # still referenced
    with pytest.raises(RuntimeError):
        p.cow(0, 0, 7)            # not shared: write in place
    p.unmap(0, 0)                 # last ref: auto-freed
    assert p.free_pages() == 8
    b = p.alloc()
    p.give_back(b)                # never mapped: explicit return
    assert p.free_pages() == 8
    p.check()


def test_pages_for():
    p = PagePool(8, 8, 2, 64)
    assert list(p.pages_for(0, 8)) == [0]
    assert list(p.pages_for(0, 9)) == [0, 1]
    assert list(p.pages_for(7, 17)) == [0, 1, 2]
    assert list(p.pages_for(8, 8)) == []


def test_fuzz_never_leaks_or_double_frees():
    """Random admit/release/share/CoW/preempt sequences against the
    integrity oracle.  Deterministic per ENGINE_FUZZ_SEED (CI sweeps
    several)."""
    seed = int(os.environ.get("ENGINE_FUZZ_SEED", "0") or 0)
    rng = np.random.RandomState(1234 + seed)
    n_slots, n_tables = 6, 8
    p = PagePool(24, 8, n_slots, 64)
    # per-slot logical fill level (next unmapped index)
    fill = [0] * n_slots

    for step in range(4000):
        op = rng.randint(5)
        s = int(rng.randint(n_slots))
        if op == 0 and fill[s] < n_tables:          # grow
            try:
                p.map(s, fill[s], p.alloc())
                fill[s] += 1
            except PagePoolExhausted:
                pass
        elif op == 1 and fill[s] > 0:               # release
            p.clear_slot(s)
            fill[s] = 0
        elif op == 2:                               # prefix share
            d = int(rng.randint(n_slots))
            if d != s and fill[s] > 0:
                n = int(rng.randint(1, fill[s] + 1))
                pages = p.share(s, n)
                if rng.rand() < 0.2:
                    p.unshare(pages)                # aborted admission
                else:
                    p.clear_slot(d)
                    p.map_shared(d, pages)
                    fill[d] = n
        elif op == 3 and fill[s] > 0:               # CoW a shared page
            idx = int(rng.randint(fill[s]))
            if not p.writable(s, idx) \
                    and p.entry(s, idx) != p.scratch:
                try:
                    p.cow(s, idx, p.alloc())
                except PagePoolExhausted:
                    pass
        elif op == 4 and fill[s] > 0:               # preempt (free all)
            p.clear_slot(s)
            fill[s] = 0
        if step % 97 == 0:
            p.check()
    p.check()
    # drain everything: the pool must come back whole
    for s in range(n_slots):
        p.clear_slot(s)
    p.check()
    assert p.free_pages() == 24


def _state(p):
    return (p.tables.tolist(), p.refs.tolist(), list(p._free),
            p.cow_copies, p.dirty, p.stats(), p.used_pages())


def _call(pool, name, *args):
    """(result, error type name) of one op."""
    try:
        return getattr(pool, name)(*args), None
    except (RuntimeError, ValueError) as e:
        return None, type(e).__name__


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_sequences_match_reference(seed):
    rng = np.random.RandomState(4321 + seed)
    n_slots = 5
    pools = (ref_pool.PagePool(20, 8, n_slots, 64),
             PagePool(20, 8, n_slots, 64))
    fill = [0] * n_slots
    for _ in range(1500):
        op = int(rng.randint(8))
        s = int(rng.randint(n_slots))
        if op == 0 and fill[s] < 8:                      # alloc + map
            got = [_call(p, "alloc") for p in pools]
            assert got[0] == got[1]
            if got[0][1] is None:
                for p in pools:
                    p.map(s, fill[s], got[0][0])
                fill[s] += 1
        elif op == 1:                                    # clear
            for p in pools:
                p.clear_slot(s)
            fill[s] = 0
        elif op == 2 and fill[s]:                        # share
            d = int(rng.randint(n_slots))
            n = int(rng.randint(1, fill[s] + 1))
            shared = [p.share(s, n) for p in pools]
            assert shared[0] == shared[1]
            if d == s or rng.rand() < 0.3:
                for p, pages in zip(pools, shared):
                    p.unshare(pages)
            else:
                for p, pages in zip(pools, shared):
                    p.clear_slot(d)
                    p.map_shared(d, pages)
                fill[d] = n
        elif op == 3 and fill[s]:                        # cow
            idx = int(rng.randint(fill[s]))
            got = [_call(p, "alloc") for p in pools]
            assert got[0] == got[1]
            if got[0][1] is None:
                res = [_call(p, "cow", s, idx, got[0][0]) for p in pools]
                assert res[0] == res[1]
                if res[0][1] is not None:
                    for p in pools:
                        p.give_back(got[0][0])
        elif op == 4 and fill[s]:                        # unmap the top
            for p in pools:
                p.unmap(s, fill[s] - 1)
            fill[s] -= 1
        elif op == 5 and fill[s]:                        # remap: raises
            res = [_call(p, "map", s, 0, 0) for p in pools]
            assert res[0] == res[1] == (None, "RuntimeError")
        elif op == 6:                                    # queries
            for name in ("free_pages", "shared_pages", "used_pages"):
                assert _call(pools[0], name) == _call(pools[1], name)
            assert pools[0].mapped(s) == pools[1].mapped(s)
            assert [pools[0].writable(s, i) for i in range(8)] == \
                [pools[1].writable(s, i) for i in range(8)]
        else:                                            # exhaustion
            taken = []
            while True:
                got = [_call(p, "alloc") for p in pools]
                assert got[0] == got[1]
                if got[0][1] is not None:
                    assert got[0][1] == "PagePoolExhausted"
                    break
                taken.append(got[0][0])
            for t in taken:
                for p in pools:
                    p.give_back(t)
        assert _state(pools[0]) == _state(pools[1])
        pools[1].check()
