# tpulint: deterministic-path -- the free-list fuzz replays allocator decisions from seeds; D1 bans bare random/time.time() here
"""Host-side page-pool allocator for the paged KV cache.

The vLLM PagedAttention bookkeeping, host-only: the serving engine's
KV storage becomes a ``[P, page_size, Hkv, Dh]`` physical pool per
layer plus a per-slot ``[S, max_len/page_size]`` int32 block table,
and THIS module owns every allocation decision — a free list, per-page
reference counts, and copy-on-write semantics for shared prefixes.
No torch imports: all device data movement (page copies, splices,
gathers) stays in serving.py's in-place helpers; the allocator is pure
deterministic host state, which is what makes it unit/fuzz-testable
at C speed and lets mypy --strict cover it.

Sharing model (RadixAttention-lite, adapted to the engine's fixed
chunk grid):

* a **block-table entry** maps one logical page of a slot's sequence
  to a physical page; ``SCRATCH`` (= ``n_pages``, one extra physical
  page every pool carries) marks an unmapped entry.  Decode writes of
  parked slots clamp into mapped tail entries or SCRATCH, mirroring
  the contiguous engine's clamped-write band — SCRATCH absorbs the
  garbage nothing ever reads.
* ``refs[p]`` counts block-table entries (across all slots) that map
  physical page ``p``.  An entry is **writable** only while it is the
  page's sole reference; appending into a shared page first pays a
  :meth:`cow` — allocate a fresh page, (caller copies the device
  data), swap the entry — so a reader of the shared page never sees a
  neighbor's writes.
* released slots KEEP their mappings: the resident-prompt donor
  record pins pages through the table itself (no separate pin count),
  which also means eviction of a donor record is just
  :meth:`clear_slot`.

Everything is deterministic: the free list is LIFO over a fixed
initial order, so identical call sequences produce identical tables —
the property the ENGINE_FUZZ_SEED sweep and the paged-vs-contiguous
equivalence suite replay.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class PagePoolExhausted(RuntimeError):
    """No free page satisfies the request.  The serving layer turns
    this into policy: reclaim parked donor pages, preempt a
    lower-priority slot (checkpoint its pages to host), or 429."""


class PagePool:
    """Free-list page allocator + per-slot block tables.

    Pure host state; device pools are indexed BY this object's
    ``tables`` array (mirrored to the device by the engine whenever
    ``dirty`` flips).  Single-threaded by contract, like the engine
    that owns it.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_len: int) -> None:
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if max_len % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_len {max_len} "
                "(a divisor is what keeps padded admission from "
                "overflowing the table)")
        n_tables = max_len // page_size
        if n_pages < n_tables:
            raise ValueError(
                f"pool of {n_pages} pages cannot hold even one "
                f"full-length sequence ({n_tables} pages)")
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.page_size = page_size
        self.n_pages = n_pages
        self.n_slots = n_slots
        self.n_tables = n_tables
        #: the one physical page garbage writes land in and unmapped
        #: entries point at (pool arrays are sized n_pages + 1)
        self.scratch = n_pages
        self.tables = np.full((n_slots, n_tables), self.scratch,
                              np.int32)
        self.refs = np.zeros(n_pages, np.int32)
        # LIFO free list over a fixed order: pop() hands out 0, 1, 2…
        # first, and frees return to the top — deterministic for the
        # fuzz suite, and recently-touched pages (warm in cache) are
        # reused first
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        #: device block-table mirror is stale (engine re-uploads)
        self.dirty = True
        #: copy-on-write page copies performed (engine-observed too,
        #: but the pool is the single source of truth for the count)
        self.cow_copies = 0

    # -- queries ------------------------------------------------------------

    def free_pages(self) -> int:
        return len(self._free)

    def shared_pages(self) -> int:
        """Physical pages referenced by more than one table entry —
        the storage the prefix sharing is actually deduplicating."""
        return int((self.refs > 1).sum())

    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def entry(self, slot: int, idx: int) -> int:
        return int(self.tables[slot, idx])

    def mapped(self, slot: int) -> List[Tuple[int, int]]:
        """All (logical idx, physical page) mappings of *slot*."""
        row = self.tables[slot]
        return [(int(i), int(row[i])) for i in
                np.flatnonzero(row != self.scratch)]

    def writable(self, slot: int, idx: int) -> bool:
        """True when the entry maps a page this slot may write: mapped
        and sole-referenced."""
        p = int(self.tables[slot, idx])
        return p != self.scratch and int(self.refs[p]) == 1

    def pages_for(self, start: int, end: int) -> range:
        """Logical page indices covering token positions
        [*start*, *end*)."""
        if end <= start:
            return range(0)
        return range(start // self.page_size,
                     (end - 1) // self.page_size + 1)

    def pages_needed(self, tokens: int) -> int:
        """Physical pages a *tokens*-long sequence occupies — the
        capacity arithmetic resume and /migrate admission share."""
        return (tokens + self.page_size - 1) // self.page_size

    # -- allocation ---------------------------------------------------------

    def alloc(self) -> int:
        """Pop a free page (refcount 1 on mapping — alloc itself hands
        out an unreferenced page; pair with :meth:`map`)."""
        if not self._free:
            raise PagePoolExhausted(
                f"all {self.n_pages} KV pages in use")
        return self._free.pop()

    def give_back(self, page: int) -> None:
        """Return a page obtained from :meth:`alloc` that was never
        mapped (a multi-page reservation failed partway)."""
        if int(self.refs[page]) != 0:
            raise RuntimeError(
                f"give_back: page {page} is referenced")
        self._free.append(page)

    def map(self, slot: int, idx: int, page: int) -> None:
        """Install *page* at (*slot*, *idx*).  The entry must be
        unmapped (SCRATCH) — remapping without an unmap is how leaks
        happen, so it is an error here."""
        if int(self.tables[slot, idx]) != self.scratch:
            raise RuntimeError(
                f"entry ({slot}, {idx}) already mapped to "
                f"{int(self.tables[slot, idx])}")
        self.tables[slot, idx] = page
        self.refs[page] += 1
        self.dirty = True

    def unmap(self, slot: int, idx: int) -> None:
        """Drop one mapping; the page returns to the free list when
        its last reference goes."""
        p = int(self.tables[slot, idx])
        if p == self.scratch:
            return
        self.tables[slot, idx] = self.scratch
        self.refs[p] -= 1
        if int(self.refs[p]) < 0:
            raise RuntimeError(f"page {p} refcount underflow")
        if int(self.refs[p]) == 0:
            self._free.append(p)
        self.dirty = True

    def share(self, src_slot: int, n_pages: int) -> List[int]:
        """Take an extra reference on *src_slot*'s first *n_pages*
        mapped pages (a prefix share) and return them IN ORDER.  The
        caller installs them into the destination slot with
        :meth:`map_shared` AFTER clearing the destination — the
        incref-first order is what makes sharing from the destination
        slot itself (re-admitting a prompt over its own donor pages)
        safe."""
        pages: List[int] = []
        for idx in range(n_pages):
            p = int(self.tables[src_slot, idx])
            if p == self.scratch:
                raise RuntimeError(
                    f"share: donor slot {src_slot} has no page at "
                    f"logical index {idx}")
            self.refs[p] += 1
            pages.append(p)
        return pages

    def unshare(self, pages: List[int]) -> None:
        """Release references taken by :meth:`share` that were never
        installed (an admission aborted between begin and finish)."""
        for p in pages:
            self.refs[p] -= 1
            if int(self.refs[p]) < 0:
                raise RuntimeError(f"page {p} refcount underflow")
            if int(self.refs[p]) == 0:
                self._free.append(p)
        if pages:
            self.dirty = True

    def map_shared(self, slot: int, pages: List[int]) -> None:
        """Install prefix pages (reference already counted by
        :meth:`share`) at logical indices 0..len-1 of *slot*."""
        for idx, p in enumerate(pages):
            if int(self.tables[slot, idx]) != self.scratch:
                raise RuntimeError(
                    f"map_shared: entry ({slot}, {idx}) occupied")
            self.tables[slot, idx] = p
        if pages:
            self.dirty = True

    def cow(self, slot: int, idx: int, new_page: int) -> int:
        """Swap a SHARED entry for freshly-allocated *new_page* (the
        caller has already copied the device data old → new).  Returns
        the old page.  Counts the copy."""
        old = int(self.tables[slot, idx])
        if old == self.scratch:
            raise RuntimeError(f"cow: entry ({slot}, {idx}) unmapped")
        if int(self.refs[old]) <= 1:
            raise RuntimeError(
                f"cow: page {old} is not shared (write in place)")
        self.tables[slot, idx] = new_page
        self.refs[new_page] += 1
        self.refs[old] -= 1
        self.cow_copies += 1
        self.dirty = True
        return old

    def clear_slot(self, slot: int) -> None:
        """Unmap every entry of *slot* (re-admission / donor-record
        eviction / preemption).  Pages drop to the free list as their
        last references go."""
        row = self.tables[slot]
        for idx in np.flatnonzero(row != self.scratch):
            self.unmap(slot, int(idx))

    # -- invariants ---------------------------------------------------------

    def check(self) -> None:
        """Integrity oracle for the fuzz suite: refcounts equal table
        occurrences, the free list is exactly the zero-ref pages with
        no duplicates, and no table entry escapes the pool."""
        if self.tables.min() < 0 or self.tables.max() > self.scratch:
            raise AssertionError("table entry outside the pool")
        counts: Dict[int, int] = {}
        for p in self.tables.ravel().tolist():
            if p != self.scratch:
                counts[p] = counts.get(p, 0) + 1
        for p in range(self.n_pages):
            if counts.get(p, 0) != int(self.refs[p]):
                raise AssertionError(
                    f"page {p}: refs={int(self.refs[p])} but "
                    f"{counts.get(p, 0)} table references")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages in the free list")
        zero = {p for p in range(self.n_pages)
                if int(self.refs[p]) == 0}
        if free != zero:
            raise AssertionError(
                f"free list {sorted(free)} != zero-ref pages "
                f"{sorted(zero)}")

    def stats(self) -> Dict[str, int]:
        # "kv_pages" (not *_total): these bridge to /metrics as
        # GAUGES, and promlint reserves the _total suffix for counters
        return {
            "kv_pages": self.n_pages,
            "kv_pages_free": self.free_pages(),
            "kv_pages_shared": self.shared_pages(),
            "kv_page_size": self.page_size,
            "kv_cow_copies": self.cow_copies,
        }
