"""Paged serving state: the KV page pool and its host-side bookkeeping.

KV leaves grow with sequence length. They live in one page pool per leaf -
shape `[n_layers, n_pages, page_size, ...]` - with a host-side block table
per sequence mapping logical positions to pages. Pages are allocated lazily
as a sequence grows and freed on completion, so pool memory is shared across
sequences of very different lengths.

The data path is block-table-native: the scheduler hands the pool and the
per-sequence block-table rows straight to the model's `forward_chunk`, which
scatters each new KV row into its page and attends by walking the table
inside `kernels.ops.paged_attention`. No contiguous slab is ever built.

This module keeps the bookkeeping: the refcounted allocator, block tables,
and release-time scrubbing. `alloc()` hands out pages at refcount 1,
`incref()` adds a holder, and `free()` decrements, returning a page to the
free list only when its count hits zero (the pages that actually dropped to
zero are `free()`'s return value, and exactly those are scrubbed). `alloc()`
validates before mutating: `MemoryError` on exhaustion leaves the free list
untouched.

Page 0 is reserved as scratch: padded batch rows and padded block-table
entries point at it, so their masked reads and dead writes can never touch
a live sequence's state.

The pool is a set of torch tensors **updated in place** - `scrub` is one
indexed fill per leaf, and the model's forward writes rows into it; the JAX
counterpart threads a new pool through every call.

Not ported yet: register slots (SSM state), copy-on-write page copies and
the host swap tier.
"""
from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

SCRATCH_PAGE = 0


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold `n_tokens` KV rows."""
    return -(-n_tokens // page_size)


class PageAllocator:
    """Host-side refcounted free-list allocator over pool pages (page 0
    reserved).

    A membership set shadows the LIFO stack so the double-free guard is O(1)
    per page. Every allocated page carries a reference count (`alloc` -> 1,
    `incref` adds holders); `free` decrements and a page returns to the free
    list only at count zero.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("pool needs at least 2 pages (page 0 is scratch)")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, SCRATCH_PAGE, -1))
        self._free_set = set(self._free)
        self._refs: dict[int, int] = {}   # page -> holders (allocated only)
        # high-water mark of pages simultaneously in use
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the scratch page)."""
        return self.n_pages - 1

    def reset_peak(self):
        self.peak_in_use = self.in_use

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"page pool exhausted: need {n}, "
                              f"free {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        for p in out:
            self._refs[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def incref(self, pages: list[int]):
        """Add one holder to each (allocated) page - validated as a batch
        before mutating, like `free`."""
        for p in pages:
            if p <= SCRATCH_PAGE or p >= self.n_pages \
                    or p in self._free_set:
                raise ValueError(f"incref of unallocated page {p}")
        for p in pages:
            self._refs[p] += 1

    def refcount(self, page: int) -> int:
        """Current holder count (0 for free pages)."""
        return self._refs.get(page, 0) if page not in self._free_set else 0

    @property
    def n_shared(self) -> int:
        """Pages currently held by more than one owner."""
        return sum(1 for c in self._refs.values() if c > 1)

    def free(self, pages: list[int]) -> list[int]:
        """Drop one reference per page; returns the pages whose count hit
        zero and were returned to the free list (exactly the set the caller
        must scrub)."""
        # validate the whole batch (including intra-batch duplicates)
        # before mutating, so a raise leaves the allocator consistent
        batch = set()
        for p in pages:
            if p <= SCRATCH_PAGE or p >= self.n_pages \
                    or p in self._free_set or p in batch:
                raise ValueError(f"double/invalid free of page {p}")
            batch.add(p)
        freed = []
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                freed.append(p)
        self._free.extend(freed)
        self._free_set.update(freed)
        return freed


class PagedKVCache:
    """Pool state + allocator + per-sequence block tables for one served
    model. `state` is the `{"kv": ..., "register": {}}` tree the adapter's
    `init_state` built (a bare kv pool is accepted and wrapped)."""

    def __init__(self, state: Params, n_pages: int, page_size: int):
        if not (isinstance(state, dict) and set(state) == {"kv", "register"}):
            state = {"kv": state, "register": {}}
        if state["register"]:
            raise NotImplementedError(
                "register-slot state (SSM families) is not ported yet "
                "(ROADMAP Queue A10)")
        self.state = state
        self.page_size = page_size
        self.allocator = PageAllocator(n_pages)
        self.tables: dict[int, list[int]] = {}
        leaves = list(state["kv"].values())
        self.device = leaves[0].device if leaves else torch.device("cpu")
        # bytes one page costs across every kv leaf
        self.page_bytes = sum(
            a.shape[0] * a[0, 0].numel() * a.element_size() for a in leaves)
        self.pages_scrubbed = 0

    @property
    def pool(self) -> Params:
        return self.state["kv"]

    def open(self, rid: int):
        if rid in self.tables:
            raise ValueError(f"sequence {rid} already open")
        self.tables[rid] = []

    def ensure(self, rid: int, n_tokens: int):
        """Grow `rid`'s block table to cover `n_tokens` positions."""
        table = self.tables[rid]
        need = pages_for(n_tokens, self.page_size) - len(table)
        if need > 0:
            table.extend(self.allocator.alloc(need))

    def release(self, rid: int):
        """Return `rid`'s pages; the ones that dropped to refcount 0 are
        scrubbed."""
        self.deref(self.tables.pop(rid))

    def deref(self, pages: list[int]):
        """Drop one reference per page; scrub whatever actually freed."""
        self.scrub(self.allocator.free(pages))

    def scrub(self, pages: list[int]):
        """Zero released pages so a recycled page can never leak its
        predecessor's rows: one indexed fill per pool leaf, in place.
        Callers pass only pages that dropped to refcount 0 - scrubbing a
        still-shared page would corrupt every surviving holder."""
        for p in pages:
            assert self.allocator.refcount(p) == 0, \
                f"scrub of still-referenced page {p}"
        if not pages or not self.state["kv"]:
            return
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        for leaf in self.state["kv"].values():
            leaf.index_fill_(1, idx, 0)
        self.pages_scrubbed += len(pages)

    def page_of(self, rid: int, position: int) -> tuple[int, int]:
        """(page id, in-page offset) holding `position` of sequence `rid`."""
        return (self.tables[rid][position // self.page_size],
                position % self.page_size)

    def block_table_array(self, rids: list[int | None],
                          n_cols: int) -> torch.Tensor:
        """[len(rids), n_cols] int32 table on the pool's device, short rows
        padded with scratch. `None` entries are padded batch rows
        (all-scratch).

        A row longer than `n_cols` is an error, never a silent truncation:
        a too-narrow table would drop live pages from the kernel's walk
        (and from the write targeting) without any visible failure.
        """
        bt = [self.tables[r] if r is not None else [] for r in rids]
        for r, row in zip(rids, bt):
            if len(row) > n_cols:
                raise ValueError(
                    f"block table for sequence {r} holds {len(row)} pages "
                    f"but only {n_cols} columns were requested")
            if any(not isinstance(p, int) for p in row):
                raise ValueError(
                    f"sequence {r} has host-resident pages; it must swap "
                    f"in before any kernel dispatch")
        bt = [row + [SCRATCH_PAGE] * (n_cols - len(row)) for row in bt]
        return torch.tensor(bt, dtype=torch.int32,
                            device=self.device).reshape(len(rids), n_cols)
