"""Paged serving state: the KV page pool, the register slot pool, their
host-side bookkeeping and the host swap tier.

A served model's state is `{"kv": ..., "register": ...}`, two kinds:

- **kv** leaves grow with sequence length. They live in one page pool per
  leaf - shape `[n_layers, n_pages, page_size, ...]` (a hybrid's shared
  attention block: `[n_groups, ...]`, nested under `"shared"`) - with a
  host-side block table per sequence mapping logical positions to pages.
  Pages are allocated lazily as a sequence grows and freed on completion,
  so pool memory is shared across sequences of very different lengths.
- **register** leaves are fixed-size per sequence: a Mamba2 layer's conv
  tail and SSD state. They live in slot pools - `[n_layers, n_slots, ...]`
  - and a sequence holds one slot (`RegisterAllocator`) from admission to
  release. No block table: the slot id indexes axis 1 of every register
  leaf. Register slots are never shared (the state is a running summary,
  not an addressable prefix) and never swapped.

The data path is block-table-native: the scheduler hands the pool, the
per-sequence block-table rows and the register slots straight to the
model's `forward_chunk`, which scatters each new KV row into its page and
attends by walking the table inside `kernels.ops.paged_attention`, and
gathers and writes back the register slots. No contiguous slab is ever
built on that path: `gather_pages` and the `scatter_*_rows` functions are
the reference's slab oracles, for tests and benches only.

This module keeps the bookkeeping: the refcounted allocator, block tables,
release-time scrubbing, copy-on-write page copies and the swap tier.
`alloc()` hands out pages at refcount 1, `incref()` adds a holder, and
`free()` decrements, returning a page to the free list only when its count
hits zero (the pages that actually dropped to zero are `free()`'s return
value, and exactly those are scrubbed). `alloc()` validates before mutating:
`MemoryError` on exhaustion leaves the free list untouched.

Page 0 and slot 0 are reserved as scratch: padded batch rows and padded
block-table entries point at them, so their masked reads and dead writes
can never touch a live sequence's state. A released register slot is
scrubbed with the request's pages: the next sequence reads its slot's
whole state at admission, so stale rows would leak into it.

The pool is a set of torch tensors **updated in place** - `scrub` is one
indexed fill per leaf, `cow_copy` one indexed copy per leaf, and the model's
forward writes rows into it; the JAX counterpart threads a new pool through
every call. None of these writes may run while a CUDA graph is being
captured (the engine's decode graphs read the pool): each raises if one is.

**The swap tier** (`attach_host_pool`). A block-table entry is a device page
id (an `int`, the only residency kernels ever see) or a `HostPageRef`
naming a slot of the `HostSwapPool`: one host tensor per kv leaf, pinned
when the pool lies on a CUDA device, slot-major so that each slot is one
contiguous block. On the card the transfers are asynchronous and ordered by
events on one side stream:

- swap-out gathers the victim's pages into a staging tensor on the compute
  stream; the side stream waits on an event recorded after the gather and
  copies staging -> pinned slots (`non_blocking`), then records the copy's
  event. The victim's device pages are dereffed and scrubbed on the compute
  stream right after the gather, so stream order makes their reuse safe.
  The staging tensor stays referenced until the copy's event completes.
- swap-in waits on that event, copies the pinned slots into a staging tensor
  on the side stream and records an event; the compute stream waits on it
  before the scatter into the freshly allocated pages. The host slots return
  to the free list only after that event completes.

On the CPU the same steps run as plain copies. A failed copy raises.
`_inflight` holds the device pages inside a transfer window; scrub and COW
refuse them.

**The table mirror** (`table_rows`). Beside the Python tables, which stay
the source of truth, `PagedKVCache` keeps them as one int32 host array: a
row per open sequence (row 0 all scratch, for padded batch rows), a column
per table entry, unused entries scratch, a host-resident entry
`HOST_PAGE`. Every change to a table goes through this class, which writes
the list and the mirror row together, so the decode step gathers its
`[rows, n_cols]` table in one indexed copy instead of rebuilding it from
the lists. Both dimensions double when a table or the set of open tables
outgrows them. `take_rows_written` counts the rows written since its last
call. The mirror is plain host memory: the decode step copies from its own
staging buffer, never from the mirror.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from ...kernels import ops as kops
from ...tree import leaves as tree_leaves
from ...tree import tree_map

Params = dict[str, Any]

SCRATCH_PAGE = 0
SCRATCH_SLOT = 0
HOST_PAGE = -1        # the table mirror's entry for a `HostPageRef`


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


class RegisterAllocator:
    """Free-list allocator over register slots - the `PageAllocator`
    sibling for the fixed-size state kind (slot 0 reserved as scratch).

    A sequence holds exactly one slot for its whole lifetime, so slots are
    allocated and freed one at a time, and the capacity equals the engine's
    bound on concurrent sequences. `alloc` raises `MemoryError` on
    exhaustion and `free` `ValueError` on a double or invalid free; both
    leave the allocator unchanged when they raise.
    """

    def __init__(self, n_slots: int):
        if n_slots < 2:
            raise ValueError("register pool needs at least 2 slots "
                             "(slot 0 is scratch)")
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, SCRATCH_SLOT, -1))
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable slots (excludes the scratch slot)."""
        return self.n_slots - 1

    def reset_peak(self):
        self.peak_in_use = self.in_use

    def alloc(self) -> int:
        if not self._free:
            raise MemoryError("register slots exhausted")
        out = self._free.pop()
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def free(self, slot: int):
        if slot <= SCRATCH_SLOT or slot >= self.n_slots \
                or slot in self._free:
            raise ValueError(f"double/invalid free of register slot {slot}")
        self._free.append(slot)


def _leaf_page_bytes(a: torch.Tensor) -> int:
    """Bytes one page of pool leaf `a` [n_layers, n_pages, ...] costs."""
    return a.shape[0] * math.prod(a.shape[2:]) * a.element_size()


def _runs(slots: list[int]):
    """(offset, first slot, length) of each run of consecutive slot ids, so
    that a run moves in one copy."""
    i = 0
    while i < len(slots):
        j = i + 1
        while j < len(slots) and slots[j] == slots[j - 1] + 1:
            j += 1
        yield i, slots[i], j - i
        i = j


def _done(event) -> bool:
    return event is None or event.query()


class HostPageRef:
    """Block-table entry for a host-resident page: names a slot of the
    `HostSwapPool` instead of a device page id. Kernels never see one -
    `block_table_array` and `table_rows` refuse a table holding any - so a
    sequence with host-resident pages must swap in before dispatch."""

    __slots__ = ("slot",)

    def __init__(self, slot: int):
        self.slot = slot

    def __repr__(self):
        return f"HostPageRef({self.slot})"


class HostSwapPool:
    """Host-memory mirror of the device kv page pool - the swap tier.

    One host tensor per kv leaf, `[n_slots, n_layers, page_size, ...]`:
    slot-major, so a slot is one contiguous block and a run of slots one
    copy. The tensors are pinned when the pool lies on a CUDA device, which
    is what lets a copy run asynchronously. Capacity comes from a byte
    budget and the per-page byte cost of the pool (quantized page formats
    shrink it 4-8x). Slots are a plain free list: only exclusively held
    device pages are ever swapped out, so host pages are never shared.

    `release(slots, after=event)` returns slots only once `event` (a copy
    still reading or writing them) has completed; until then they count as
    in use. `settle()` waits for every such event."""

    def __init__(self, kv_template: Params, budget_bytes: int):
        if budget_bytes < 0:
            raise ValueError("host swap budget must be >= 0 bytes")
        leaves = list(kv_template.values())
        self.page_bytes = sum(_leaf_page_bytes(a) for a in leaves)
        self.capacity = (int(budget_bytes // self.page_bytes)
                         if self.page_bytes else 0)
        pin = any(a.device.type == "cuda" for a in leaves)
        self.buf = {
            name: torch.zeros((self.capacity, a.shape[0]) + tuple(a.shape[2:]),
                              dtype=a.dtype, pin_memory=pin)
            for name, a in kv_template.items()}
        self._free = list(range(self.capacity - 1, -1, -1))
        self._free_set = set(self._free)
        # (event, slots) released while a copy still touches them
        self._deferred: list[tuple[Any, list[int]]] = []

    def _reap(self, wait: bool = False):
        keep = []
        for event, slots in self._deferred:
            if wait:
                event.synchronize()
            if _done(event):
                self._free.extend(slots)
                self._free_set.update(slots)
            else:
                keep.append((event, slots))
        self._deferred = keep

    def settle(self):
        """Wait for every copy that holds released slots, and free them."""
        self._reap(wait=True)

    @property
    def n_free(self) -> int:
        self._reap()
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.n_free

    def take(self, n: int) -> list[int]:
        """Claim `n` host slots (validated before mutating, like
        `PageAllocator.alloc`: `MemoryError` leaves the free list whole)."""
        if n > self.n_free:
            raise MemoryError(f"host swap tier exhausted: need {n}, "
                              f"free {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def release(self, slots: list[int], after=None):
        """Return slots to the free list (validated as a batch first); with
        `after`, a CUDA event, only once it has completed."""
        pending = {s for _, ss in self._deferred for s in ss}
        batch = set()
        for s in slots:
            if s < 0 or s >= self.capacity or s in self._free_set \
                    or s in pending or s in batch:
                raise ValueError(f"double/invalid release of host slot {s}")
            batch.add(s)
        if _done(after):
            self._free.extend(slots)
            self._free_set.update(slots)
        else:
            self._deferred.append((after, list(slots)))


def gather_pages(pool: Params, block_tables: torch.Tensor) -> Params:
    """Gather pages into contiguous per-sequence slabs (TEST ORACLE ONLY -
    the serving path is block-table-native and never materialises slabs).

    pool leaves: [n_layers, n_pages, page_size, ...]
    block_tables: [B, P] int page ids (pad entries = SCRATCH_PAGE)
    returns leaves: [n_layers, B, P·page_size, ...]
    """
    b, p = block_tables.shape

    def g(leaf):
        s = leaf.index_select(1, block_tables.reshape(-1).to(leaf.device,
                                                             torch.int64))
        return s.reshape(leaf.shape[0], b, p * leaf.shape[2], *leaf.shape[3:])

    return tree_map(g, pool)


def scatter_decode_rows(pool: Params, slab: Params, fill_pos: torch.Tensor,
                        page_ids: torch.Tensor,
                        offsets: torch.Tensor) -> Params:
    """Write each slot's newly decoded KV row back into its page (TEST
    ORACLE ONLY - the forward writes rows in place on the serving path).

    Extracts row `fill_pos[i]` of slot i from every slab leaf and stores it
    at (page_ids[i], offsets[i]) in a copy of the pool, which is returned.
    Padded slots point at the scratch page, so their (duplicate) writes are
    harmless.
    """
    rows = torch.arange(fill_pos.shape[0], device=fill_pos.device)

    def upd(p, s):
        new = s[:, rows, fill_pos.long()]          # [n_layers, B, ...]
        out = p.clone()
        out[:, page_ids.long(), offsets.long()] = new.to(p.dtype)
        return out

    return tree_map(upd, pool, slab)


def scatter_prefill_rows(pool: Params, slab: Params, positions: torch.Tensor,
                         page_ids: torch.Tensor,
                         offsets: torch.Tensor) -> Params:
    """Write a prefill chunk's KV rows (single sequence, slab batch row 0)
    back into a copy of its pages: slab positions `positions[j]` land at
    (page_ids[j], offsets[j]). TEST ORACLE ONLY - see gather_pages."""

    def upd(p, s):
        new = s[:, 0, positions.long()]            # [n_layers, S, ...]
        out = p.clone()
        out[:, page_ids.long(), offsets.long()] = new.to(p.dtype)
        return out

    return tree_map(upd, pool, slab)


class PagedKVCache:
    """Partitioned state + allocators + per-sequence block tables and
    register-slot map for one served model. `state` is the `{"kv": ...,
    "register": ...}` tree the adapter's `init_state` built (a bare kv pool
    is accepted and wrapped); `n_slots` sizes the register allocator when
    the state has register leaves."""

    def __init__(self, state: Params, n_pages: int, page_size: int,
                 n_slots: int = 0):
        if not (isinstance(state, dict) and set(state) == {"kv", "register"}):
            state = {"kv": state, "register": {}}
        self.state = state
        self.page_size = page_size
        self.allocator = PageAllocator(n_pages)
        # entries are device page ids (int) or HostPageRef: the per-page
        # residency ledger lives in the tables themselves
        self.tables: dict[int, list[int | HostPageRef]] = {}
        self._kv_leaves = tree_leaves(state["kv"])
        self._reg_leaves = tree_leaves(state["register"])
        self.registers = RegisterAllocator(n_slots) if self._reg_leaves \
            else None
        self.slots: dict[int, int] = {}          # rid -> register slot
        # the table mirror (module docstring): rid -> row, the free rows
        # (row 0 stays scratch), each row's entries and HOST_PAGE entries,
        # the rows written since `take_rows_written`
        rows = max(n_slots, 2)
        self._mirror = np.full((rows, 16), SCRATCH_PAGE, np.int32)
        self._row: dict[int, int] = {}
        self._free_rows = list(range(rows - 1, 0, -1))
        self._lens = [0] * rows
        self._hosted = [0] * rows
        self._written: set[int] = set()
        leaves = self._kv_leaves + self._reg_leaves
        self.device = leaves[0].device if leaves else torch.device("cpu")
        # bytes one page costs across every kv leaf (the swap cost unit)
        self.page_bytes = sum(_leaf_page_bytes(a) for a in self._kv_leaves)
        # host swap tier: absent until the engine attaches a budget
        self.host_pool: HostSwapPool | None = None
        # device pages inside a swap transfer window right now; scrub and
        # COW refuse them
        self._inflight: set[int] = set()
        # the swap tier's side stream (CUDA only, made at first use), the
        # event of each swapped-out sequence's device-to-host copy, the
        # staging tensors kept until their copy's event completes, and the
        # (start, end) timing events of the last transfer
        self._stream = None
        self._out_events: dict[int, Any] = {}
        self._staged: list[tuple[Any, dict]] = []
        self.last_transfer = None
        self.pages_scrubbed = 0
        self.slots_scrubbed = 0
        self.pages_swapped_out = 0
        self.pages_swapped_in = 0

    @property
    def pool(self) -> Params:
        return self.state["kv"]

    def _no_capture(self, what: str):
        """Pool writes run between graph replays, never inside a capture."""
        if self.device.type == "cuda" \
                and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what} writes the page pool while a CUDA "
                               "graph is being captured")

    @property
    def slot_bytes(self) -> int:
        """Bytes one register slot costs across every register leaf."""
        return sum(_leaf_page_bytes(a) for a in self._reg_leaves)

    def open(self, rid: int):
        """Open `rid`'s block table and, for register state, claim its
        slot (`MemoryError` when none is free, with nothing opened)."""
        if rid in self.tables:
            raise ValueError(f"sequence {rid} already open")
        if self.registers is not None:
            self.slots[rid] = self.registers.alloc()
        if not self._free_rows:
            self._grow_mirror(2 * len(self._mirror), 0)
        self._row[rid] = self._free_rows.pop()
        self.tables[rid] = []

    def ensure(self, rid: int, n_tokens: int):
        """Grow `rid`'s block table to cover `n_tokens` positions."""
        need = pages_for(n_tokens, self.page_size) - len(self.tables[rid])
        if need > 0:
            self.extend(rid, self.allocator.alloc(need))

    def extend(self, rid: int, pages: list[int]):
        """Append device pages, whose references the caller holds, to
        `rid`'s table: growth, or pages adopted from the radix tree."""
        table = self.tables[rid]
        start = len(table)
        table.extend(pages)
        self._write_row(rid, start)

    def release(self, rid: int, adopted: int = 0):
        """Return `rid`'s pages and register slot. The first `adopted`
        table entries' references were taken over by another holder (the
        radix prefix tree) and are skipped; the rest are dereffed, and only
        pages that dropped to refcount 0 are scrubbed - together with the
        register slot. Host-resident entries (a swapped-out sequence
        cancelled, expired or degraded to replay) return their slots to the
        swap tier once the copy into them has landed."""
        entries = self.tables.pop(rid)[adopted:]
        row = self._row.pop(rid)
        self._mirror[row, :self._lens[row]] = SCRATCH_PAGE
        self._lens[row] = self._hosted[row] = 0
        self._free_rows.append(row)
        self._written.add(row)
        slot = self.slots.pop(rid, None)
        after = self._out_events.pop(rid, None)
        self.deref([p for p in entries if isinstance(p, int)], slot)
        host_slots = [e.slot for e in entries if isinstance(e, HostPageRef)]
        if host_slots:
            self.host_pool.release(host_slots, after=after)
        if slot is not None:
            self.registers.free(slot)

    def deref(self, pages: list[int], slot: int | None = None):
        """Drop one reference per page; scrub whatever actually freed, and
        `slot` with it (one `scrub` call either way)."""
        freed = self.allocator.free(pages)
        if slot is None:
            self.scrub(freed)
        else:
            self.scrub(freed, slot)

    def scrub(self, pages: list[int], slot: int | None = None):
        """Zero released state of both kinds so a recycled page or slot can
        never leak its predecessor's: the pages' rows of every kv leaf and
        `slot` of every register leaf, indexed fills in place, tallied
        together as one `scrub_state` dispatch under the reference's path
        tag (`kernels_enabled()`). For register leaves this is load-
        bearing: a sequence reads its slot's whole state at admission.
        Callers pass only pages that dropped to refcount 0 - scrubbing a
        still-shared page would corrupt every surviving holder - and never
        a page inside a swap transfer."""
        bad = set(pages) & self._inflight
        assert not bad, f"scrub of in-flight swap page(s) {sorted(bad)}"
        for p in pages:
            assert self.allocator.refcount(p) == 0, \
                f"scrub of still-referenced page {p}"
        do_pages = bool(pages) and bool(self._kv_leaves)
        do_slot = slot is not None and bool(self._reg_leaves)
        if not do_pages and not do_slot:
            return
        self._no_capture("scrub")
        kops._record_dispatch("scrub_state", kops.kernels_enabled())
        if do_pages:
            idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
            for leaf in self._kv_leaves:
                leaf.index_fill_(1, idx, 0)
            self.pages_scrubbed += len(pages)
        if do_slot:
            for leaf in self._reg_leaves:
                leaf[:, slot].zero_()
            self.slots_scrubbed += 1

    def cow_copy(self, src: int, dst: int):
        """Copy-on-write: duplicate page `src` into `dst` on every kv leaf,
        in place (tallied as one `cow_page_copy` dispatch). The caller owns
        `dst` exclusively and may then overwrite rows past the shared
        prefix without disturbing `src`'s other holders. Both ends are live
        device pages: a host-resident page has no device id, so the asserts
        pin the residency contract (COW never reads a swapped or in-flight
        source)."""
        assert src not in self._inflight and dst not in self._inflight, \
            f"cow touching in-flight swap page ({src} -> {dst})"
        assert self.allocator.refcount(src) >= 1, \
            f"cow from unallocated (or host-resident) page {src}"
        self._no_capture("cow_copy")
        kops._record_dispatch("cow_page_copy", kops.kernels_enabled())
        for leaf in self._kv_leaves:
            leaf[:, dst].copy_(leaf[:, src])

    # ------------------------------------------------------------------
    # host swap tier
    # ------------------------------------------------------------------

    def attach_host_pool(self, host_mb: float) -> HostSwapPool:
        """Create the host swap tier under a `host_mb` MiB budget (page
        capacity = budget // page_bytes; a budget smaller than one page
        yields capacity 0, which disables swap-out)."""
        self.host_pool = HostSwapPool(self.state["kv"],
                                      int(host_mb * 2 ** 20))
        if self._side_stream() is not None and self.host_pool.capacity:
            self._prime()
        return self.host_pool

    def _prime(self):
        """Pay the transfer path's one-time costs here, not in the first
        swap a request waits on: the side stream's creation and the first
        load of the gather and scatter kernels (lazily loaded by CUDA;
        together ~0.2 s on an H100). The scratch page is gathered and
        written back to itself - its contents are garbage by contract."""
        idx = torch.tensor([SCRATCH_PAGE], dtype=torch.int64,
                           device=self.device)
        for leaf in self._kv_leaves:
            leaf.index_copy_(1, idx, leaf.transpose(0, 1).index_select(
                0, idx).transpose(0, 1))
        torch.cuda.synchronize(self.device)

    def residency(self, rid: int) -> list[str]:
        """Per-table-entry residency of `rid`: "device", "host", or
        "in_flight"."""
        out = []
        for e in self.tables[rid]:
            if isinstance(e, HostPageRef):
                out.append("host")
            elif e in self._inflight:
                out.append("in_flight")
            else:
                out.append("device")
        return out

    def swap_eligible_pages(self, rid: int) -> list[int]:
        """Device pages of `rid` that swap-out would move: exactly the
        exclusively held ones (refcount 1). Shared pages - radix-tree or
        sibling references - keep the victim's reference and stay on the
        device, so a shared page swaps at most once and a COW source is
        never host-resident."""
        alloc = self.allocator
        return [p for p in self.tables[rid]
                if isinstance(p, int) and alloc.refcount(p) == 1]

    def _side_stream(self):
        if self.device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _events(self):
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def settle(self):
        """Wait for every swap copy in flight and drop what it held."""
        for event, _ in self._staged:
            event.synchronize()
        self._staged.clear()
        if self.host_pool is not None:
            self.host_pool.settle()

    def swap_out(self, rid: int) -> tuple[int, int]:
        """Move `rid`'s exclusively held pages to the host tier; returns
        `(pages_moved, bytes_moved)`.

        One gather per leaf on the compute stream, then the copy to the
        host slots (on the side stream, behind an event, on the card); the
        table entries become `HostPageRef`s in place and the device copies
        are dereffed - dropping the sole reference, so they scrub and
        return to the allocator. Host slots are claimed *before* the
        transfer (`MemoryError` on a full tier mutates nothing)."""
        if self.host_pool is None:
            raise RuntimeError("no host swap pool attached")
        table = self.tables[rid]
        moved = [(i, p) for i, p in enumerate(table)
                 if isinstance(p, int) and self.allocator.refcount(p) == 1]
        if not moved:
            return 0, 0
        self._no_capture("swap_out")
        pages = [p for _, p in moved]
        slots = self.host_pool.take(len(pages))
        self._inflight.update(pages)
        kops._record_dispatch("swap_out", kops.kernels_enabled())
        self._copy_out(rid, pages, slots)
        self._inflight.difference_update(pages)
        for (i, _), s in zip(moved, slots):
            table[i] = HostPageRef(s)
        self._write_row(rid)
        self.deref(pages)
        self.pages_swapped_out += len(pages)
        return len(pages), len(pages) * self.page_bytes

    def _copy_out(self, rid: int, pages: list[int], slots: list[int]):
        self._staged = [(e, t) for e, t in self._staged if not _done(e)]
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        # [n, n_layers, page_size, ...] per leaf: the slot-major layout
        staging = {name: leaf.transpose(0, 1).index_select(0, idx)
                   for name, leaf in self.pool.items()}
        side = self._side_stream()
        if side is None:
            for name, block in staging.items():
                for a, s, n in _runs(slots):
                    self.host_pool.buf[name][s:s + n].copy_(block[a:a + n])
            return
        gathered = torch.cuda.Event()
        gathered.record(torch.cuda.current_stream(self.device))
        side.wait_event(gathered)
        start, end = self._events()
        with torch.cuda.stream(side):
            start.record(side)
            for name, block in staging.items():
                host = self.host_pool.buf[name]
                for a, s, n in _runs(slots):
                    host[s:s + n].copy_(block[a:a + n], non_blocking=True)
            end.record(side)
        self._staged.append((end, staging))
        self._out_events[rid] = end
        self.last_transfer = (start, end)

    def swap_in(self, rid: int,
                alloc_fn: Callable[[int], list[int]] | None = None
                ) -> tuple[int, int]:
        """Restore `rid`'s host-resident pages to the device tier; returns
        `(pages_moved, bytes_moved)`.

        Fresh device pages are allocated first - through `alloc_fn` when
        the caller has a smarter allocator (the scheduler's tree-evicting
        one) - so a `MemoryError` leaves table, host tier and allocator
        untouched. The copy into a staging tensor (on the side stream, on
        the card) and one scatter per leaf write the blocks back, the
        block-table row is patched in place (the pages hold the rows they
        held before swap-out), and the host slots are freed once the copy
        has read them."""
        table = self.tables[rid]
        refs = [(i, e) for i, e in enumerate(table)
                if isinstance(e, HostPageRef)]
        if not refs:
            return 0, 0
        self._no_capture("swap_in")
        slots = [e.slot for _, e in refs]
        new_pages = (alloc_fn or self.allocator.alloc)(len(refs))
        self._inflight.update(new_pages)
        kops._record_dispatch("swap_in", kops.kernels_enabled())
        done = self._copy_in(rid, slots, new_pages)
        self._inflight.difference_update(new_pages)
        for (i, _), p in zip(refs, new_pages):
            table[i] = p
        self._write_row(rid)
        self._out_events.pop(rid, None)
        self.host_pool.release(slots, after=done)
        self.pages_swapped_in += len(refs)
        return len(refs), len(refs) * self.page_bytes

    def _copy_in(self, rid: int, slots: list[int], pages: list[int]):
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        host = self.host_pool.buf
        side = self._side_stream()
        if side is None:
            for name, leaf in self.pool.items():
                block = torch.cat([host[name][s:s + n]
                                   for _, s, n in _runs(slots)])
                leaf.index_copy_(1, idx, block.transpose(0, 1))
            return None
        out_event = self._out_events.get(rid)
        if out_event is not None:
            side.wait_event(out_event)      # the copy into the slots landed
        start, end = self._events()
        with torch.cuda.stream(side):
            start.record(side)
            staging = {}
            for name, buf in host.items():
                block = torch.empty((len(slots),) + tuple(buf.shape[1:]),
                                    dtype=buf.dtype, device=self.device)
                for a, s, n in _runs(slots):
                    block[a:a + n].copy_(buf[s:s + n], non_blocking=True)
                staging[name] = block
            end.record(side)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(end)
        for name, leaf in self.pool.items():
            leaf.index_copy_(1, idx, staging[name].transpose(0, 1))
            # made on the side stream, read on the compute stream: its
            # memory is reused only after the scatter
            staging[name].record_stream(compute)
        self.last_transfer = (start, end)
        return end

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

    # ------------------------------------------------------------------
    # the table mirror
    # ------------------------------------------------------------------

    def _grow_mirror(self, rows: int, cols: int):
        """Widen the mirror to at least `rows` x `cols`; new rows are free
        and new entries scratch."""
        r, c = self._mirror.shape
        grown = np.full((max(rows, r), max(cols, c)), SCRATCH_PAGE, np.int32)
        grown[:r, :c] = self._mirror
        self._mirror = grown
        if len(grown) > r:
            self._lens += [0] * (len(grown) - r)
            self._hosted += [0] * (len(grown) - r)
            self._free_rows.extend(range(len(grown) - 1, r - 1, -1))

    def _write_row(self, rid: int, start: int = 0):
        """Mirror `rid`'s table from entry `start` on. From 0 (swap-out and
        swap-in rewrite entries in place) the host-resident entries are
        counted again; a later start appends device pages only."""
        table = self.tables[rid]
        row, n = self._row[rid], len(table)
        if n > self._mirror.shape[1]:
            self._grow_mirror(0, 1 << (n - 1).bit_length())
        if start == 0:
            entries = [HOST_PAGE if isinstance(e, HostPageRef) else e
                       for e in table]
            self._hosted[row] = entries.count(HOST_PAGE)
        else:
            entries = table[start:]
        self._mirror[row, start:n] = entries
        self._lens[row] = n
        self._written.add(row)

    def take_rows_written(self) -> int:
        """How many mirror rows were written since the last call."""
        n = len(self._written)
        self._written.clear()
        return n

    def table_rows(self, rids: list[int | None], n_cols: int,
                   out: np.ndarray | None = None) -> np.ndarray:
        """`block_table_array(rids, n_cols)`'s values as a host int32 array,
        gathered from the mirror in one indexed copy (into `out` when
        given): the decode step's table. It refuses what
        `block_table_array` refuses, from the per-row counts, without
        reading the rows."""
        idx = [self._row[r] if r is not None else 0 for r in rids]
        for r, i in zip(rids, idx):
            if self._lens[i] > n_cols:
                raise ValueError(
                    f"block table for sequence {r} holds {self._lens[i]} "
                    f"pages but only {n_cols} columns were requested")
            if self._hosted[i]:
                raise ValueError(
                    f"sequence {r} has host-resident pages; it must swap "
                    f"in before any kernel dispatch")
        if n_cols > self._mirror.shape[1]:
            self._grow_mirror(0, n_cols)
        # the rows are the mirror's own: "clip" only skips the bounds
        # check and the buffered copy it takes
        return np.take(self._mirror[:, :n_cols], idx, axis=0, out=out,
                       mode="clip")

    def check_mirror(self):
        """Assert that the mirror holds every open table as
        `block_table_array` builds it (host-resident entries as
        `HOST_PAGE`), and that row 0 and the free rows are scratch."""
        assert set(self._row) == set(self.tables), (self._row, self.tables)
        rows = list(self._row.values()) + self._free_rows
        assert sorted(rows) == list(range(1, len(self._mirror))), rows
        cols = self._mirror.shape[1]
        for rid, table in self.tables.items():
            row = self._row[rid]
            want = [HOST_PAGE if isinstance(e, HostPageRef) else e
                    for e in table]
            assert self._lens[row] == len(want), (rid, self._lens[row])
            assert self._hosted[row] == want.count(HOST_PAGE), rid
            assert self._mirror[row].tolist() \
                == want + [SCRATCH_PAGE] * (cols - len(want)), rid
            if HOST_PAGE not in want:
                n_cols = max(len(want), 1)
                assert np.array_equal(
                    self.table_rows([rid], n_cols),
                    self.block_table_array([rid], n_cols).cpu().numpy()), rid
        free = [0] + self._free_rows
        assert not self._mirror[free].any(), free
        assert not any(self._lens[i] or self._hosted[i] for i in free), free

    def register_index_array(self, rids: list[int | None]) -> torch.Tensor:
        """[len(rids)] int32 register slot per batch row, on the state's
        device; `None` (padded) rows point at the scratch slot, so their
        dead writes never touch a live sequence's state."""
        return torch.tensor(
            [self.slots[r] if r is not None else SCRATCH_SLOT for r in rids],
            dtype=torch.int32, device=self.device)
