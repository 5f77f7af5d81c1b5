"""Radix prefix cache: token-id-keyed tree over refcounted KV pages.

Production traffic is dominated by shared prefixes — system prompts,
few-shot headers, multi-turn chat histories — whose prefill the engine
used to recompute from scratch for every request. This module keeps the
KV pages of *finished* streams alive in a vLLM/SGLang-style radix tree
keyed on token ids, so a later request whose prompt shares a prefix is
admitted with those pages already in its block table and chunked prefill
starts at the divergence offset instead of position 0. The INT4 KV page
formats this repo serves make shared prefixes 4× denser in HBM, so the
deduplication compounds with the quantization win.

Design:

  * **Nodes own page-granular runs of the pool.** Every edge's token run
    is a whole number of pages (`len(node.tokens) == len(node.pages) ·
    page_size`) and only *full* pages are ever inserted — the tail rows
    of a stream that don't fill a page are released normally. Splits
    therefore happen at page boundaries; where two streams diverge
    *inside* a page, the tree keeps only the page-aligned common prefix.
  * **The tree is a holder like any sequence.** Inserted pages carry the
    tree's reference in `PageAllocator`'s refcounts; a matching request
    increfs them into its own block table, so a page is freed (and
    scrubbed) only when the tree *and* every sequence using it have let
    go. Pages in the tree are immutable: a sequence that needs to write
    into one first copies it (`PagedKVCache.cow_copy`) — see `match`.
  * **Matching is token-granular via copy-on-write.** `match` walks the
    tree for the longest fully-matched page run, then peeks one page
    further: if the next cached page agrees on a partial run of tokens,
    it is reported as a COW candidate — the scheduler copies it into a
    fresh page and resumes prefill mid-page, recovering the sub-page
    sharing the page-aligned storage cannot represent.
  * **LRU eviction under a page budget.** Each matched/inserted node is
    stamped with a monotonic clock; `evict` trims least-recently-used
    leaves first (truncating a leaf's page run from the tail, dropping
    the node when it empties), skipping pages still referenced by live
    sequences. Inserts that would exceed `max_pages` evict first and
    drop whatever still does not fit. The scheduler also calls `evict`
    under allocator pressure, so cached prefixes are reclaimed before
    any live sequence is preempted.

Register slots never appear here: SSM conv/SSD state is a
position-dependent running summary, not an addressable prefix, so the
engine only enables the cache for pure-kv state specs.
"""
from __future__ import annotations

from .pages import PagedKVCache


class RadixNode:
    """One edge of the tree: a page-aligned token run and its pages."""

    __slots__ = ("tokens", "pages", "children", "parent", "last_access")

    def __init__(self, tokens: list[int], pages: list[int],
                 parent: "RadixNode | None"):
        self.tokens = tokens        # len == len(pages) * page_size
        self.pages = pages
        self.children: dict[int, RadixNode] = {}  # keyed by first token
        self.parent = parent
        self.last_access = 0


def _common_prefix(a: list[int], b: list[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixCache:
    """Token-id-keyed radix tree over one `PagedKVCache`'s page pool."""

    def __init__(self, kv: PagedKVCache, max_pages: int | None = None):
        if max_pages is not None and max_pages < 0:
            raise ValueError("max_pages must be >= 0 (None = unbounded)")
        self.kv = kv
        self.page_size = kv.page_size
        self.max_pages = max_pages
        self.root = RadixNode([], [], None)
        self._clock = 0
        self.n_pages = 0       # pages the tree currently holds a ref on
        # telemetry, mirrored into the engine's registry
        self.evicted_pages = 0
        self.inserted_pages = 0

    @property
    def n_nodes(self) -> int:
        def count(node: RadixNode) -> int:
            return 1 + sum(count(c) for c in node.children.values())
        return count(self.root) - 1    # root is not a real node

    def _touch(self, node: RadixNode):
        self._clock += 1
        node.last_access = self._clock

    # ------------------------------------------------------------------
    # match
    # ------------------------------------------------------------------

    def match(self, tokens: list[int]
              ) -> tuple[list[int], tuple[int, int] | None]:
        """Longest cached prefix of `tokens`.

        Returns `(pages, cow)`: the fully-matched pages (covering
        `len(pages) · page_size` leading tokens), and — when the next
        cached page agrees on a further partial run — a `(page_id,
        n_extra_tokens)` copy-on-write candidate, `0 < n_extra <
        page_size`. The caller takes its own references (`incref`) on
        whatever it uses; this method only reads and LRU-stamps the
        matched path."""
        ps = self.page_size
        node, i, pages = self.root, 0, []
        while True:
            child = node.children.get(tokens[i]) if i < len(tokens) else None
            if child is None:
                return pages, None
            m = _common_prefix(child.tokens, tokens[i:])
            full = m // ps
            self._touch(child)
            if m == len(child.tokens) and i + m < len(tokens):
                pages += child.pages
                node, i = child, i + m
                continue
            # divergence (or token exhaustion) inside this edge
            pages += child.pages[:full]
            extra = m - full * ps
            cow = (child.pages[full], extra) if extra else None
            return pages, cow

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------

    def insert(self, tokens: list[int], pages: list[int]) -> int:
        """Offer a finished stream's page-aligned prefix to the tree.

        `pages` must cover `tokens` exactly (`len(tokens) == len(pages) ·
        page_size`) and the caller's reference on every page is consumed:
        pages the tree adopts keep it (ownership transfer — no refcount
        traffic), pages already cached under the same tokens (or dropped
        for budget/misalignment reasons) are deref'd through
        `PagedKVCache.deref`, scrubbing any that hit refcount 0. Returns
        the number of pages adopted."""
        ps = self.page_size
        if len(tokens) != len(pages) * ps:
            raise ValueError(
                f"insert needs page-aligned tokens: {len(tokens)} tokens "
                f"vs {len(pages)} pages of {ps}")
        node, i, j = self.root, 0, 0
        adopted = 0
        while j < len(pages):
            child = node.children.get(tokens[i])
            if child is None:
                new = pages[j:]
                node_len = len(node.tokens)
                fit = self._make_room(len(new))
                # _make_room may evict *this very path* (the walk just
                # deref'd our duplicate refs, so its pages sit at
                # refcount 1): if the attach point was trimmed or
                # detached, a leaf hung off it would be unreachable —
                # give the pages back instead
                if not (self._attached(node)
                        and len(node.tokens) == node_len):
                    self.kv.deref(new)
                    return adopted
                if fit < len(new):
                    self.kv.deref(new[fit:])
                if fit:
                    leaf = RadixNode(tokens[i:i + fit * ps], new[:fit], node)
                    node.children[tokens[i]] = leaf
                    self._touch(leaf)
                    self.n_pages += fit
                    self.inserted_pages += fit
                    adopted += fit
                return adopted
            m = _common_prefix(child.tokens, tokens[i:])
            full = m // ps
            self._touch(child)
            if full == 0:
                # diverges inside the edge's first page: nothing below
                # this child is representable page-aligned
                self.kv.deref(pages[j:])
                return adopted
            # the overlapping run duplicates cached pages — drop ours
            # (usually the very pages we were admitted with, whose tree
            # refs are already held; deref also covers an independent
            # recompute of the same prefix)
            self.kv.deref(pages[j:j + full])
            if m < len(child.tokens):
                if m > full * ps:
                    # divergence mid-page past the aligned overlap: the
                    # remainder shares its first token with the split-off
                    # edge, so it cannot become a sibling — drop it
                    self._split(child, full)
                    self.kv.deref(pages[j + full:])
                    return adopted
                self._split(child, full)
                child = child.parent     # the new upper half
            node, i, j = child, i + full * ps, j + full
        return adopted

    def _attached(self, node: RadixNode) -> bool:
        """Is `node` still reachable from the root? Eviction removes
        emptied leaves, so a node held across a `_make_room` call may
        have left the tree."""
        while node.parent is not None:
            node = node.parent
        return node is self.root

    def _split(self, child: RadixNode, full: int):
        """Split `child` at `full` pages: a new upper node keeps the
        first `full` pages, `child` keeps the remainder below it."""
        ps = self.page_size
        upper = RadixNode(child.tokens[:full * ps], child.pages[:full],
                          child.parent)
        upper.last_access = child.last_access
        child.parent.children[child.tokens[0]] = upper
        child.tokens = child.tokens[full * ps:]
        child.pages = child.pages[full:]
        child.parent = upper
        upper.children[child.tokens[0]] = child

    def _make_room(self, n: int) -> int:
        """Pages of budget available for an insert of `n`, evicting LRU
        entries if needed; returns how many of the `n` fit."""
        if self.max_pages is None:
            return n
        over = self.n_pages + n - self.max_pages
        if over > 0:
            self.evict(over)
        return max(0, min(n, self.max_pages - self.n_pages))

    # ------------------------------------------------------------------
    # evict
    # ------------------------------------------------------------------

    def _leaves(self) -> list[RadixNode]:
        out = []

        def walk(node: RadixNode):
            for c in node.children.values():
                if c.children:
                    walk(c)
                else:
                    out.append(c)
        walk(self.root)
        return out

    def evict(self, n: int) -> int:
        """Free up to `n` tree-held pages, least-recently-used leaves
        first. A leaf is trimmed from the *tail* of its page run (later
        positions depend on earlier ones, never the reverse) and only
        pages whose sole holder is the tree are dropped — pages a live
        sequence still references are pinned and skipped. Returns the
        number of pages actually freed (deref'd at refcount 1, so they
        were scrubbed and returned to the allocator)."""
        freed = 0
        alloc = self.kv.allocator
        while freed < n:
            victims = sorted((leaf for leaf in self._leaves()),
                             key=lambda node: node.last_access)
            progressed = False
            for leaf in victims:
                # trim the longest evictable tail run of this leaf
                k = 0
                while k < len(leaf.pages) - 0 and freed + k < n \
                        and alloc.refcount(leaf.pages[-(k + 1)]) == 1:
                    k += 1
                if k == 0:
                    continue
                drop = leaf.pages[len(leaf.pages) - k:]
                ps = self.page_size
                del leaf.pages[len(leaf.pages) - k:]
                del leaf.tokens[len(leaf.tokens) - k * ps:]
                if not leaf.pages:
                    del leaf.parent.children[
                        next(t for t, c in leaf.parent.children.items()
                             if c is leaf)]
                self.kv.deref(drop)
                self.n_pages -= k
                self.evicted_pages += k
                freed += k
                progressed = True
                break           # re-rank: the trim may expose a parent
            if not progressed:
                break
        return freed

    def clear(self) -> int:
        """Drop every cached page (deref'd, scrubbing the exclusively
        held ones); returns how many the tree let go."""
        dropped = 0

        def walk(node: RadixNode):
            nonlocal dropped
            for c in list(node.children.values()):
                walk(c)
            if node is not self.root:
                self.kv.deref(node.pages)
                dropped += len(node.pages)
        walk(self.root)
        self.root = RadixNode([], [], None)
        self.n_pages = 0
        return dropped

    def held_pages(self) -> set[int]:
        """Every page id the tree currently references (accounting)."""
        out: set[int] = set()

        def walk(node: RadixNode):
            out.update(node.pages)
            for c in node.children.values():
                walk(c)
        walk(self.root)
        return out
