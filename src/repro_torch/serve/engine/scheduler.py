"""Continuous-batching scheduler over the paged serving state.

Scheduling model (one `step()` = one engine iteration):

  1. **Lifecycle sweep** - injected faults (cancel/expiry chaos from an
     attached `FaultPlan`) and per-request deadlines are applied at the
     step boundary: a cancelled or expired request leaves whatever phase it
     is in with its pages scrubbed and returned.
  2. **Admission** - two policies, selected at construction:

     * `"optimistic"` (default): admit when the pages for the request's
       *prompt* plus a small headroom watermark fit next to the pages
       already committed. The pool can then exhaust mid-decode, which
       preemption (below) recovers from.
     * `"reserve"`: admit only when `pages_for(prompt + max_new)`
       worst-case pages fit, so a running sequence can never hit an
       out-of-pages fault.

     Committed pages are a running total (`_committed_total`), so
     admission is O(queue). Backoff-waiting replays are skipped; otherwise
     admission blocks head-of-line for fairness. With the **prefix cache**
     (`prefix_cache=True`) admission matches the request's stream against
     the radix tree (`radix.RadixCache`): fully matched pages are incref'd
     into the block table, a partial-page match is copied (COW) into a
     private page, and `n_cached` starts at the hit length, so chunked
     prefill begins at the divergence offset. Finished requests donate
     their page-aligned prefix to the tree; under page pressure the tree
     is evicted (`_reclaim`) before any live sequence is preempted.
  3. **Decode** - every generating sequence advances one token in a single
     batched `forward_chunk` call with per-slot fill positions and
     block-table rows, padded to `max_seqs` rows so the kernels see fixed
     shapes. Table widths are padded to powers of two. Page growth runs
     first, under the preemption guard, and the batch is read after it.
     Forward, sampling and the per-row max logit are one fused dispatch
     (`_fused`, the reference's counterpart): on the card a CUDA graph per
     variant - table width, probe, sampling, filtering - captured at the
     variant's first step and replayed at every later one, its inputs
     copied into static buffers first (the block table among them, so a
     replay walks whatever rows preemption, COW and swap-in wrote) and its
     tokens read back in one transfer. No pool write (scrub, COW, swap)
     runs inside a capture: they all happen between dispatches.
  4. **Chunked prefill** - the rest of the per-step token budget goes to
     the head-of-line stream, `prefill_chunk` tokens at a time, chunks
     padded to the next power of two. A *replay* (preempted request)
     prefills `prompt + generated` through the same path.

**Preemption / replay.** When page growth would exhaust the allocator
(really, or via an injected fault), the scheduler preempts a victim - the
active page-holding request with the fewest generated tokens,
latest-admitted breaking ties - releasing its pages through the scrub path,
and re-queues it at the front with exponential step backoff. Replay
re-prefills `prompt + generated`; sampling draws from `(seed, rid,
position)` only, and the replay's prefill samples at the position the
undisturbed decode used. A request preempted more than `max_preemptions`
times fails terminally instead of livelocking.

**Swap-vs-replay cost rule.** With a host swap tier (`swap_host_mb`),
`_handle_exhaustion` chooses per victim: swap out its exclusively held
pages when the round-trip bytes (`2 * pages * page_bytes`) are no more than
`swap_break_even_bytes_per_token` per token a replay would re-prefill
(policy `"cost"`), always (`"always"`) or never (`"never"`), within the
host budget. A swapped victim waits in the queue like a replay but
re-admits by swapping its pages back in: the block-table row is patched in
place, no token is recomputed. Swap failures (injected `SwapFault`, or a
full allocator at swap-in) retry with exponential backoff up to
`swap_max_retries`, then degrade to replay, and past the preemption bound
fail terminally. Swap-outs do not count against `max_preemptions`.

**Degradation rails.** `drain()` stops admission (never-admitted requests
end `cancelled`), finishes all in-flight work - swapped residents
included - and asserts balanced books and empty tiers. A non-finite max
logit in a sampling row (a poisoned model output) ends only that request,
with outcome `failed`. A raising `on_token` callback is counted
(`engine.stream.callback_errors`) and dropped. If nothing is active and an
eligible queued request still cannot be admitted, `step()` raises
`EngineStalledError` naming who is blocked on how many pages.

Sampling is greedy at temperature 0; elsewhere categorical over
logits / temperature restricted to the top-k tokens and then the nucleus.
Each stochastic row draws from its own generator seeded from
`(engine seed, rid, stream position)` - never from a global step state - so
the token sampled at a given position of a given request is the same no
matter which step, batch slot or replay produces it.

**Register state** (SSM and hybrid families): each admitted sequence
holds one register slot (`max_seqs + 1` slots, 0 the scratch slot of
padded rows) from admission to release, scrubbed with its pages; decode
passes the rows' slots as one more input of the captured step. The slots
never grow, so register-only models need no pages and have no implied
context window; their state is a running summary, so the prefix cache and
the swap tier refuse it and a preempted request replays.

The page pool is updated in place by the model's forward; the engine keeps
one reference to it (`self.kv.state`).

Telemetry: every counter lives in a `MetricsRegistry` whose snapshot carries
the reference's whole taxonomy (`serve.telemetry.schema`). A `Tracer`
records request lifecycles and each forward's wall time (ending in a device
synchronise); `QualityProbes` runs the probe variant of every K-th decode
forward. Both are off by default and change no token or logit.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch

from ...kernels import ops as kops
from ..telemetry.metrics import MetricsRegistry
from ..telemetry.quality import QualityProbes
from ..telemetry.schema import (REQUIRED_COUNTERS, REQUIRED_GAUGES,
                                REQUIRED_HISTOGRAMS)
from ..telemetry.trace import PID_REQUESTS, Tracer
from .adapter import ServableModel
from .faults import DispatchFault, FaultPlan, SwapFault
from .graphs import CapturedCall, pool_bytes
from .pages import PagedKVCache, pages_for
from .radix import RadixCache


class EngineStalledError(RuntimeError):
    """Admission can never proceed: nothing is active and an eligible
    queued request still does not fit. Raised with a per-request diagnosis
    instead of letting `run()` spin forever."""


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 64) - 1


def _row_seed(seed: int, rid: int, position: int) -> int:
    """Replay-stable sampling seed: a pure function of the engine seed and
    the `(rid, position)` pair (splitmix-style mixing of the three)."""
    x = seed & _MASK
    for v in (rid, position):
        x = (x ^ (v & _MASK)) * _MIX & _MASK
        x ^= x >> 31
    return x & ((1 << 63) - 1)


def _row_uniforms(seed: int, rids, positions) -> torch.Tensor:
    """One uniform in [0, 1) per batch row, each from its own generator
    seeded from `(seed, rid, position)`; float64 on the CPU."""
    out = torch.empty(len(rids), dtype=torch.float64)
    gen = torch.Generator(device="cpu")
    for i, (r, p) in enumerate(zip(rids, positions)):
        gen.manual_seed(_row_seed(seed, int(r), int(p)))
        out[i] = torch.rand((), generator=gen, dtype=torch.float64)
    return out


def _sample_tokens(uniforms: torch.Tensor, logits: torch.Tensor,
                   temps: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: torch.Tensor, *, filtered: bool = True):
    """Greedy rows where temp == 0; elsewhere categorical over logits/temp
    restricted to the top-k tokens (k == 0 disables) and then the nucleus -
    the smallest set whose probability mass reaches top_p (top_p >= 1
    disables). Row i draws by inverse CDF from `uniforms[i]`, so a row's
    token depends on its own uniform only. `filtered=False` (the scheduler
    knows host-side when every row has filtering off) skips the two
    full-vocabulary sorts. Nothing here reads the device on the host, so
    the sampler can be captured in a CUDA graph; a batch with no sampling
    row is the caller's to send to argmax (`_pick_tokens`)."""
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.where(temps > 0, temps,
                                  torch.ones_like(temps))[:, None]
    neg_inf = torch.full_like(scaled, -torch.inf)
    if filtered:
        desc = torch.sort(scaled, dim=-1, descending=True).values
        kth = torch.gather(desc, 1,
                           torch.clamp(top_ks - 1, 0, v - 1)[:, None].long())
        keep = (top_ks <= 0)[:, None] | (scaled >= kth)
        scaled = torch.where(keep, scaled, neg_inf)
        probs = torch.softmax(scaled, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(sp, dim=-1)
        # a sorted token enters the nucleus while the mass before it is < p
        keep_sorted = ((cum - sp) < top_ps[:, None]) \
            | (top_ps >= 1.0)[:, None]
        thresh = torch.where(keep_sorted, sp,
                             torch.full_like(sp, torch.inf)).amin(dim=-1)
        scaled = torch.where(probs >= thresh[:, None], scaled, neg_inf)
    probs = torch.softmax(scaled.to(torch.float64), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    u = uniforms.to(cdf.device)[:, None] * cdf[:, -1:]
    sampled = torch.searchsorted(cdf, u, right=True)[:, 0].clamp_(max=v - 1)
    return torch.where(temps > 0, sampled, greedy)


def _pick_tokens(lg: torch.Tensor, temps=None, top_ks=None, top_ps=None,
                 uniforms=None, *, samples: bool, filtered: bool):
    """The next token and the max logit of each row of `lg` [B, V] (f32)
    as one [2, B] float64 tensor on lg's device, so the host reads both in
    one transfer. `samples` (host-known: some row has temperature > 0)
    selects `_sample_tokens` over argmax. The per-row max logit is what the
    non-finite sentinel reads to flag poisoned rows without pulling the
    full logits off the device."""
    if samples:
        toks = _sample_tokens(uniforms, lg, temps, top_ks, top_ps,
                              filtered=filtered)
    else:
        toks = torch.argmax(lg, dim=-1)
    return torch.stack([toks.to(torch.float64),
                        lg.amax(dim=-1).to(torch.float64)])


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling: temperature 0 -> greedy argmax. `top_k` > 0
    restricts sampling to the k most likely tokens, `top_p` < 1 to the
    nucleus; `stop` is a tuple of token-id sequences that end generation
    early (the matched suffix is kept in `generated`)."""
    temperature: float = 0.0
    max_new: int = 8
    top_k: int = 0
    top_p: float = 1.0
    stop: tuple = ()


@dataclasses.dataclass
class EngineRequest:
    rid: int
    prompt: list[int]
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    deadline_s: float | None = None  # TTL from submit, step-boundary checked
    generated: list[int] = dataclasses.field(default_factory=list)
    # per generated token: float32 logits row (only when record_logits)
    step_logits: list[np.ndarray] = dataclasses.field(default_factory=list)
    stop_hit: bool = False     # a stop sequence ended generation early
    # --- terminal lifecycle outcomes (at most one is ever set) ---
    cancelled: bool = False    # cancel(rid) took it out
    expired: bool = False      # deadline / injected TTL fired
    failed: str | None = None  # terminal failure, e.g. preemption limit
    # --- engine-internal state ---
    n_cached: int = 0          # KV rows already written for this sequence
    n_streamed: int = 0        # generated tokens already sent to on_token
    next_token: int | None = None
    n_preempted: int = 0       # times this request lost its pages
    admit_seq: int = -1        # monotonic admission order (victim pick)
    not_before_step: int = 0   # replay backoff: earliest re-admission step
    swapped: bool = False      # pages parked in the host tier (queued)
    n_swapped: int = 0         # times this request swapped out
    swap_retries: int = 0      # failed swap-in attempts since swap-out
    t_submit: float | None = None   # perf_counter at submit
    t_admit: float | None = None    # perf_counter at admission

    @property
    def done(self) -> bool:
        return (self.stop_hit or self.cancelled or self.expired
                or self.failed is not None
                or len(self.generated) >= self.sampling.max_new)

    @property
    def outcome(self) -> str | None:
        """Why the request ended: "length" | "stop" | "cancelled" |
        "expired" | "failed", or None while still in flight."""
        if self.cancelled:
            return "cancelled"
        if self.expired:
            return "expired"
        if self.failed is not None:
            return "failed"
        if self.stop_hit:
            return "stop"
        if len(self.generated) >= self.sampling.max_new:
            return "length"
        return None


class ServeEngine:
    """Paged-KV continuous-batching engine over a `ServableModel`. The
    engine runs on the adapter's device (that of its parameters).

    `eager=True` dispatches each decode step directly, without the static
    buffers and graphs of `_fused`: the comparison the tests and
    `chip_smoke.py` make. No launcher flag sets it, as the reference has
    none."""

    def __init__(self, adapter: ServableModel, *, n_pages: int,
                 page_size: int = 16, max_seqs: int = 4,
                 prefill_chunk: int = 8, token_budget: int | None = None,
                 seed: int = 0, record_logits: bool = False,
                 admission: str = "optimistic",
                 headroom_pages: int | None = None,
                 max_preemptions: int = 3,
                 max_context: int | None = None,
                 deadline_s: float | None = None,
                 prefix_cache: bool = False,
                 prefix_cache_pages: int | None = None,
                 swap_host_mb: float | None = None,
                 swap_policy: str = "cost",
                 swap_max_retries: int = 3,
                 swap_break_even_bytes_per_token: float = 4096.0,
                 faults: FaultPlan | None = None,
                 tracer: Tracer | None = None,
                 quality_probes: QualityProbes | None = None,
                 eager: bool = False):
        if admission not in ("optimistic", "reserve"):
            raise ValueError(f"admission must be 'optimistic' or 'reserve', "
                             f"got {admission!r}")
        if swap_policy not in ("never", "cost", "always"):
            raise ValueError(f"swap_policy must be 'never', 'cost', or "
                             f"'always', got {swap_policy!r}")
        self.adapter = adapter
        self.spec = adapter.state_spec
        self.device = adapter.device
        self.max_seqs = max_seqs
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget or max(max_seqs, prefill_chunk)
        self.record_logits = record_logits
        self.admission = admission
        self.max_preemptions = max_preemptions
        self.default_deadline_s = deadline_s
        self.faults = faults
        self.seed = seed
        # one register slot per concurrent sequence (+ the scratch slot):
        # admission is bounded by max_seqs, so slots never run out before
        # sequence slots do
        n_slots = max_seqs + 1
        self.kv = PagedKVCache(adapter.init_state(n_pages, page_size,
                                                  n_slots),
                               n_pages, page_size, n_slots=n_slots)
        cap = self.kv.allocator.capacity
        # headroom watermark: pages optimistic admission keeps free for
        # decode growth of the running batch (waived for a replay or a
        # swapped request, whose requirement is already its real footprint)
        self.headroom_pages = min(max_seqs, cap // 4) \
            if headroom_pages is None else headroom_pages
        # context window: explicit, else the pool bound for kv specs
        # (register-only state never grows, so there is no implied bound)
        self.max_context = max_context if max_context is not None \
            else (cap * page_size if self.spec.kv else None)
        # prefix-sharing radix cache: kv-only specs (register/SSM state is
        # position-dependent - see StateSpec.prefix_shareable)
        if prefix_cache and not self.spec.prefix_shareable:
            raise ValueError(
                f"adapter {adapter.name!r} carries register state: SSM "
                "state is position-dependent, so the prefix cache cannot "
                "serve this spec")
        self.prefix_cache = RadixCache(self.kv, prefix_cache_pages) \
            if prefix_cache else None
        # host swap tier: a byte budget for parking preemption victims' KV
        # pages instead of recomputing them (kv-only specs - register state
        # is fixed-size slot-resident and never paged out)
        self.swap_policy = swap_policy if swap_host_mb else "never"
        self.swap_max_retries = swap_max_retries
        self.swap_break_even_bytes_per_token = swap_break_even_bytes_per_token
        if swap_host_mb and swap_policy != "never":
            if self.spec.register:
                raise ValueError(
                    f"adapter {adapter.name!r} carries register state: "
                    "fixed-size SSM slots are not paged, so the host swap "
                    "tier cannot serve this spec (recompute-by-replay "
                    "still covers it)")
            self.kv.attach_host_pool(swap_host_mb)
        self._draining = False
        self.queue: list[EngineRequest] = []
        self._callbacks: dict[int, Callable[[int, int], None]] = {}
        self.prefilling: list[EngineRequest] = []
        self.decoding: list[EngineRequest] = []
        self._committed: dict[int, int] = {}   # rid -> committed page count
        self._committed_total = 0              # == sum(_committed.values())
        self._terminal: list[EngineRequest] = []   # drained by step()
        self._step_index = 0                   # never reset (faults key on it)
        self._admit_seq = 0
        # the fused decode dispatches (`_fused`), by (phase,
        # kernels_enabled(), variant), and the graph memory pool they share
        self.eager = eager
        self._graphs: dict[tuple, CapturedCall] = {}
        self._graph_pool = None
        # telemetry: tracer and quality probes are opt-in and bit-path-
        # neutral
        self.metrics = MetricsRegistry()
        self.tracer = tracer
        self.quality_probes = quality_probes
        if quality_probes is not None:
            if not getattr(adapter, "supports_quality_probes", False):
                raise ValueError(
                    f"adapter {adapter.name!r} does not support quality "
                    "probes (integer path only)")
            quality_probes.bind(self.metrics)
        self._register_metrics()

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------

    @property
    def active(self) -> list[EngineRequest]:
        return self.prefilling + self.decoding

    def submit(self, req: EngineRequest,
               on_token: Callable[[int, int], None] | None = None):
        """Queue a request. `on_token(rid, token)`, when given, receives
        every generated token at the step boundary that produced it - after
        the step's device work and bookkeeping, so the callback can never
        disturb engine state mid-phase. Replays never re-deliver: a
        preempted request resumes streaming where it left off."""
        if self._draining:
            raise RuntimeError(
                "engine is draining: new requests are not accepted")
        if not req.prompt:
            raise ValueError("empty prompt")
        if req.sampling.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if req.sampling.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if not 0.0 < req.sampling.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if any(len(seq) == 0 for seq in req.sampling.stop):
            raise ValueError("stop sequences must be non-empty")
        if req.n_cached or req.generated or req.done:
            raise ValueError(f"request {req.rid} carries stale engine "
                             "state; submit a fresh EngineRequest")
        if any(req.rid == r.rid for r in self.queue + self.active):
            raise ValueError(f"rid {req.rid} already queued or active")
        total = len(req.prompt) + req.sampling.max_new
        if self.max_context is not None and total > self.max_context:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)} tokens) + "
                f"max_new ({req.sampling.max_new}) exceeds the model "
                f"context window ({self.max_context} tokens)")
        if self.spec.kv:
            worst = pages_for(total, self.kv.page_size)
            cap = self.kv.allocator.capacity
            if worst > cap:
                raise ValueError(
                    f"request {req.rid} needs {worst} pages; pool capacity "
                    f"is {cap}")
            if self.admission == "optimistic" \
                    and pages_for(len(req.prompt), self.kv.page_size) \
                    + self.headroom_pages > cap:
                raise ValueError(
                    f"request {req.rid}: prompt pages + headroom "
                    f"({self.headroom_pages}) exceed pool capacity {cap} - "
                    "it could never be admitted (shrink the prompt or the "
                    "headroom watermark)")
        if req.deadline_s is None:
            req.deadline_s = self.default_deadline_s
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        if on_token is not None:
            self._callbacks[req.rid] = on_token
        self.metrics.counter("engine.requests.submitted").inc()
        if self.tracer:
            self.tracer.begin("request", pid=PID_REQUESTS, tid=req.rid,
                              args={"prompt_tokens": len(req.prompt),
                                    "max_new": req.sampling.max_new})
            self.tracer.begin("queued", pid=PID_REQUESTS, tid=req.rid)

    def _stream(self, req: EngineRequest) -> list[int]:
        """The token stream prefill must cache: the prompt, plus - for a
        preempted request being replayed - every token already generated
        (all host-known)."""
        return req.prompt + req.generated

    def _pages_needed(self, req: EngineRequest) -> int:
        """KV pages admission requires for this request: the worst case
        under `"reserve"`, the prefill stream's pages under `"optimistic"`
        (growth is backed by preemption), and for a swapped-out request the
        device pages for exactly its host-resident entries; 0 for
        register-only models, whose state never grows."""
        if not self.spec.kv:
            return 0
        if req.swapped:
            return sum(1 for e in self.kv.tables[req.rid]
                       if not isinstance(e, int))
        if self.admission == "reserve":
            return pages_for(len(req.prompt) + req.sampling.max_new,
                             self.kv.page_size)
        return pages_for(len(self._stream(req)), self.kv.page_size)

    def _admit(self):
        cap = self.kv.allocator.capacity
        i = 0
        while i < len(self.queue) and len(self.active) < self.max_seqs:
            req = self.queue[i]
            if req.not_before_step > self._step_index:
                i += 1               # replay backoff: try later entries
                continue
            need = self._pages_needed(req)
            headroom = self.headroom_pages \
                if self.admission == "optimistic" \
                and not (req.n_preempted or req.swapped) else 0
            if self._committed_total + need + headroom > cap:
                self.metrics.counter("engine.admission.blocked").inc()
                return           # head-of-line blocks until pages free up
            if req.swapped:
                if not self._try_swap_in(req):
                    # retry scheduled (backoff), degraded to replay, or
                    # failed: queue[i] now skips on not_before_step or is
                    # another request
                    continue
                self.queue.remove(req)
                req.admit_seq = self._admit_seq
                self._admit_seq += 1
                # a mid-prefill victim resumes prefill at its preserved
                # n_cached; a decode victim rejoins the batched decode
                phase = "decode" if req.next_token is not None \
                    else "prefill"
                (self.decoding if phase == "decode"
                 else self.prefilling).append(req)
                self.metrics.counter("engine.requests.admitted").inc()
                if self.tracer:
                    self.tracer.end("queued", pid=PID_REQUESTS, tid=req.rid)
                    self.tracer.instant("swapped_in", pid=PID_REQUESTS,
                                        tid=req.rid)
                    self.tracer.begin(phase, pid=PID_REQUESTS, tid=req.rid)
                continue
            self.queue.pop(i)
            self.kv.open(req.rid)     # before committing: if this raises,
            self._committed[req.rid] = need   # no reservation leaks
            self._committed_total += need
            if self.prefix_cache is not None:
                self._attach_prefix(req)
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.prefilling.append(req)
            self.metrics.counter("engine.requests.admitted").inc()
            if req.t_admit is None:
                # client-visible queueing delay: time to *first* admission
                req.t_admit = time.perf_counter()
                self.metrics.histogram("engine.admission.wait_s").observe(
                    max(req.t_admit - req.t_submit, 0.0))
            if self.tracer:
                self.tracer.end("queued", pid=PID_REQUESTS, tid=req.rid)
                self.tracer.begin("prefill", pid=PID_REQUESTS, tid=req.rid)
                if self.spec.register:
                    self.tracer.instant(
                        "alloc_slot", pid=PID_REQUESTS, tid=req.rid,
                        args={"slot": self.kv.slots[req.rid]})

    def _alloc_pages(self, n: int) -> list[int]:
        """Allocate `n` pages, evicting cached prefixes under pressure -
        the tree gives pages back before any live sequence is preempted."""
        try:
            return self.kv.allocator.alloc(n)
        except MemoryError:
            if self.prefix_cache is None or not self.prefix_cache.evict(n):
                raise
            return self.kv.allocator.alloc(n)

    def _attach_prefix(self, req: EngineRequest):
        """Seed a just-admitted request's block table from the radix tree:
        incref the longest fully matched page run, and when the match
        extends into a page partially (or the last-token clamp cuts one
        short), copy that page (COW) so the request writes into its private
        copy. `n_cached` starts at the hit length, so chunked prefill
        begins at the divergence offset."""
        stream = self._stream(req)
        pages, cow = self.prefix_cache.match(stream)
        ps = self.kv.page_size
        # the final stream position is always recomputed: its logits seed
        # the next sampled token, and prefill is the phase that makes them
        hit = min(len(pages) * ps + (cow[1] if cow else 0), len(stream) - 1)
        m = self.metrics
        if hit <= 0:
            m.counter("engine.prefix.misses").inc()
            return
        n_full, extra = divmod(hit, ps)
        shared = pages[:n_full]
        src = (pages[n_full] if n_full < len(pages) else cow[0]) \
            if extra else None
        alloc = self.kv.allocator
        alloc.incref(shared)      # our references; also pins them against
        dst = None                # the eviction _alloc_pages may trigger
        if src is not None:
            alloc.incref([src])   # pin the COW source too
            try:
                dst = self._alloc_pages(1)[0]
            except MemoryError:
                # no room for a private copy: fall back to the full-page
                # hit (the deref never scrubs: the tree still holds src)
                self.kv.deref([src])
                hit, src = n_full * ps, None
                if hit == 0:
                    m.counter("engine.prefix.misses").inc()
                    return
        table = self.kv.tables[req.rid]
        table.extend(shared)
        if src is not None:
            self.kv.cow_copy(src, dst)
            self.kv.deref([src])          # unpin; our copy carries on
            table.append(dst)
            m.counter("engine.prefix.cow_copies").inc()
        req.n_cached = hit
        m.counter("engine.prefix.hits").inc()
        m.counter("engine.prefix.hit_tokens").inc(hit)
        if self.tracer:
            self.tracer.instant("prefix_hit", pid=PID_REQUESTS, tid=req.rid,
                                args={"tokens": hit, "cow": src is not None})

    def _release(self, req: EngineRequest, adopted: int = 0):
        """Return an admitted request's pages and its commitment. The
        first `adopted` table entries' references were consumed by the
        radix tree (see `_finish`) and are skipped."""
        self.kv.release(req.rid, adopted=adopted)
        self._committed_total -= self._committed.pop(req.rid)

    def _finish(self, req: EngineRequest):
        adopted = 0
        if self.prefix_cache is not None:
            # donate the finished stream's full pages to the tree: insert
            # consumes our reference on every page passed, so release
            # skips exactly that many table entries
            full = req.n_cached // self.kv.page_size
            if full:
                stream = self._stream(req)
                table = self.kv.tables[req.rid]
                self.prefix_cache.insert(stream[:full * self.kv.page_size],
                                         table[:full])
                adopted = full
        self._release(req, adopted=adopted)
        m = self.metrics
        m.counter("engine.requests.finished").inc()
        if req.stop_hit:
            m.counter("engine.requests.stop_hits").inc()
        if req.t_submit is not None:
            m.histogram("engine.request.e2e_s").observe(
                max(time.perf_counter() - req.t_submit, 0.0))
        if self.tracer:
            self.tracer.end("decode", pid=PID_REQUESTS, tid=req.rid)
            self.tracer.end("request", pid=PID_REQUESTS, tid=req.rid,
                            args={"generated": len(req.generated),
                                  "stop_hit": req.stop_hit})

    # ------------------------------------------------------------------
    # lifecycle: cancel / expire / preempt
    # ------------------------------------------------------------------

    def _phase_of(self, req: EngineRequest) -> str:
        if req in self.queue:
            return "queued"
        if req in self.prefilling:
            return "prefill"
        if req in self.decoding:
            return "decode"
        raise ValueError(f"rid {req.rid} is not queued or active")

    def _by_rid(self, rid: int) -> EngineRequest:
        for r in self.queue + self.active:
            if r.rid == rid:
                return r
        raise ValueError(f"rid {rid} is not queued or active")

    def _terminate(self, req: EngineRequest, outcome: str):
        """Take `req` out of whatever phase it is in: pages scrubbed and
        released (admitted requests), books rebalanced, the terminal flag
        set, and the request queued for return from the current/next
        `step()`."""
        phase = self._phase_of(req)
        if phase == "queued":
            self.queue.remove(req)
            if req.swapped:
                # a swapped-out request parked in the queue still holds
                # host slots and (possibly) retained shared device pages
                self._release(req)
                req.swapped = False
        else:
            (self.prefilling if phase == "prefill"
             else self.decoding).remove(req)
            self._release(req)
        if outcome == "cancelled":
            req.cancelled = True
        elif outcome == "expired":
            req.expired = True
        # "failed" requests carry their reason in req.failed already
        self.metrics.counter(f"engine.requests.{outcome}").inc()
        if self.tracer:
            self.tracer.end(phase, pid=PID_REQUESTS, tid=req.rid)
            self.tracer.end("request", pid=PID_REQUESTS, tid=req.rid,
                            args={"outcome": outcome,
                                  "generated": len(req.generated)})
        self._terminal.append(req)

    def cancel(self, rid: int) -> EngineRequest:
        """Cancel a queued or mid-flight request: its pages are scrubbed
        and returned, books stay balanced, and the request (marked
        `cancelled`) is also returned from the next `step()`/`run()`."""
        req = self._by_rid(rid)
        self._terminate(req, "cancelled")
        return req

    def _expire_deadlines(self):
        now = time.perf_counter()
        for req in self.queue + self.active:
            if req.deadline_s is not None and req.t_submit is not None \
                    and now - req.t_submit > req.deadline_s:
                self._terminate(req, "expired")

    def _apply_faults(self):
        if self.faults is None:
            return
        live = sorted(r.rid for r in self.queue + self.active)
        for rid in self.faults.cancels_due(self._step_index, live):
            self.cancel(rid)
        live = sorted(r.rid for r in self.queue + self.active)
        for rid in self.faults.expiries_due(self._step_index, live):
            self._terminate(self._by_rid(rid), "expired")

    def _maybe_dispatch_fault(self, phase: str):
        if self.faults is None:
            return
        kind = self.faults.take_dispatch_fault(self._step_index)
        if kind == "delay":
            self.metrics.counter("engine.dispatch.faults").inc()
            time.sleep(self.faults.dispatch_delay_s)
        elif kind == "fail":
            raise DispatchFault(
                f"injected dispatch failure at step {self._step_index} "
                f"({phase})")

    def _preempt(self, req: EngineRequest):
        """Victimize an active request: scrub + release its pages through
        the normal release path, then either re-queue it at the front as a
        replay (prefill of prompt + generated, with exponential step
        backoff) or - past `max_preemptions` - fail it terminally."""
        phase = self._phase_of(req)
        (self.prefilling if phase == "prefill"
         else self.decoding).remove(req)
        self.metrics.counter("engine.preemptions").inc()
        # replayed_prefill_tokens is charged by the replay's prefill for
        # what it actually recomputes (a prefix-tree hit returns the rest)
        self._release(req)
        req.n_preempted += 1
        req.n_cached = 0
        req.next_token = None
        if self.tracer:
            self.tracer.end(phase, pid=PID_REQUESTS, tid=req.rid)
            self.tracer.instant("preempted", pid=PID_REQUESTS, tid=req.rid,
                                args={"n_preempted": req.n_preempted})
        if req.n_preempted > self.max_preemptions:
            req.failed = (f"preempted {req.n_preempted} times "
                          f"(max_preemptions={self.max_preemptions})")
            self.metrics.counter("engine.requests.failed").inc()
            if self.tracer:
                self.tracer.end("request", pid=PID_REQUESTS, tid=req.rid,
                                args={"outcome": "failed",
                                      "generated": len(req.generated)})
            self._terminal.append(req)
        else:
            req.not_before_step = \
                self._step_index + 2 ** (req.n_preempted - 1)
            if self.tracer:
                self.tracer.begin("queued", pid=PID_REQUESTS, tid=req.rid)
            self.queue.insert(0, req)

    def _should_swap(self, victim: EngineRequest) -> bool:
        """The swap-vs-replay cost rule: park the victim's exclusive pages
        in the host tier when a tier exists with room for them, there is
        anything exclusive to move, and the policy favours it - round-trip
        bytes against the tokens a replay would re-prefill, scaled by the
        break-even traffic per recomputed token."""
        host = self.kv.host_pool
        if host is None or self.swap_policy == "never":
            return False
        pages = self.kv.swap_eligible_pages(victim.rid)
        if not pages or len(pages) > host.n_free:
            return False
        if self.swap_policy == "always":
            return True
        move_bytes = 2 * len(pages) * self.kv.page_bytes
        replay_tokens = len(self._stream(victim))
        return move_bytes \
            <= replay_tokens * self.swap_break_even_bytes_per_token

    def _swap_out(self, req: EngineRequest):
        """Swap the victim's exclusive pages to the host tier instead of
        scrubbing them; the victim re-queues at the front, and re-admits
        by a swap-in (no recomputed token). Raises `SwapFault` (injected)
        before any mutation, so `_handle_exhaustion` falls back to the
        replay arm."""
        if self.faults is not None \
                and self.faults.take_swap_fault(self._step_index):
            raise SwapFault(
                f"injected swap-out failure at step {self._step_index}")
        phase = self._phase_of(req)
        n, nbytes = self.kv.swap_out(req.rid)
        (self.prefilling if phase == "prefill"
         else self.decoding).remove(req)
        m = self.metrics
        m.counter("engine.swap.out").inc()
        m.counter("engine.swap.bytes").inc(nbytes)
        # commitment shrinks to what stays device-resident (the retained
        # shared pages); the host-resident entries re-commit at swap-in
        held = sum(1 for e in self.kv.tables[req.rid] if isinstance(e, int))
        cur = self._committed[req.rid]
        self._committed[req.rid] = held
        self._committed_total += held - cur
        req.swapped = True
        req.n_swapped += 1
        req.swap_retries = 0
        req.not_before_step = \
            self._step_index + 2 ** min(req.n_swapped - 1, 5)
        if self.tracer:
            self.tracer.end(phase, pid=PID_REQUESTS, tid=req.rid)
            self.tracer.instant("swapped_out", pid=PID_REQUESTS,
                                tid=req.rid,
                                args={"pages": n, "bytes": nbytes})
            self.tracer.begin("queued", pid=PID_REQUESTS, tid=req.rid)
        self.queue.insert(0, req)

    def _try_swap_in(self, req: EngineRequest) -> bool:
        """Re-admission transfer of a swapped-out request: allocate device
        pages (evicting cached prefixes under pressure), copy the host
        pages back, patch the block table in place. On an injected
        `SwapFault` or a genuine allocation failure the attempt retries
        with exponential backoff up to `swap_max_retries`, then degrades to
        recompute-by-replay."""
        m = self.metrics
        try:
            if self.faults is not None \
                    and self.faults.take_swap_fault(self._step_index):
                raise SwapFault(
                    f"injected swap-in failure at step {self._step_index}")
            n, nbytes = self.kv.swap_in(req.rid, self._alloc_pages)
        except (SwapFault, MemoryError) as e:
            req.swap_retries += 1
            if req.swap_retries > self.swap_max_retries:
                self._fallback_to_replay(req, why=str(e))
            else:
                m.counter("engine.swap.retries").inc()
                req.not_before_step = \
                    self._step_index + 2 ** (req.swap_retries - 1)
            return False
        m.counter("engine.swap.in").inc()
        m.counter("engine.swap.bytes").inc(nbytes)
        held = len(self.kv.tables[req.rid])
        cur = self._committed[req.rid]
        self._committed[req.rid] = held
        self._committed_total += held - cur
        req.swapped = False
        req.swap_retries = 0
        return True

    def _fallback_to_replay(self, req: EngineRequest, *, why: str):
        """Degrade a swapped-out queued request to recompute-by-replay:
        drop its host copy and residual device references, reset the cached
        state, and let the replay admission path re-prefill it - bounded by
        `max_preemptions` like any preemption."""
        m = self.metrics
        m.counter("engine.swap.fallbacks").inc()
        self._release(req)
        req.swapped = False
        req.swap_retries = 0
        req.n_cached = 0
        req.next_token = None
        req.n_preempted += 1
        m.counter("engine.preemptions").inc()
        if self.tracer:
            self.tracer.instant("swap_fallback", pid=PID_REQUESTS,
                                tid=req.rid, args={"why": why})
        if req.n_preempted > self.max_preemptions:
            req.failed = (f"swap-in abandoned ({why}); preempted "
                          f"{req.n_preempted} times "
                          f"(max_preemptions={self.max_preemptions})")
            self._terminate(req, "failed")
        else:
            req.not_before_step = self._step_index + 1

    def _reclaim(self):
        """Page pressure ladder: cached prefixes are speculative capacity,
        live sequences real work - evict from the radix tree first and
        preempt a victim only when the tree has nothing unpinned to give."""
        if self.prefix_cache is not None \
                and self.prefix_cache.evict(max(1, self.max_seqs)):
            return
        self._handle_exhaustion()

    def _handle_exhaustion(self):
        """The pool exhausted mid-growth: pick the victim - fewest
        generated tokens, latest-admitted breaking ties - among active
        requests that hold pages, then swap its exclusive pages out (when
        the cost rule says so) or preempt it for replay. An injected swap
        fault falls back to the replay arm for the same victim."""
        holders = [r for r in self.active if self.kv.tables.get(r.rid)]
        if not holders:
            # every held page belongs to swapped-out queue entries
            # (retained shared pages) - or the books really are broken:
            # degrade one swapped request to a full replay, freeing its
            # residual references, and let the grower retry
            for r in self.queue:
                if r.swapped:
                    self._fallback_to_replay(
                        r, why="page pool exhausted with no active holder")
                    return
            alloc = self.kv.allocator
            raise EngineStalledError(
                "page pool exhausted but no active request holds pages - "
                f"allocator books are broken (capacity {alloc.capacity}, "
                f"free {alloc.n_free}, committed {self._committed_total})")
        victim = min(holders,
                     key=lambda r: (len(r.generated), -r.admit_seq))
        if self._should_swap(victim):
            try:
                self._swap_out(victim)
                return
            except SwapFault:
                self.metrics.counter("engine.swap.fallbacks").inc()
        self._preempt(victim)

    def _check_stalled(self):
        """Raise a diagnosable error when head-of-line demand can never be
        satisfied: nothing is active (so no pages will ever free up) and
        an admission-eligible request is still blocked."""
        if self.active or not self.queue:
            return
        eligible = [r for r in self.queue
                    if r.not_before_step <= self._step_index]
        if not eligible:
            return        # every entry is in backoff; steps advance
        alloc = self.kv.allocator
        who = "; ".join(
            f"rid {r.rid} needs {self._pages_needed(r)} pages"
            for r in eligible)
        raise EngineStalledError(
            "scheduler stalled: no active sequences and admission cannot "
            f"proceed (capacity {alloc.capacity}, free {alloc.n_free}, "
            f"committed {self._committed_total}, headroom "
            f"{self.headroom_pages if self.admission == 'optimistic' else 0}"
            f"); blocked: {who}")

    def check_books(self):
        """Assert the accounting invariants the chaos tests lean on: the
        running committed total matches the per-rid map; the committed
        rids are the active and the swapped ones, each with a table; an
        active table never outgrows its commitment, a swapped rid's
        commitment is its device-resident entries; no page is inside a
        transfer; host slots in use equal the host-resident entries; each
        page's refcount equals its multiplicity over the tables and the
        radix tree; free + in-use pages cover the capacity exactly.
        Waits for the swap tier's copies in flight first."""
        self.kv.settle()
        assert self._committed_total == sum(self._committed.values()), \
            (self._committed_total, self._committed)
        active = {r.rid for r in self.active}
        swapped = {r.rid for r in self.queue if r.swapped}
        assert not (active & swapped), (active, swapped)
        assert set(self._committed) == active | swapped \
            == set(self.kv.tables), \
            (set(self._committed), active, swapped, set(self.kv.tables))
        for rid in active:
            assert len(self.kv.tables[rid]) <= self._committed[rid], \
                (rid, self.kv.tables[rid], self._committed[rid])
        for rid in swapped:
            assert self._committed[rid] == sum(
                1 for e in self.kv.tables[rid] if isinstance(e, int))
        assert not self.kv._inflight, self.kv._inflight
        host_refs = [e.slot for t in self.kv.tables.values()
                     for e in t if not isinstance(e, int)]
        hp = self.kv.host_pool
        if hp is not None:
            assert hp.in_use == len(host_refs) == len(set(host_refs)), \
                (hp.in_use, host_refs)
        else:
            assert not host_refs, host_refs
        alloc = self.kv.allocator
        counts: dict[int, int] = {}
        for t in self.kv.tables.values():
            for p in t:
                if isinstance(p, int):
                    counts[p] = counts.get(p, 0) + 1
        if self.prefix_cache is not None:
            tree_pages = self.prefix_cache.held_pages()
            assert len(tree_pages) == self.prefix_cache.n_pages, \
                (len(tree_pages), self.prefix_cache.n_pages)
            for p in tree_pages:
                counts[p] = counts.get(p, 0) + 1
        assert alloc.in_use == len(counts), (alloc.in_use, len(counts))
        for p, c in counts.items():
            assert alloc.refcount(p) == c, (p, alloc.refcount(p), c)
        assert alloc.n_free + alloc.in_use == alloc.capacity
        regs = self.kv.registers
        if regs is not None:
            assert regs.in_use == len(self.kv.slots), \
                (regs.in_use, self.kv.slots)
            assert set(self.kv.slots) == set(self.kv.tables), \
                (self.kv.slots, set(self.kv.tables))
            assert len(set(self.kv.slots.values())) == len(self.kv.slots), \
                self.kv.slots

    def _ensure(self, rid: int, n_tokens: int):
        """`kv.ensure` plus the growth-commit update, the fault-injection
        hook, and an instant trace event when the growth allocated pages.
        Raises `MemoryError` when the pool (really, or by injection) has
        no room; under `"reserve"` that never happens."""
        table = self.kv.tables[rid]
        need = pages_for(n_tokens, self.kv.page_size) - len(table)
        if need > 0 and self.faults is not None \
                and any(self.kv.tables.get(r.rid) for r in self.active) \
                and self.faults.take_exhaustion(self._step_index):
            # only inject once a victim exists - a real allocator can't
            # exhaust while zero pages are held
            raise MemoryError(
                f"injected page exhaustion at step {self._step_index}")
        before = self.kv.allocator.n_free
        self.kv.ensure(rid, n_tokens)
        got = before - self.kv.allocator.n_free
        if got and self.tracer:
            self.tracer.instant("alloc_pages", pid=PID_REQUESTS, tid=rid,
                                args={"pages": got})
        # commitment follows real growth (a no-op under "reserve", whose
        # worst-case commitment always covers the table)
        held = len(table)
        cur = self._committed[rid]
        if held > cur:
            self._committed[rid] = held
            self._committed_total += held - cur

    # -- counter views (the registry owns the numbers) ------------------

    @property
    def n_steps(self) -> int:
        return self.metrics.counter("engine.steps").value

    @property
    def n_prefill_tokens(self) -> int:
        return self.metrics.counter("engine.prefill_tokens").value

    @property
    def n_decode_tokens(self) -> int:
        return self.metrics.counter("engine.decode_tokens").value

    @property
    def pages_walked(self) -> int:
        return self.metrics.counter("engine.pages_walked").value

    @property
    def pages_walked_dense(self) -> int:
        return self.metrics.counter("engine.pages_walked_dense").value

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    @staticmethod
    def _check_stop(req: EngineRequest):
        for seq in req.sampling.stop:
            n = len(seq)
            if len(req.generated) >= n and req.generated[-n:] == list(seq):
                req.stop_hit = True
                return

    @staticmethod
    def _wants_filtering(batch) -> bool:
        return any(r.sampling.top_k > 0 or r.sampling.top_p < 1.0
                   for r in batch)

    def _grow_decode(self):
        """Grow every decoding sequence's table by one position, reclaiming
        (tree eviction, then a victim swapped out or preempted) until the
        growth fits; `ensure` is idempotent, so the retry loop re-runs
        cheaply. A victim may be a member of the batch being grown.
        Register-only state never grows."""
        if not self.spec.kv:
            return
        while True:
            try:
                for req in list(self.decoding):
                    self._ensure(req.rid, req.n_cached + 1)
                return
            except MemoryError:
                self._reclaim()

    def _sampling_operands(self, batch, rids, positions) -> dict:
        """The sampler's per-row operands as host tensors; rows past
        `len(batch)` are padding (temperature 0: greedy)."""
        pad = len(rids) - len(batch)
        return {
            "temps": torch.tensor([r.sampling.temperature for r in batch]
                                  + [0.0] * pad, dtype=torch.float32),
            "top_ks": torch.tensor([r.sampling.top_k for r in batch]
                                   + [0] * pad, dtype=torch.int64),
            "top_ps": torch.tensor([r.sampling.top_p for r in batch]
                                   + [1.0] * pad, dtype=torch.float32),
            "uniforms": _row_uniforms(self.seed, rids, positions)}

    def _sample(self, lg: torch.Tensor, batch, rids, positions):
        """Sample one token per row of `lg` [B, V] (f32) and return
        (tokens, max logit per row) on the host in ONE transfer. Rows past
        `len(batch)` are padding and sample greedily."""
        samples = any(r.sampling.temperature > 0 for r in batch)
        ops = {}
        if samples:
            ops = {k: v.to(lg.device) for k, v in
                   self._sampling_operands(batch, rids, positions).items()}
        picked = _pick_tokens(lg, **ops, samples=samples,
                              filtered=self._wants_filtering(batch))
        both = picked.cpu().numpy()
        return both[0].astype(np.int64), both[1]

    def _fused(self, name: str, impl, variant, example: dict) -> CapturedCall:
        """One fused device dispatch per phase and variant - the port's
        counterpart of the reference's jit-compiled `_fused`, keyed like it
        by (phase, kernels_enabled(), variant). The variant holds every
        choice a graph must fix on the host. On a CUDA device with the
        kernels enabled the dispatch is captured once and replayed
        (`graphs.CapturedCall`, every variant in one memory pool);
        elsewhere, and under `use_kernels(False)` (whose plain versions
        read the device on the host), it runs directly on the same static
        buffers. `example` gives the inputs' shapes and dtypes."""
        enabled = kops.kernels_enabled()
        key = (name, enabled, variant)
        call = self._graphs.get(key)
        if call is None:
            pool = None
            if enabled and self.device.type == "cuda":
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                pool = self._graph_pool
            call = self._graphs[key] = CapturedCall(impl, example,
                                                    self.device, pool=pool)
        return call

    def graph_stats(self) -> dict:
        """The captured dispatches: how many graphs, the seconds their
        captures took, and the device bytes of their shared memory pool."""
        calls = [c for c in self._graphs.values() if c.graph is not None]
        return {"graphs": len(calls),
                "capture_s": sum(c.capture_s for c in calls),
                "pool_bytes": (pool_bytes(self._graph_pool)
                               if self._graph_pool is not None else 0)}

    def _decode_impl(self, tokens, fill, lens, bt=None, reg=None, temps=None,
                     top_ks=None, top_ps=None, uniforms=None, *,
                     samples: bool, filtered: bool, probe: bool):
        """One decode step on the device - what `_fused` captures (the
        reference's `_decode_impl`). The forward writes each new KV row into
        its page, in place, and attends by walking `bt`; `reg` is each
        row's register slot (scratch for padded rows) for models whose spec
        carries fixed-size state, gathered and written back in place;
        `lens` are the true per-slot context lengths (0 for padded rows),
        which end the kernel's walk at each sequence's live pages and are
        each sampled token's stream position. Returns (logits [B, V] f32,
        tokens and max logits [2, B] f64, the per-layer probe stats or
        None)."""
        args = (self.adapter.params, tokens, self.kv.state, fill, bt, lens,
                reg)
        if probe:
            logits, _, stats = self.adapter.forward_chunk(*args, probe=True)
        else:
            (logits, _), stats = self.adapter.forward_chunk(*args), None
        lg = logits[:, 0].to(torch.float32)
        return lg, _pick_tokens(lg, temps, top_ks, top_ps, uniforms,
                                samples=samples, filtered=filtered), stats

    def _decode_once(self) -> list[EngineRequest]:
        batch = self.decoding
        b = self.max_seqs
        m = self.metrics
        pad = b - len(batch)
        rids = [r.rid for r in batch] + [None] * pad
        new_lens = [r.n_cached + 1 for r in batch]
        inputs = {
            "tokens": torch.tensor([[r.next_token] for r in batch]
                                   + [[0]] * pad, dtype=torch.int64),
            "fill": torch.tensor([r.n_cached for r in batch] + [0] * pad,
                                 dtype=torch.int32),
            "lens": torch.tensor(new_lens + [0] * pad, dtype=torch.int32),
        }
        n_cols = 0
        if self.spec.kv:
            n_cols = _next_pow2(max(
                pages_for(n, self.kv.page_size) for n in new_lens))
            m.counter("engine.pages_walked").inc(
                sum(pages_for(n, self.kv.page_size) for n in new_lens))
            m.counter("engine.pages_walked_dense").inc(b * n_cols)
            inputs["bt"] = self.kv.block_table_array(rids, n_cols)
        if self.spec.register:
            inputs["reg"] = self.kv.register_index_array(rids)
        samples = any(r.sampling.temperature > 0 for r in batch)
        filtered = samples and self._wants_filtering(batch)
        if samples:
            inputs.update(self._sampling_operands(
                batch, [r.rid for r in batch] + [0] * pad,
                new_lens + [0] * pad))
        probe = (self.quality_probes is not None
                 and self.quality_probes.should_probe())
        m.histogram("engine.decode.batch_occupancy").observe(
            len(batch) / self.max_seqs)
        impl = functools.partial(self._decode_impl, samples=samples,
                                 filtered=filtered, probe=probe)
        tr = self.tracer
        ts0 = tr.ts() if tr else 0.0
        if self.eager:
            lg, picked, stats = impl(
                **{k: v.to(self.device) for k, v in inputs.items()})
        else:
            lg, picked, stats = self._fused(
                "decode", impl, (n_cols, probe, samples, filtered),
                inputs)(**inputs)
        if tr:
            self._sync()
            tr.complete("dispatch.decode", ts0, tr.ts() - ts0,
                        args={"rows": len(batch), "probe": probe})
        if stats is not None:
            self.quality_probes.record(stats)
        picked = picked.cpu().numpy()
        toks, mx = picked[0].astype(np.int64), picked[1]
        finite = np.isfinite(mx)
        finished = []
        for i, req in enumerate(list(batch)):
            if not finite[i]:
                # poisoned model output (NaN/Inf logits): terminate only
                # this row - its sampled token is garbage and must not
                # enter the stream; other rows are independent
                req.failed = (f"non-finite logits at stream position "
                              f"{req.n_cached} (poisoned model output)")
                m.counter("engine.requests.poisoned").inc()
                self._terminate(req, "failed")   # returned via _terminal
                continue
            req.n_cached += 1
            req.generated.append(int(toks[i]))
            req.next_token = int(toks[i])
            if self.record_logits:
                req.step_logits.append(lg[i].cpu().numpy())
            m.counter("engine.decode_tokens").inc()
            m.counter("engine.generated_tokens").inc()
            self._check_stop(req)
            if req.done:
                self.decoding.remove(req)
                self._finish(req)
                finished.append(req)
        return finished

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------

    def _prefill_once(self, budget: int) -> tuple[int, list[EngineRequest]]:
        """Advance the head-of-line prefill by up to `budget` tokens of its
        stream (the prompt, plus the tokens already generated when
        replaying a preempted request); returns (tokens consumed, requests
        finished).

        Padded tail rows are computed too (their queries may attend the
        garbage keys the same forward wrote for earlier padding tokens, so
        their outputs are meaningless and discarded); their in-page writes
        land on the scratch page or on not-yet-valid slots that are
        rewritten before the causal mask ever exposes them."""
        req = self.prefilling[0]
        stream = self._stream(req)
        start = req.n_cached
        m = self.metrics
        dev = self.device
        real = min(self.prefill_chunk, budget, len(stream) - start)
        padded = _next_pow2(real)
        bt = None
        if self.spec.kv:
            while True:
                try:
                    self._ensure(req.rid, start + real)
                    break
                except MemoryError:
                    self._reclaim()
                    if req not in self.prefilling:
                        return 0, []    # the head itself was preempted
            n_cols = _next_pow2(pages_for(start + padded, self.kv.page_size))
            bt = self.kv.block_table_array([req.rid], n_cols)
            m.counter("engine.pages_walked").inc(
                pages_for(start + real, self.kv.page_size))
            m.counter("engine.pages_walked_dense").inc(n_cols)
        reg = self.kv.register_index_array([req.rid]) \
            if self.spec.register else None
        self._maybe_dispatch_fault("prefill")

        # every device-side shape depends only on (padded, n_cols), both
        # powers of two, so the kernels see a bounded set of shapes
        chunk = stream[start:start + real] + [0] * (padded - real)
        tokens = torch.tensor([chunk], dtype=torch.int64, device=dev)
        # the true cached length after this chunk: trims the kernel's walk
        # to the live pages, keeps the padded tail out of register (SSM)
        # state - whose update is a recurrence, not a masked read - and is
        # the sampled token's stream position
        lens = torch.tensor([start + real], dtype=torch.int32, device=dev)
        tr = self.tracer
        ts0 = tr.ts() if tr else 0.0
        logits, self.kv.state = self.adapter.forward_chunk(
            self.adapter.params, tokens, self.kv.state, start, bt, lens, reg)
        if tr:
            self._sync()
            tr.complete("dispatch.prefill", ts0, tr.ts() - ts0,
                        args={"rid": req.rid, "tokens": real,
                              "padded": padded})
        lg = logits[:, real - 1].to(torch.float32)
        # for a replay, position start + real is the one the undisturbed
        # decode sampled at, so the continuation draws the same uniform
        toks, mx = self._sample(lg, [req], [req.rid], [start + real])
        if not np.isfinite(mx[0]):
            # poisoned model output mid-prefill: the request cannot
            # continue - terminate it alone (the single-sequence dispatch
            # touched no other state)
            req.failed = (f"non-finite logits in prefill at stream "
                          f"position {start + real - 1} "
                          f"(poisoned model output)")
            m.counter("engine.requests.poisoned").inc()
            self._terminate(req, "failed")
            return real, []

        req.n_cached = start + real
        m.counter("engine.prefill_tokens").inc(real)
        if req.n_preempted > 0:
            # replay cost = rows actually recomputed (a prefix-tree hit at
            # re-admission already skipped the resident ones)
            m.counter("engine.replayed_prefill_tokens").inc(real)
        m.histogram("engine.prefill.chunk_tokens").observe(real)
        finished = []
        if req.n_cached == len(stream):
            # stream fully cached: the call already sampled the next token
            # from the last real position's logits
            self.prefilling.remove(req)
            req.generated.append(int(toks[0]))
            req.next_token = int(toks[0])
            if self.record_logits:
                req.step_logits.append(lg[0].cpu().numpy())
            m.counter("engine.generated_tokens").inc()
            if tr:
                tr.end("prefill", pid=PID_REQUESTS, tid=req.rid)
                tr.begin("decode", pid=PID_REQUESTS, tid=req.rid)
            self._check_stop(req)
            if req.done:
                self._finish(req)
                finished.append(req)
            else:
                self.decoding.append(req)
        return real, finished

    def _sync(self):
        """Wait for the device's queued work: a traced dispatch's wall time
        then covers its device time."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # driver
    # ------------------------------------------------------------------

    def step(self) -> list[EngineRequest]:
        """One engine iteration; returns every request that reached a
        terminal state during it (completed, cancelled, expired or failed -
        check `req.outcome`)."""
        m = self.metrics
        t0 = time.perf_counter()
        gen0 = m.counter("engine.generated_tokens").value
        self._apply_faults()
        self._expire_deadlines()
        self._admit()
        self._check_stalled()
        finished = []
        budget = self.token_budget
        spent = 0
        if self.decoding:
            try:
                self._maybe_dispatch_fault("decode")
                self._grow_decode()
                # growth may have preempted or swapped out a member of the
                # batch: the decode reads the batch after it
                if self.decoding:
                    budget -= len(self.decoding)
                    spent += len(self.decoding)
                    finished.extend(self._decode_once())
            except DispatchFault:
                m.counter("engine.dispatch.faults").inc()
        # `guard` bounds the zero-progress retries a preempted prefill head
        # can cause within one step (each retry strictly shrinks the active
        # set, so this terminates regardless)
        guard = len(self.prefilling) + 1
        while budget > 0 and self.prefilling and guard > 0:
            try:
                used, fin = self._prefill_once(budget)
            except DispatchFault:
                m.counter("engine.dispatch.faults").inc()
                break
            budget -= used
            spent += used
            finished.extend(fin)
            if used == 0:
                guard -= 1
        self._step_index += 1
        m.counter("engine.steps").inc()
        # the transfer of the sampled tokens already forced the device to
        # finish, so the wall time is real
        wall = time.perf_counter() - t0
        m.histogram("engine.step.wall_s").observe(wall)
        m.histogram("engine.step.budget_utilization").observe(
            spent / self.token_budget)
        lat = m.histogram("engine.decode.token_latency_s")
        for _ in range(m.counter("engine.generated_tokens").value - gen0):
            lat.observe(wall)
        self._update_gauges()
        finished.extend(self._terminal)
        self._terminal.clear()
        self._flush_streams(finished)
        return finished

    def _flush_streams(self, finished: list[EngineRequest]):
        """Step-boundary streaming: deliver every not-yet-streamed
        generated token to its request's `on_token` callback, after all
        device work and bookkeeping of the step. Terminal requests'
        callbacks are dropped after their final flush. A raising callback
        is counted (`engine.stream.callback_errors`) and dropped, so one
        broken consumer never blocks delivery to the other streams."""
        if not self._callbacks:
            return
        for req in self.active + finished:
            cb = self._callbacks.get(req.rid)
            if cb is None:
                continue
            while req.n_streamed < len(req.generated):
                tok = req.generated[req.n_streamed]
                req.n_streamed += 1
                try:
                    cb(req.rid, tok)
                except Exception:
                    self.metrics.counter(
                        "engine.stream.callback_errors").inc()
                    self._callbacks.pop(req.rid, None)
                    break
        for req in finished:
            self._callbacks.pop(req.rid, None)

    def run(self) -> list[EngineRequest]:
        done = []
        while self.queue or self.active:
            done.extend(self.step())
        done.extend(self._terminal)   # cancels issued between steps
        self._terminal.clear()
        self._flush_streams(done)
        return done

    def drain(self) -> list[EngineRequest]:
        """Graceful shutdown: stop admitting - queued requests that were
        never admitted end `cancelled` - finish every piece of in-flight
        work (active sequences, parked replays, swapped-out residents),
        clear the prefix cache, then assert balanced books and no
        non-scratch page on either tier. Returns the requests that reached
        a terminal state during the drain. The engine stays draining:
        further `submit()` calls are refused."""
        self._draining = True
        for req in list(self.queue):
            if req.t_admit is None:
                # never admitted - no partial work to honour
                self.cancel(req.rid)
        done = []
        while self.queue or self.active:
            done.extend(self.step())
        done.extend(self._terminal)
        self._terminal.clear()
        self._flush_streams(done)
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self.check_books()
        alloc = self.kv.allocator
        assert alloc.in_use == 0 and alloc.n_free == alloc.capacity, \
            f"device pages leaked: {alloc.in_use} still in use"
        assert not self.kv.tables and not self.kv.slots, \
            (self.kv.tables, self.kv.slots)
        assert not self._committed and self._committed_total == 0, \
            (self._committed, self._committed_total)
        regs = self.kv.registers
        assert regs is None or regs.in_use == 0, \
            f"register slots leaked: {regs.in_use} still in use"
        hp = self.kv.host_pool
        assert hp is None or hp.in_use == 0, \
            f"host tier leaked: {hp.in_use} slots still in use"
        return done

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def _register_metrics(self):
        """Pre-create every name of the taxonomy (`serve.telemetry.schema`)
        so a snapshot is schema-complete even before any traffic."""
        m = self.metrics
        for name in REQUIRED_COUNTERS:
            m.counter(name)
        for name in REQUIRED_GAUGES:
            m.gauge(name)
        for name in REQUIRED_HISTOGRAMS:
            m.histogram(name)
        self._update_gauges()

    def _update_gauges(self):
        """Refresh the level gauges from the live bookkeeping."""
        m = self.metrics
        alloc = self.kv.allocator
        m.gauge("engine.pages.capacity").set(alloc.capacity)
        m.gauge("engine.pages.in_use").set(alloc.in_use)
        m.gauge("engine.pages.peak_in_use").set(alloc.peak_in_use)
        m.gauge("engine.pages.utilization").set(
            alloc.in_use / max(alloc.capacity, 1))
        m.gauge("engine.pages.utilization_peak").set(
            alloc.peak_in_use / max(alloc.capacity, 1))
        m.gauge("engine.pages.reserved").set(self._committed_total)
        m.gauge("engine.pages.scrubbed").set(self.kv.pages_scrubbed)
        m.gauge("engine.queue.depth").set(len(self.queue))
        m.gauge("engine.batch.decoding").set(len(self.decoding))
        m.gauge("engine.batch.prefilling").set(len(self.prefilling))
        m.gauge("engine.pages.shared").set(alloc.n_shared)
        tree = self.prefix_cache
        m.gauge("engine.prefix.tree_pages").set(
            tree.n_pages if tree is not None else 0)
        m.gauge("engine.prefix.tree_nodes").set(
            tree.n_nodes if tree is not None else 0)
        if tree is not None:
            # the tree counts its own insert/evict traffic; mirror it as
            # monotonic counters
            for name, n in (("engine.prefix.inserted_pages",
                             tree.inserted_pages),
                            ("engine.prefix.evicted_pages",
                             tree.evicted_pages)):
                c = m.counter(name)
                if n > c.value:
                    c.value = n
        # host-tier occupancy: always set (zeros without a pool), so the
        # snapshot's shape does not depend on the policy
        hp = self.kv.host_pool
        pb = self.kv.page_bytes
        m.gauge("engine.swap.host_pages").set(hp.in_use if hp else 0)
        m.gauge("engine.swap.host_pages_capacity").set(
            hp.capacity if hp else 0)
        m.gauge("engine.swap.host_bytes").set(hp.in_use * pb if hp else 0)
        m.gauge("engine.swap.host_budget_bytes").set(
            hp.capacity * pb if hp else 0)
        regs = self.kv.registers
        if regs is not None:
            m.gauge("engine.register_slots.capacity").set(regs.capacity)
            m.gauge("engine.register_slots.in_use").set(regs.in_use)
            m.gauge("engine.register_slots.peak_in_use").set(
                regs.peak_in_use)
            m.gauge("engine.register_slots.scrubbed").set(
                self.kv.slots_scrubbed)

    def metrics_snapshot(self) -> dict:
        """Schema-versioned registry export (the shape
        `serve.telemetry.schema.validate_snapshot` checks): refresh the
        level gauges, mirror the kernel layer's per-entry-point dispatch
        tallies as `kernels.dispatch.<entry>.<kernels|ref>`, and
        snapshot."""
        self._update_gauges()
        for (entry, path), n in kops.dispatch_counts().items():
            c = self.metrics.counter(f"kernels.dispatch.{entry}.{path}")
            if n > c.value:
                c.value = n   # mirror of an external monotonic count
        return self.metrics.snapshot()

    def reset_metrics(self):
        """Start a fresh measurement window: zero the registry in place
        (names and held instrument references survive), restart the
        allocator high-water mark and the scrub total, and clear the kernel
        dispatch tallies and the probe sampling phase. Engine *state*
        (queues, caches, seed, step index) is untouched."""
        self.metrics.reset()
        self.kv.allocator.reset_peak()
        if self.kv.registers is not None:
            self.kv.registers.reset_peak()
        self.kv.pages_scrubbed = 0
        self.kv.slots_scrubbed = 0
        if self.prefix_cache is not None:
            # cached contents survive the window boundary; only the
            # traffic stats restart
            self.prefix_cache.inserted_pages = 0
            self.prefix_cache.evicted_pages = 0
        kops.reset_dispatch_counts()
        if self.quality_probes is not None:
            self.quality_probes.reset()
        self._update_gauges()
