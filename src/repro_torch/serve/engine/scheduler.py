"""Continuous-batching scheduler over the paged serving state.

Scheduling model (one `step()` = one engine iteration):

  1. **Admission** - `"reserve"`: admit a queued request only when
     `pages_for(prompt + max_new)` worst-case pages fit beside the pages
     already committed, so a running sequence can never hit an out-of-pages
     fault. Committed pages are tracked as a running total, so admission is
     O(queue); it blocks head-of-line for fairness.
  2. **Decode** - every generating sequence advances one token in a single
     batched `forward_chunk` call with per-slot fill positions and
     block-table rows, padded to `max_seqs` rows so the kernels see fixed
     shapes. Table widths are padded to powers of two. Forward, sampling
     and the per-row max logit are one fused dispatch (`_fused`, the
     reference's counterpart): on the card a CUDA graph per variant - table
     width, probe, sampling, filtering - captured at the variant's first
     step and replayed at every later one, its inputs copied into static
     buffers first and its tokens read back in one transfer.
  3. **Chunked prefill** - the rest of the per-step token budget goes to the
     head-of-line prompt, `prefill_chunk` tokens at a time, chunks padded to
     the next power of two.

Sampling is greedy at temperature 0; elsewhere categorical over
logits / temperature restricted to the top-k tokens and then the nucleus.
Each stochastic row draws from its own generator seeded from
`(engine seed, rid, stream position)` - never from a global step state - so
the token sampled at a given position of a given request is the same no
matter which step or batch slot produces it.

A non-finite max logit in a sampling row (a poisoned model output) ends
only that request, with outcome `failed`, instead of sampling garbage into
its stream.

The page pool is updated in place by the model's forward; the engine keeps
one reference to it (`self.kv.state`).

Telemetry: every counter lives in a `MetricsRegistry` whose snapshot carries
the reference's whole taxonomy (`serve.telemetry.schema`); the counters of
features not ported yet stay at 0, as the reference's do when those features
are off. A `Tracer` records request lifecycles and each forward's wall time
(ending in a device synchronise); `QualityProbes` runs the probe variant of
every K-th decode forward. Both are off by default and change no token or
logit.

Not ported yet (they raise `NotImplementedError`): optimistic admission with
preemption and replay, cancel / deadlines / drain, fault injection, the
prefix cache and the host swap tier (ROADMAP Queue A5).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import numpy as np
import torch

from ...kernels import ops as kops
from ..telemetry.metrics import MetricsRegistry
from ..telemetry.quality import QualityProbes
from ..telemetry.schema import (REQUIRED_COUNTERS, REQUIRED_GAUGES,
                                REQUIRED_HISTOGRAMS)
from ..telemetry.trace import PID_REQUESTS, Tracer
from .adapter import ServableModel
from .graphs import CapturedCall, pool_bytes
from .pages import PagedKVCache, pages_for


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
    generated: list[int] = dataclasses.field(default_factory=list)
    # per generated token: float32 logits row (only when record_logits)
    step_logits: list[np.ndarray] = dataclasses.field(default_factory=list)
    stop_hit: bool = False     # a stop sequence ended generation early
    failed: str | None = None  # terminal failure (poisoned model output)
    # --- engine-internal state ---
    n_cached: int = 0          # KV rows already written for this sequence
    next_token: int | None = None
    t_submit: float | None = None   # perf_counter at submit
    t_admit: float | None = None    # perf_counter at admission

    @property
    def done(self) -> bool:
        return (self.stop_hit or self.failed is not None
                or len(self.generated) >= self.sampling.max_new)

    @property
    def outcome(self) -> str | None:
        """Why the request ended: "length" | "stop" | "failed", or None
        while still in flight."""
        if self.failed is not None:
            return "failed"
        if self.stop_hit:
            return "stop"
        if len(self.generated) >= self.sampling.max_new:
            return "length"
        return None


_UNPORTED = {
    "prefix_cache": "the radix prefix cache is ROADMAP Queue A5",
    "swap_host_mb": "the host swap tier is ROADMAP Queue A5",
    "faults": "fault injection is ROADMAP Queue A5",
    "deadline_s": "request deadlines are ROADMAP Queue A5",
}


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
                 admission: str = "reserve",
                 max_context: int | None = None,
                 tracer: Tracer | None = None,
                 quality_probes: QualityProbes | None = None,
                 eager: bool = False, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"unexpected argument {name!r}")
            if value:
                raise NotImplementedError(f"{name}: {_UNPORTED[name]}")
        if admission == "optimistic":
            raise NotImplementedError(
                "optimistic admission needs preemption and replay "
                "(ROADMAP Queue A5); use admission='reserve'")
        if admission != "reserve":
            raise ValueError(f"admission must be 'optimistic' or 'reserve', "
                             f"got {admission!r}")
        self.adapter = adapter
        self.spec = adapter.state_spec
        if not self.spec.kv or self.spec.register:
            raise NotImplementedError(
                "only kv-only state specs are served so far "
                "(register-slot state is ROADMAP Queue A10)")
        self.device = adapter.device
        self.max_seqs = max_seqs
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget or max(max_seqs, prefill_chunk)
        self.record_logits = record_logits
        self.admission = admission
        self.seed = seed
        self.kv = PagedKVCache(adapter.init_state(n_pages, page_size, 0),
                               n_pages, page_size)
        cap = self.kv.allocator.capacity
        self.max_context = max_context if max_context is not None \
            else cap * page_size
        self.queue: list[EngineRequest] = []
        self.prefilling: list[EngineRequest] = []
        self.decoding: list[EngineRequest] = []
        self._committed: dict[int, int] = {}   # rid -> committed page count
        self._committed_total = 0              # == sum(_committed.values())
        self._terminal: list[EngineRequest] = []   # drained by step()
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

    def submit(self, req: EngineRequest, on_token=None):
        """Queue a request."""
        if on_token is not None:
            raise NotImplementedError(
                "token streaming callbacks are ROADMAP Queue A5")
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
        if total > self.max_context:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)} tokens) + "
                f"max_new ({req.sampling.max_new}) exceeds the model "
                f"context window ({self.max_context} tokens)")
        worst = pages_for(total, self.kv.page_size)
        cap = self.kv.allocator.capacity
        if worst > cap:
            raise ValueError(
                f"request {req.rid} needs {worst} pages; pool capacity "
                f"is {cap}")
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        self.metrics.counter("engine.requests.submitted").inc()
        if self.tracer:
            self.tracer.begin("request", pid=PID_REQUESTS, tid=req.rid,
                              args={"prompt_tokens": len(req.prompt),
                                    "max_new": req.sampling.max_new})
            self.tracer.begin("queued", pid=PID_REQUESTS, tid=req.rid)

    def _pages_needed(self, req: EngineRequest) -> int:
        """KV pages admission requires: the worst case, prompt + max_new."""
        return pages_for(len(req.prompt) + req.sampling.max_new,
                         self.kv.page_size)

    def _admit(self):
        cap = self.kv.allocator.capacity
        while self.queue and len(self.active) < self.max_seqs:
            req = self.queue[0]
            need = self._pages_needed(req)
            if self._committed_total + need > cap:
                self.metrics.counter("engine.admission.blocked").inc()
                return           # head-of-line blocks until pages free up
            self.queue.pop(0)
            self.kv.open(req.rid)     # before committing: if this raises,
            self._committed[req.rid] = need   # no reservation leaks
            self._committed_total += need
            self.prefilling.append(req)
            self.metrics.counter("engine.requests.admitted").inc()
            req.t_admit = time.perf_counter()
            self.metrics.histogram("engine.admission.wait_s").observe(
                max(req.t_admit - req.t_submit, 0.0))
            if self.tracer:
                self.tracer.end("queued", pid=PID_REQUESTS, tid=req.rid)
                self.tracer.begin("prefill", pid=PID_REQUESTS, tid=req.rid)

    def _release(self, req: EngineRequest):
        """Return an admitted request's pages and its commitment."""
        self.kv.release(req.rid)
        self._committed_total -= self._committed.pop(req.rid)

    def _finish(self, req: EngineRequest):
        self._release(req)
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

    def _fail(self, req: EngineRequest, reason: str):
        """Terminate one active request as `failed`: pages scrubbed and
        released, books rebalanced, returned from the current `step()`."""
        phase = "prefill" if req in self.prefilling else "decode"
        (self.prefilling if phase == "prefill" else self.decoding).remove(req)
        self._release(req)
        req.failed = reason
        self.metrics.counter("engine.requests.poisoned").inc()
        self.metrics.counter("engine.requests.failed").inc()
        if self.tracer:
            self.tracer.end(phase, pid=PID_REQUESTS, tid=req.rid)
            self.tracer.end("request", pid=PID_REQUESTS, tid=req.rid,
                            args={"outcome": "failed",
                                  "generated": len(req.generated)})
        self._terminal.append(req)

    def cancel(self, rid: int):
        raise NotImplementedError("cancellation is ROADMAP Queue A5")

    def drain(self):
        raise NotImplementedError("drain is ROADMAP Queue A5")

    def check_books(self):
        """Assert the accounting invariants: the running committed total
        matches the per-rid map, every committed rid is active and holds a
        table, each page's refcount equals its multiplicity over the
        tables, and free + in-use pages cover the capacity exactly."""
        assert self._committed_total == sum(self._committed.values()), \
            (self._committed_total, self._committed)
        active = {r.rid for r in self.active}
        assert set(self._committed) == active == set(self.kv.tables), \
            (set(self._committed), active, set(self.kv.tables))
        alloc = self.kv.allocator
        counts: dict[int, int] = {}
        for t in self.kv.tables.values():
            for p in t:
                counts[p] = counts.get(p, 0) + 1
        assert alloc.in_use == len(counts), (alloc.in_use, len(counts))
        for p, c in counts.items():
            assert alloc.refcount(p) == c, (p, alloc.refcount(p), c)
        for rid, t in self.kv.tables.items():
            assert len(t) <= self._committed[rid], (rid, len(t))
        assert alloc.n_free + alloc.in_use == alloc.capacity

    def _ensure(self, rid: int, n_tokens: int):
        """Grow `rid`'s table to cover `n_tokens` positions, with an instant
        trace event when the growth allocated pages. Under `"reserve"` the
        worst-case commitment always covers the table, so this can never
        exhaust the pool."""
        before = self.kv.allocator.n_free
        self.kv.ensure(rid, n_tokens)
        got = before - self.kv.allocator.n_free
        if got and self.tracer:
            self.tracer.instant("alloc_pages", pid=PID_REQUESTS, tid=rid,
                                args={"pages": got})

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
        """Grow every decoding sequence's table by one position."""
        for req in list(self.decoding):
            self._ensure(req.rid, req.n_cached + 1)

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

    def _decode_impl(self, tokens, fill, bt, lens, temps=None, top_ks=None,
                     top_ps=None, uniforms=None, *, samples: bool,
                     filtered: bool, probe: bool):
        """One decode step on the device - what `_fused` captures (the
        reference's `_decode_impl`). The forward writes each new KV row into
        its page, in place, and attends by walking `bt`; `lens` are the
        true per-slot context lengths (0 for padded rows), which end the
        kernel's walk at each sequence's live pages and are each sampled
        token's stream position. Returns (logits [B, V] f32, tokens and max
        logits [2, B] f64, the per-layer probe stats or None)."""
        args = (self.adapter.params, tokens, self.kv.state, fill, bt, lens)
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
        n_cols = _next_pow2(max(
            pages_for(n, self.kv.page_size) for n in new_lens))
        m.counter("engine.pages_walked").inc(
            sum(pages_for(n, self.kv.page_size) for n in new_lens))
        m.counter("engine.pages_walked_dense").inc(b * n_cols)
        inputs = {
            "tokens": torch.tensor([[r.next_token] for r in batch]
                                   + [[0]] * pad, dtype=torch.int64),
            "fill": torch.tensor([r.n_cached for r in batch] + [0] * pad,
                                 dtype=torch.int32),
            "bt": self.kv.block_table_array(rids, n_cols),
            "lens": torch.tensor(new_lens + [0] * pad, dtype=torch.int32),
        }
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
                self._fail(req, f"non-finite logits at stream position "
                                f"{req.n_cached} (poisoned model output)")
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
        prompt; returns (tokens consumed, requests finished).

        Padded tail rows are computed too (their queries may attend the
        garbage keys the same forward wrote for earlier padding tokens, so
        their outputs are meaningless and discarded); their in-page writes
        land on the scratch page or on not-yet-valid slots that are
        rewritten before the causal mask ever exposes them."""
        req = self.prefilling[0]
        stream = req.prompt
        start = req.n_cached
        m = self.metrics
        dev = self.device
        real = min(self.prefill_chunk, budget, len(stream) - start)
        padded = _next_pow2(real)
        self._ensure(req.rid, start + real)
        n_cols = _next_pow2(pages_for(start + padded, self.kv.page_size))
        bt = self.kv.block_table_array([req.rid], n_cols)
        m.counter("engine.pages_walked").inc(
            pages_for(start + real, self.kv.page_size))
        m.counter("engine.pages_walked_dense").inc(n_cols)

        # every device-side shape depends only on (padded, n_cols), both
        # powers of two, so the kernels see a bounded set of shapes
        chunk = stream[start:start + real] + [0] * (padded - real)
        tokens = torch.tensor([chunk], dtype=torch.int64, device=dev)
        # the true cached length after this chunk: trims the kernel's walk
        # to the live pages, and is the sampled token's stream position
        lens = torch.tensor([start + real], dtype=torch.int32, device=dev)
        tr = self.tracer
        ts0 = tr.ts() if tr else 0.0
        logits, self.kv.state = self.adapter.forward_chunk(
            self.adapter.params, tokens, self.kv.state, start, bt, lens)
        if tr:
            self._sync()
            tr.complete("dispatch.prefill", ts0, tr.ts() - ts0,
                        args={"rid": req.rid, "tokens": real,
                              "padded": padded})
        lg = logits[:, real - 1].to(torch.float32)
        toks, mx = self._sample(lg, [req], [req.rid], [start + real])
        if not np.isfinite(mx[0]):
            # poisoned model output mid-prefill: the request cannot
            # continue - terminate it alone (the single-sequence dispatch
            # touched no other state)
            self._fail(req, f"non-finite logits in prefill at stream "
                            f"position {start + real - 1} "
                            f"(poisoned model output)")
            return real, []

        req.n_cached = start + real
        m.counter("engine.prefill_tokens").inc(real)
        m.histogram("engine.prefill.chunk_tokens").observe(real)
        finished = []
        if req.n_cached == len(stream):
            # prompt fully cached: the call already sampled the next token
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
        terminal state during it (check `req.outcome`)."""
        m = self.metrics
        t0 = time.perf_counter()
        gen0 = m.counter("engine.generated_tokens").value
        self._admit()
        finished = []
        budget = self.token_budget
        spent = 0
        if self.decoding:
            self._grow_decode()
            budget -= len(self.decoding)
            spent += len(self.decoding)
            finished.extend(self._decode_once())
        while budget > 0 and self.prefilling:
            used, fin = self._prefill_once(budget)
            budget -= used
            spent += used
            finished.extend(fin)
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
        return finished

    def run(self) -> list[EngineRequest]:
        done = []
        while self.queue or self.active:
            done.extend(self.step())
        return done

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def _register_metrics(self):
        """Pre-create every name of the taxonomy (`serve.telemetry.schema`)
        so a snapshot is schema-complete even before any traffic. The
        instruments of features not ported yet (preemption and replay,
        cancel, deadlines, dispatch faults, the prefix cache, the swap tier,
        stream callbacks) stay at 0, as the reference's do with those
        features off."""
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
        (queues, caches, seed) is untouched."""
        self.metrics.reset()
        self.kv.allocator.reset_peak()
        self.kv.pages_scrubbed = 0
        kops.reset_dispatch_counts()
        if self.quality_probes is not None:
            self.quality_probes.reset()
        self._update_gauges()
