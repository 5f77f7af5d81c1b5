"""One run of one cell: set the program up, warm it, drive the closed loop
through the window, read the trace, check what was served.

The program under test is `repro_torch`'s servable model as the
configuration's family builds it (`perfbench/families/<family>.py`:
weights drawn from the seed, the program's own quantisation and packing,
`serve.engine.as_servable`), served by a `ServeEngine` whose pool holds
every slot's worst case. The harness drives `ServeEngine.step()` and
receives every token through `submit(..., on_token=)`, stamped on its own
clock at the step boundary that delivers it.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import numpy as np
import torch

from . import counts, spec
from . import trace as tr
from .traffic import ClosedLoop, Traffic

WARM_RID = 1 << 40        # warm-up requests' ids: clear of the clients'


def log(t_start: float, what: str):
    print(f"perfbench: {time.perf_counter() - t_start:8.2f} s  {what}",
          file=sys.stderr, flush=True)


@dataclasses.dataclass
class StepRecord:
    t0: float
    t1: float
    decode_ctx: list[int]                    # context after each decode row
    chunks: list[tuple[int, int, bool]]      # (start, real rows, completes)

    @property
    def kind(self) -> str:
        return "prefill" if self.chunks else "decode"


class Runner:
    """The program under test and the clients that load it."""

    def __init__(self, cfg: dict, traffic: Traffic, seed: int, device,
                 family):
        from repro_torch.serve.engine import ServeEngine, pages_for
        self.family = family
        self.dims = family.dims(cfg)
        self.traffic = traffic
        self.on_card = torch.device(device).type == "cuda"
        adapter = family.build(cfg, self.dims,
                               family.draw(cfg, seed, device), seed, device)
        page = traffic.page_size
        per_seq = pages_for(traffic.max_total, page)
        self.engine = ServeEngine(
            adapter, n_pages=traffic.clients * per_seq + 1, page_size=page,
            max_seqs=traffic.clients, prefill_chunk=traffic.prefill_chunk,
            seed=seed, max_context=per_seq * page)
        self.loop = ClosedLoop(traffic, self.dims["vocab"], seed)
        self.reqs: dict[int, object] = {}
        self.meta: dict[int, tuple[int, int]] = {}    # rid -> (client, round)
        self.t_submit: dict[int, float] = {}
        self.stamps: dict[int, list[float]] = {}
        self.t_done: dict[int, float] = {}
        self._next_rid = 0

    # -- clients ------------------------------------------------------------

    def _on_token(self, rid: int, tok: int):
        self.stamps[rid].append(time.perf_counter())

    def _submit(self, rid: int, prompt: list[int], max_new: int):
        from repro_torch.serve.engine import EngineRequest, SamplingParams
        req = EngineRequest(rid=rid, prompt=prompt,
                            sampling=SamplingParams(max_new=max_new))
        self.reqs[rid] = req
        self.stamps[rid] = []
        self.t_submit[rid] = time.perf_counter()
        self.engine.submit(req, on_token=self._on_token)

    def send(self, client: int, rnd: int):
        spec = self.loop.request(rnd, client)
        rid = self._next_rid
        self._next_rid += 1
        self.meta[rid] = (client, rnd)
        self._submit(rid, spec.prompt, spec.max_new)

    def step(self, label: str | None = None) -> StepRecord:
        """One engine step, its rows counted from what each request holds
        before and after it; a client whose request ended sends its next."""
        eng = self.engine
        before = {r.rid: r.n_cached for r in eng.queue + eng.active}
        decoding = {r.rid for r in eng.decoding}
        t0 = time.perf_counter()
        if label is None:
            finished = eng.step()
        else:
            with torch.profiler.record_function(label):
                finished = eng.step()
        t1 = time.perf_counter()
        dec, chunks = [], []
        for rid, n0 in before.items():
            r = self.reqs[rid]
            dn = r.n_cached - n0
            if dn <= 0:
                continue
            if rid in decoding:
                dec.append(r.n_cached)
            else:
                chunks.append((n0, dn, r.n_cached == len(r.prompt)))
        for r in finished:
            self.t_done[r.rid] = t1
            if r.rid in self.meta:
                client, rnd = self.meta[r.rid]
                self.send(client, rnd + 1)
        return StepRecord(t0, t1, dec, chunks)

    # -- set-up ------------------------------------------------------------

    def _serve_alone(self, prompt_len: int, max_new: int, rng):
        rid = WARM_RID + len(self.reqs)
        self._submit(rid, rng.integers(0, self.dims["vocab"],
                                       prompt_len).tolist(), max_new)
        while self.engine.queue or self.engine.active:
            self.engine.step()

    def warm_up(self, seed: int):
        """Every decode-graph variant the cell can reach (table widths up
        to its longest context) and every padded prefill size up to its
        chunk, each request served alone."""
        from repro_torch.serve.engine import pages_for
        t = self.traffic
        rng = np.random.default_rng([seed, 40])
        max_ctx = self.engine.max_context
        top = counts.next_pow2(pages_for(t.max_total, t.page_size))
        c = 1
        while c <= top:
            self._serve_alone(min(c * t.page_size, max_ctx) - 3, 3, rng)
            c *= 2
        p = 1
        while p <= t.prefill_chunk:
            self._serve_alone(p, 1, rng)
            p *= 2

    def prime(self):
        """The first wave (a loop already running), prefilled, then
        `settle_steps` steps of the loop."""
        first = []
        for c in range(self.traffic.clients):
            first.append(self._next_rid)
            self.send(c, 0)
        reqs = [self.reqs[rid] for rid in first]
        while any(r.n_cached < len(r.prompt) and not r.done for r in reqs):
            self.step()
        for _ in range(self.traffic.settle_steps):
            self.step()

    def window(self, seconds: float) -> tuple[list[StepRecord], float, float]:
        gc.collect()
        gc.freeze()
        t0 = time.perf_counter()
        recs = []
        while True:
            recs.append(self.step())
            if recs[-1].t1 - t0 >= seconds:
                break
        gc.unfreeze()
        return recs, t0, recs[-1].t1

    def traced(self, n_steps: int):
        recs = []
        with tr.profiled() as holder:
            for i in range(n_steps):
                recs.append(self.step(f"{tr.STEP_PREFIX}{i}"))
            if self.on_card:
                torch.cuda.synchronize()
        groups = {**tr.HAND_WRITTEN, **getattr(self.family, "KERNELS", {})}
        summary = tr.reduce_profile(holder["prof"], [r.kind for r in recs],
                                    groups)
        return recs, summary


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    family: object
    dims: dict
    traffic: Traffic
    setup_s: float
    records: list[StepRecord]
    t0: float
    t1: float
    t_submit: dict
    stamps: dict
    trace_records: list[StepRecord] | None = None
    trace: dict | None = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t1

    def ttfts(self) -> list[float]:
        return [s[0] - self.t_submit[rid] for rid, s in self.stamps.items()
                if s and rid in self.t_submit and rid < WARM_RID
                and self.in_window(s[0])]

    def itls(self) -> list[float]:
        out = []
        for rid, s in self.stamps.items():
            if rid >= WARM_RID:
                continue
            for a, b in zip(s, s[1:]):
                if self.in_window(a) and self.in_window(b):
                    out.append(b - a)
        return out

    def tokens_in_window(self) -> int:
        return sum(1 for rid, s in self.stamps.items() if rid < WARM_RID
                   for t in s if self.in_window(t))


def percentile(values, q: float) -> float | None:
    """The q-th percentile by nearest rank, None without values."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


# -- correctness ----------------------------------------------------------

def pick_sample(rn: Runner, n: int, seed: int) -> list[int]:
    """Client requests holding cached positions when the window closed,
    drawn from the seed, the one with the longest context among them."""
    live = sorted((r for r in rn.engine.active if r.rid in rn.meta
                   and r.n_cached > 0), key=lambda r: (-r.n_cached, r.rid))
    if not live:
        return []
    rest = live[1:]
    rng = np.random.default_rng([seed, 50])
    extra = rng.choice(len(rest), size=min(n - 1, len(rest)),
                       replace=False) if rest and n > 1 else []
    return [live[0].rid] + [rest[i].rid for i in sorted(extra)]


def run_cell(cfg: dict, traffic: Traffic, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, limits: dict,
             control: bool = False) -> dict:
    """One run: returns the readers' context, the check and the device's
    peak memory."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        log(t_start, "set-up starts")
        fam = spec.family(cfg)
        rn = Runner(cfg, traffic, seed, device, fam)
        log(t_start, "program built (weights, PTQ, packing, engine)")
        rn.warm_up(seed)
        log(t_start, f"warmed up ({rn.engine.graph_stats()['graphs']} "
                     "decode graphs)")
        rn.prime()
        log(t_start, "loop primed")
        pool = rn.engine.kv.allocator
        pool.reset_peak()
        recs, t0, t1 = rn.window(seconds)
        setup_s = t0 - t_start
        log(t_start, f"window closed: {len(recs)} steps; pool pages in use "
                     f"{pool.in_use}, at most {pool.peak_in_use} in the "
                     f"window, of {pool.capacity}")
        ctx = Context(fam, rn.dims, traffic, setup_s, recs, t0, t1,
                      rn.t_submit, rn.stamps)
        if trace:
            ctx.trace_records, ctx.trace = rn.traced(traffic.trace_steps)
            log(t_start, "traced slice read")
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        held = [fam.held(rn.engine, rn.reqs[rid],
                         limits.layers_held(rn.dims["n_layers"]))
                for rid in pick_sample(rn, traffic.sample_requests, seed)]
        short = sum(1 for rid, t in rn.t_done.items() if rid in rn.meta
                    and t >= t0 and rn.reqs[rid].outcome == "length"
                    and len(rn.reqs[rid].generated)
                    != rn.reqs[rid].sampling.max_new)
        outcomes = [r.outcome for rid, r in rn.reqs.items()
                    if rid < WARM_RID]
        attempted = sum(1 for rid in rn.reqs if rid < WARM_RID
                        and rn.t_submit[rid] <= t1
                        and rn.t_done.get(rid, t1) >= t0)
        failed = sum(1 for o in outcomes if o not in (None, "length", "stop"))
        del rn
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        check = fam.numbers(cfg, seed, device, held, limits) if held \
            else {**{k: math.inf for k in limits.limit_of()}, "positions": 0}
        if control and held:
            check["control"] = fam.numbers(cfg, seed, device, held, limits,
                                           control=True)
        n_held = len(held)
        del held
        log(t_start, f"checked {n_held} requests")
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    checks = {k: {"value": check[k], "limit": lim}
              for k, lim in limits.limit_of().items()}
    checks["short_outputs"] = {"value": short, "limit": 0}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    correct = n_held > 0 and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    return {"ctx": ctx, "checks": checks, "correct": correct,
            "attempted": attempted, "failed": failed, "peak": peak,
            "check": check}
