"""Serving throughput and latency of the port: paged engine vs the legacy
slot scheduler - the twin of the reference's `benchmarks/serve_bench.py`.

Drives the same request trace through (a) the legacy dense-slot
`serve.step.BatchScheduler` (one token per sequence per step, prompts
dripped token by token), (b) the paged-KV engine on the bf16 path, and (c)
the paged engine on the packed-int4 path with bf16 and int8 KV pages. A
second set of engine rows covers the non-dense families the engine serves
- pure SSM (mamba2, register slots only), hybrid (zamba2, kv pages +
register slots) and MoE (deepseek, kv pages + routed FFN). Reports
generated tokens/s and p50/p95 per-token latency (each generated token
inherits the wall time of the engine step that produced it) and appends
the rows to the history file (default `artifacts/BENCH_serve_h100.json`);
every row carries a `family` tag and `_check_schema` checks the rows
before anything is written.

Gated traces, as the reference's (each raises `SystemExit` before any row
is written when its win does not show):

- burst (`engine_burst_{reserve,optimistic}`): optimistic admission beats
  reservation on peak page utilisation and admission-wait p95;
- swap (`engine_swap_{recompute,swap}`): under the same page pressure the
  host swap tier replays fewer prefill tokens and waits less than
  preempt-and-replay, and both give an unpressured baseline's greedy
  tokens;
- prefix (`engine_prefix_{off,on}`): the radix prefix cache computes at
  most half the prefill tokens, with hits and bit-identical greedy tokens.

Every snapshot goes through `serve.telemetry.validate_snapshot`. The
attention data path in isolation (`attn_slab_gather`, `attn_paged_kernel`)
times one decode step's attention over one page pool through the slab
round trip (`serve.engine.pages.gather_pages` and a dense softmax: the
reference's own baseline, not a kernel of the port) and through
`kernels.ops.paged_attention`.

Every path is warmed up on the same scheduler or engine object first - on
the card that warm-up captures the engine's decode graphs, so the measured
round replays them. Engine and scheduler times are host clocks: an engine
step ends in the transfer of its tokens, which waits for the device. The
attention rows are CUDA-event times on the card. Without `--reduced`
llama3-1b, mamba2-1.3b and zamba2-1.2b run at published size and
deepseek-moe-16b at full width cut to 4 layers (recorded as `layers`);
with it every config is the reference's `.reduced()`.

    python -m repro_torch.bench.serve_bench [--smoke] [--reduced]
        [--device cuda|cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from . import timing as T

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts")

# deepseek-moe-16b's depth without --reduced: full width, 4 of its 28
# layers (the full depth waits for Model.init to build stacked leaves in
# place)
MOE_LAYERS = 4


def _trace(n_requests: int, vocab: int, *, seed: int = 0,
           lo: int = 3, hi: int = 12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n_requests)]


def _drive(submit, step, pending, total_new):
    """Warmup round (every shape compiled or captured on the same object),
    then a measured round; returns (wall_s, per-token latencies in seconds,
    steps)."""
    submit()
    while pending():
        step()
    submit()
    lat, done_tokens, steps = [], 0, 0
    t_start = time.perf_counter()
    while pending():
        t0 = time.perf_counter()
        step()
        dt = time.perf_counter() - t0
        steps += 1
        new = total_new() - done_tokens
        done_tokens = total_new()
        lat.extend([dt] * new)
    return time.perf_counter() - t_start, lat, steps


def bench_legacy(model, params, prompts, max_new, slots, max_len):
    from ..serve.step import BatchScheduler, Request

    sched = BatchScheduler(model, params, slots=slots, max_len=max_len)
    done: list = []

    def submit():
        done.clear()
        for rid, p in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=list(p), max_new=max_new))

    wall, lat, steps = _drive(
        submit, lambda: done.extend(sched.step()),
        lambda: bool(sched.queue or sched.active),
        lambda: sum(len(r.generated) for r in done)
        + sum(len(r.generated) for r in sched.active.values()))
    return wall, lat, steps, None


def bench_engine(adapter, prompts, max_new, slots, max_len, page_size,
                 prefill_chunk):
    from ..serve.engine import (EngineRequest, SamplingParams, ServeEngine,
                                pages_for)

    n_pages = slots * pages_for(max_len, page_size) + 1
    eng = ServeEngine(adapter, n_pages=n_pages, page_size=page_size,
                      max_seqs=slots, prefill_chunk=prefill_chunk)
    done: list = []

    def submit():
        done.clear()
        # reset at each round boundary so the registry covers exactly the
        # measured trace (the warmup round re-runs the same requests)
        eng.reset_metrics()
        for rid, p in enumerate(prompts):
            eng.submit(EngineRequest(
                rid=rid, prompt=list(p),
                sampling=SamplingParams(max_new=max_new)))

    wall, lat, steps = _drive(
        submit, lambda: done.extend(eng.step()),
        lambda: bool(eng.queue or eng.active),
        lambda: sum(len(r.generated) for r in done)
        + sum(len(r.generated) for r in eng.active))
    # engine accounting comes off the registry snapshot - the export
    # surface the launcher writes - not engine internals. Walked pages:
    # what the ragged early exit walked vs the padded batch × full table
    c = eng.metrics_snapshot()["counters"]
    pages = {"pages_walked": c["engine.pages_walked"],
             "pages_walked_dense": c["engine.pages_walked_dense"]}
    return wall, lat, steps, pages


def bench_burst(adapter, *, n_tenants, prompt_len, max_new, page_size,
                vocab, seed=7):
    """Synthetic bursty multi-tenant trace: `n_tenants` equal-priority
    requests arrive in one burst against a page pool deliberately too
    small for everyone's worst case (capacity = 3 worst-case footprints
    when four arrive). Reservation admission head-of-line blocks the
    last tenant until someone finishes; optimistic admission admits the
    whole burst on prompt pages + headroom and recovers from the
    resulting mid-decode exhaustion by preempting and replaying a
    victim. The recorded win is peak page utilisation and time-to-first-
    admission p95, both off the validated registry snapshot.
    """
    from ..serve.engine import (EngineRequest, SamplingParams, ServeEngine,
                                pages_for)
    from ..serve.telemetry import validate_snapshot

    worst = pages_for(prompt_len + max_new, page_size)
    n_pages = 3 * worst + 2          # capacity 3·worst + 1 (< 4·worst)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=prompt_len).tolist()
               for _ in range(n_tenants)]

    rows = []
    for mode in ("reserve", "optimistic"):
        eng = ServeEngine(adapter, n_pages=n_pages, page_size=page_size,
                          max_seqs=n_tenants, admission=mode)
        done: list = []

        def submit():
            done.clear()
            eng.reset_metrics()
            for rid, p in enumerate(prompts):
                eng.submit(EngineRequest(
                    rid=rid, prompt=list(p),
                    sampling=SamplingParams(max_new=max_new)))

        # progress counts queued replays too: a preempted request keeps
        # its generated tokens while waiting, and must not be re-counted
        # as fresh progress when re-admitted
        wall, lat, steps = _drive(
            submit, lambda: done.extend(eng.step()),
            lambda: bool(eng.queue or eng.active),
            lambda: sum(len(r.generated) for r in done)
            + sum(len(r.generated) for r in eng.queue + eng.active))
        snap = eng.metrics_snapshot()
        validate_snapshot(snap)
        c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
        rows.append({
            "path": f"engine_burst_{mode}",
            "family": "dense",
            "admission": mode,
            "tokens_per_s": round(len(lat) / wall, 2),
            "gen_tokens": len(lat),
            "steps": steps,
            "wall_s": round(wall, 3),
            "peak_util": round(g["engine.pages.utilization_peak"], 4),
            "admission_wait_p95_ms": round(
                (h["engine.admission.wait_s"]["p95"] or 0.0) * 1e3, 3),
            "preemptions": c["engine.preemptions"],
            "replayed_prefill_tokens": c["engine.replayed_prefill_tokens"],
        })

    res, opt = rows
    # the whole point of optimistic+preemption: strictly higher peak
    # utilisation AND strictly lower time-to-first-admission on the same
    # burst - refuse to record rows that don't show the win
    if not (opt["peak_util"] > res["peak_util"]
            and opt["admission_wait_p95_ms"] < res["admission_wait_p95_ms"]):
        raise SystemExit(
            "bursty trace did not show the optimistic-admission win: "
            f"peak_util {opt['peak_util']} vs {res['peak_util']}, "
            f"wait p95 {opt['admission_wait_p95_ms']}ms vs "
            f"{res['admission_wait_p95_ms']}ms")
    return rows


def bench_swap(adapter, *, vocab, seed=13):
    """Tiered-paging trace: swap-to-host vs recompute-by-replay under
    identical page pressure.

    Two long residents decode against a pool sized so their combined
    growth must evict one of them; two short requests then arrive and
    wait for seats. The recompute mode (no host tier) preempts the
    victim and replays its whole `prompt + generated` stream; the swap
    mode parks the victim's pages in an 8 MiB host tier and patches them
    back, replaying nothing. Both runs - and an unpressured baseline
    with room for all four worst cases - must produce bit-identical
    greedy tokens; the recorded (and asserted) win is fewer replayed
    prefill tokens AND lower admission-wait p95 for the swap mode, both
    off the validated registry snapshot.
    """
    from ..serve.engine import (EngineRequest, SamplingParams, ServeEngine,
                                pages_for)
    from ..serve.telemetry import validate_snapshot

    long_len, short_len, max_new = 60, 6, 8
    page_size, n_pages = 8, 18       # 17 usable < 2 pressured worst cases
    rng = np.random.default_rng(seed)
    longs = [rng.integers(0, vocab, size=long_len).tolist()
             for _ in range(2)]
    shorts = [rng.integers(0, vocab, size=short_len).tolist()
              for _ in range(2)]

    def make_req(rid, prompt):
        return EngineRequest(rid=rid, prompt=list(prompt),
                             sampling=SamplingParams(max_new=max_new))

    def run_round(eng, base):
        """Longs decode until pressure evicts one (swap or preempt,
        depending on the engine's mode), then the shorts arrive."""
        eng.reset_metrics()
        c = eng.metrics

        def evictions():
            return (c.counter("engine.preemptions").value
                    + c.counter("engine.swap.out").value)

        done: list = []
        t0 = time.perf_counter()
        for i, p in enumerate(longs):
            eng.submit(make_req(base + i, p))
        while evictions() == 0 and (eng.queue or eng.active):
            done.extend(eng.step())
            eng.check_books()
        for i, p in enumerate(shorts):
            eng.submit(make_req(base + 2 + i, p))
        done.extend(eng.run())
        eng.check_books()
        wall = time.perf_counter() - t0
        return {r.rid - base: list(r.generated) for r in done}, wall

    rows = []
    outs_by_mode = {}
    for mode, kw in (("recompute", dict(swap_policy="never")),
                     ("swap", dict(swap_host_mb=8.0, swap_policy="always"))):
        eng = ServeEngine(adapter, n_pages=n_pages, page_size=page_size,
                          max_seqs=2, prefill_chunk=8, token_budget=64,
                          headroom_pages=0, max_preemptions=10, **kw)
        run_round(eng, 100)       # warmup: every path, swap included
        outs, wall = run_round(eng, 0)
        snap = eng.metrics_snapshot()
        validate_snapshot(snap)
        c, h = snap["counters"], snap["histograms"]
        outs_by_mode[mode] = outs
        rows.append({
            "path": f"engine_swap_{mode}",
            "family": "dense",
            "tokens_per_s": round(c["engine.generated_tokens"] / wall, 2),
            "gen_tokens": c["engine.generated_tokens"],
            "wall_s": round(wall, 3),
            "preemptions": c["engine.preemptions"],
            "replayed_prefill_tokens": c["engine.replayed_prefill_tokens"],
            "swap_out": c["engine.swap.out"],
            "swap_in": c["engine.swap.in"],
            "swap_bytes": c["engine.swap.bytes"],
            "swap_retries": c["engine.swap.retries"],
            "swap_fallbacks": c["engine.swap.fallbacks"],
            "admission_wait_p95_ms": round(
                (h["engine.admission.wait_s"]["p95"] or 0.0) * 1e3, 3),
        })

    # unpressured baseline: every request fits its worst case, so no
    # eviction of any kind - the greedy tokens both pressured modes must
    # reproduce exactly
    base_pages = 4 * pages_for(long_len + max_new, page_size) + 1
    eng = ServeEngine(adapter, n_pages=base_pages, page_size=page_size,
                      max_seqs=4, prefill_chunk=8, token_budget=64)
    for i, p in enumerate(longs + shorts):
        eng.submit(make_req(i, p))
    base_outs = {r.rid: list(r.generated) for r in eng.run()}

    for mode, outs in outs_by_mode.items():
        if outs != base_outs:
            raise SystemExit(
                f"{mode} mode perturbed greedy tokens under pressure: "
                + "; ".join(f"rid{r}: {outs.get(r)} != {base_outs[r]}"
                            for r in base_outs
                            if outs.get(r) != base_outs[r]))
    rec, sw = rows
    if not (rec["preemptions"] >= 1 and sw["swap_out"] >= 1
            and sw["swap_in"] >= 1):
        raise SystemExit(
            "swap trace never hit pressure: "
            f"recompute preemptions {rec['preemptions']}, "
            f"swap out/in {sw['swap_out']}/{sw['swap_in']}")
    if not (sw["replayed_prefill_tokens"] < rec["replayed_prefill_tokens"]
            and sw["admission_wait_p95_ms"] < rec["admission_wait_p95_ms"]):
        raise SystemExit(
            "pressured trace did not show the swap-tier win: "
            f"replayed tokens {sw['replayed_prefill_tokens']} vs "
            f"{rec['replayed_prefill_tokens']}, wait p95 "
            f"{sw['admission_wait_p95_ms']}ms vs "
            f"{rec['admission_wait_p95_ms']}ms")
    return rows


def bench_prefix(adapter, *, vocab, n_convs=2, n_turns=3, system_len=32,
                 user_len=5, max_new=3, page_size=8, seed=11):
    """Shared-prefix multi-turn chat trace: prefix cache off vs on.

    `n_convs` conversations share one `system_len`-token system prompt;
    each turn's prompt is the previous turn's full stream (prompt +
    greedy completion) plus `user_len` fresh user tokens - the radix
    tree serves both the cross-conversation system prefix and each
    conversation's own history, so turn-k prefill shrinks from the whole
    transcript to roughly the new user tokens. The geometry is alignment-
    friendly on purpose (`prefill_chunk == page_size`, system prompt a
    page multiple): cache hits land on page boundaries, so the cached
    rows the on-run reads are the bitwise rows the off-run recomputes.

    Asserts - before any row is written - that the cache-on run (a)
    computes ≤ 50% of the off-run's prefill tokens, (b) records a
    nonzero prefix hit-rate, and (c) produces bit-identical greedy
    tokens for every (conversation, turn).
    """
    from ..serve.engine import (EngineRequest, SamplingParams, ServeEngine,
                                pages_for)
    from ..serve.telemetry import validate_snapshot

    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=system_len).tolist()
    suffix = [[rng.integers(0, vocab, size=user_len).tolist()
               for _ in range(n_turns)] for _ in range(n_convs)]
    final_len = system_len + n_turns * (user_len + max_new)
    n_pages = (n_convs + 1) * pages_for(final_len, page_size) * 2 + 1

    def run(prefix_on):
        eng = ServeEngine(adapter, n_pages=n_pages, page_size=page_size,
                          max_seqs=2, prefill_chunk=page_size,
                          token_budget=2 + page_size,
                          prefix_cache=prefix_on)
        streams = [system + suffix[c][0] for c in range(n_convs)]
        outs = {}
        rid = 0
        t0 = time.perf_counter()
        for turn in range(n_turns):
            reqs = []
            for c in range(n_convs):
                if turn:
                    streams[c] = (streams[c] + outs[(c, turn - 1)]
                                  + suffix[c][turn])
                r = EngineRequest(rid=rid, prompt=list(streams[c]),
                                  sampling=SamplingParams(max_new=max_new))
                rid += 1
                reqs.append(r)
                eng.submit(r)
            eng.run()
            eng.check_books()
            for c, r in enumerate(reqs):
                outs[(c, turn)] = list(r.generated)
        wall = time.perf_counter() - t0
        snap = eng.metrics_snapshot()
        validate_snapshot(snap)
        return outs, snap, wall

    rows = []
    results = {}
    for on in (False, True):
        outs, snap, wall = run(on)
        c = snap["counters"]
        lookups = c["engine.prefix.hits"] + c["engine.prefix.misses"]
        gen = c["engine.generated_tokens"]
        results[on] = (outs, c)
        rows.append({
            "path": "engine_prefix_on" if on else "engine_prefix_off",
            "family": "dense",
            "tokens_per_s": round(gen / wall, 2),
            "gen_tokens": gen,
            "wall_s": round(wall, 3),
            "prefill_tokens": c["engine.prefill_tokens"],
            "prefix_hits": c["engine.prefix.hits"],
            "prefix_hit_tokens": c["engine.prefix.hit_tokens"],
            "prefix_hit_rate": round(
                c["engine.prefix.hits"] / lookups, 4) if lookups else 0.0,
            "cow_copies": c["engine.prefix.cow_copies"],
        })

    (outs_off, c_off), (outs_on, c_on) = results[False], results[True]
    off, on = c_off["engine.prefill_tokens"], c_on["engine.prefill_tokens"]
    if outs_on != outs_off:
        raise SystemExit(
            "prefix cache perturbed greedy tokens: "
            + "; ".join(f"conv{c} turn{t}: {outs_on[(c, t)]} != "
                        f"{outs_off[(c, t)]}"
                        for (c, t) in outs_off
                        if outs_on[(c, t)] != outs_off[(c, t)]))
    if not (on * 2 <= off and c_on["engine.prefix.hits"] > 0):
        raise SystemExit(
            "shared-prefix trace did not show the radix-cache win: "
            f"prefill tokens {on} (cache on) vs {off} (off), "
            f"hits {c_on['engine.prefix.hits']}")
    return rows


def bench_attn_data_path(cfg, *, page_size, slots, seq_len, iters, device):
    """Slab-gather vs paged-kernel decode attention over one page pool.

    The batch is ragged (lengths span 25%..100% of `seq_len`) so the
    paged rows also show the flash-decoding early exit: the slab path
    gathers every table column of every slot, while the kernel walks
    `Σ ceil(len/page_size)` live pages per step (pages_walked_per_step).
    The paged row also holds the largest difference between the two
    paths' outputs (`max_abs_diff_vs_slab`).
    """
    from ..kernels import ops as kops
    from ..paper.common import ragged_paged_batch
    from ..serve.engine import pages as PG
    from ..serve.engine.pages import pages_for

    nl, kh, dh, h = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                     cfg.n_heads)
    per_seq = pages_for(seq_len, page_size)
    rng = np.random.default_rng(0)
    lengths, n_pages, table, positions = ragged_paged_batch(
        slots, seq_len, page_size)

    def tensor(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    pool = {"k": tensor((nl, n_pages, page_size, kh, dh)),
            "v": tensor((nl, n_pages, page_size, kh, dh))}
    bt = torch.tensor(table, dtype=torch.int32, device=device)
    qpos = torch.tensor(positions, dtype=torch.int32, device=device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = tensor((nl, slots, 1, h, dh))

    def slab_attn(ql, k_all, v_all):
        g = h // kh
        qg = ql.reshape(slots, 1, kh, g, dh)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k_all) / math.sqrt(dh)
        valid = (torch.arange(k_all.shape[1], device=device)[None, None, :]
                 <= qpos[:, :, None])
        logits = torch.where(valid[:, None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_all)
        return out.reshape(slots, 1, h, dh)

    def slab_step():
        slab = PG.gather_pages(pool, bt)
        return torch.stack([slab_attn(q[l], slab["k"][l], slab["v"][l])
                            for l in range(nl)])

    def paged_step():
        return torch.stack([
            kops.paged_attention(
                q[l], {"k": pool["k"][l], "v": pool["v"][l]}, bt, qpos,
                lens)
            for l in range(nl)])

    slab_bytes = 2 * nl * slots * per_seq * page_size * kh * dh * 4
    walked = {"attn_slab_gather": slots * per_seq,
              "attn_paged_kernel": sum(pages_for(n, page_size)
                                       for n in lengths)}
    diff = float((paged_step() - slab_step()).abs().max())

    rows = []
    for name, fn, gathered in (("attn_slab_gather", slab_step, slab_bytes),
                               ("attn_paged_kernel", paged_step, 0)):
        wall = T.clock_ms([fn], iters, device) * iters / 1e3
        rows.append({
            "path": name,
            "family": "dense",
            "tokens_per_s": round(slots * iters / wall, 2),
            "gathered_bytes_per_step": gathered,
            "pages_walked_per_step": walked[name],
            "seq_len": seq_len,
            "page_size": page_size,
            "wall_s": round(wall, 4),
        })
    rows[-1]["max_abs_diff_vs_slab"] = diff
    return rows


def _check_schema(rows):
    """Every row must carry `family` and `tokens_per_s` - a partial row (a
    bench path that crashed mid-collection or forgot its tag) fails
    instead of silently writing incomplete JSON history."""
    for row in rows:
        missing = [k for k in ("family", "tokens_per_s") if k not in row]
        if missing:
            raise ValueError(
                f"bench row {row.get('path', '?')!r} is missing required "
                f"field(s) {missing}; refusing to write partial history")


def _config(arch: str, reduced: bool, layers: int | None = None):
    """`arch`'s config: the reference's `.reduced()` one, or the published
    one, cut to `layers` when given."""
    from ..configs.registry import get_config

    cfg = get_config(arch)
    if reduced:
        return cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers).validate()
    return cfg


def _build(cfg, device):
    """(model, seeded params) of `cfg` on `device`."""
    from ..models.transformer import build_model

    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return model, model.init(gen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny trace: runs every engine path once, minimal "
                    "wall time")
    ap.add_argument("--reduced", action="store_true",
                    help="every config at the reference's reduced size")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(ART, "BENCH_serve_h100.json"))
    args = ap.parse_args(argv)
    device = T.bench_device(args.device)

    from ..serve.engine import as_servable
    from ..serve.quantized import QuantizedDenseLM, pack_dense_params
    from ..serve.telemetry import SCHEMA_VERSION

    cfg = _config("llama3-1b", args.reduced)
    model, params = _build(cfg, device)
    packed = pack_dense_params(params, cfg)

    # the serving-realistic trace is prompt-heavy (RAG/chat prompts are
    # much longer than completions) - exactly where chunked prefill beats
    # the legacy one-token-per-step prompt drip
    if args.smoke:
        n_req, max_new, lo, hi = 3, 3, 3, 12
    else:
        n_req, max_new, lo, hi = 12, 8, 16, 48
    slots, max_len, page, chunk = 2, 64, 8, 8
    prompts = _trace(n_req, cfg.vocab, lo=lo, hi=hi)
    total = sum(len(p) for p in prompts) + n_req * max_new

    # per-family engine rows: the engine serves the non-dense families
    # through the same scheduler. Family traces stay smoke-sized in both
    # modes (the point is the per-family trajectory, not a long trace);
    # each family's params live only for its own run
    def family_run(kind, arch, layers=None):
        fcfg = _config(arch, args.reduced, layers)

        def run():
            fmodel, fparams = _build(fcfg, device)
            fprompts = _trace(3, fcfg.vocab, lo=3, hi=12)
            return bench_engine(as_servable(fmodel, fparams), fprompts,
                                3, slots, max_len, page, chunk)
        return kind, fcfg, run

    runs = {
        "legacy_sched_bf16": ("dense", cfg,
            lambda: bench_legacy(model, params, prompts, max_new, slots,
                                 max_len)),
        "engine_bf16": ("dense", cfg,
            lambda: bench_engine(as_servable(model, params), prompts,
                                 max_new, slots, max_len, page, chunk)),
        "engine_int4_kvbf16": ("dense", cfg,
            lambda: bench_engine(
                as_servable(QuantizedDenseLM(cfg, block_size=16), packed),
                prompts, max_new, slots, max_len, page, chunk)),
        "engine_int4_kv8": ("dense", cfg,
            lambda: bench_engine(
                as_servable(QuantizedDenseLM(cfg, block_size=16, kv_bits=8),
                            packed),
                prompts, max_new, slots, max_len, page, chunk)),
        "engine_bf16_ssm": family_run("ssm", "mamba2-1.3b"),
        "engine_bf16_hybrid": family_run("hybrid", "zamba2-1.2b"),
        "engine_bf16_moe": family_run("moe", "deepseek-moe-16b", MOE_LAYERS),
    }

    rows = []
    print("path,family,tokens_per_s,p50_ms,p95_ms,gen_tokens,steps,wall_s,"
          "pages_walked_per_step,pages_dense_per_step,layers")
    for name, (kind, rcfg, fn) in runs.items():
        wall, lat, steps, pages = fn()
        gen = len(lat)
        # `steps` = scheduler iterations (≈ batched forward passes): the
        # hardware-independent scheduling win - chunked prefill needs far
        # fewer forwards per served token than the legacy token drip
        row = {
            "path": name,
            "family": kind,
            "tokens_per_s": round(gen / wall, 2),
            "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 3),
            "gen_tokens": gen,
            "steps": steps,
            "wall_s": round(wall, 3),
            "layers": rcfg.n_layers,
        }
        if pages is not None:
            # the ragged early exit's work reduction per attention
            # dispatch: live pages walked vs the padded batch × full table
            row["pages_walked_per_step"] = round(
                pages["pages_walked"] / max(steps, 1), 2)
            row["pages_dense_per_step"] = round(
                pages["pages_walked_dense"] / max(steps, 1), 2)
        rows.append(row)
        print(",".join(str(row.get(k, "")) for k in (
            "path", "family", "tokens_per_s", "p50_ms", "p95_ms",
            "gen_tokens", "steps", "wall_s", "pages_walked_per_step",
            "pages_dense_per_step", "layers")))

    # bursty multi-tenant trace: reservation vs optimistic+preemption on
    # an identical undersized pool
    for row in bench_burst(as_servable(model, params), n_tenants=4,
                           prompt_len=8, max_new=8 if args.smoke else 16,
                           page_size=8, vocab=cfg.vocab):
        rows.append(row)
        print(",".join(str(row[k]) for k in row))

    # tiered-paging trace: swap-to-host vs recompute-by-replay under the
    # same pressure
    for row in bench_swap(as_servable(model, params), vocab=cfg.vocab):
        rows.append(row)
        print(",".join(str(row[k]) for k in row))

    # shared-prefix multi-turn trace: radix cache off vs on
    for row in bench_prefix(as_servable(model, params), vocab=cfg.vocab):
        rows.append(row)
        print(",".join(str(row[k]) for k in row))

    # attention data path in isolation: the slab round trip vs the
    # block-table-native kernel walk over the identical page pool
    seq_len, iters = (64, 3) if args.smoke else (512, 20)
    for row in bench_attn_data_path(cfg, page_size=16, slots=4,
                                    seq_len=seq_len, iters=iters,
                                    device=device):
        rows.append(row)
        print(",".join(str(row[k]) for k in row))

    out = {
        "bench": "serve",
        "device": T.device_record(device),
        "clock": T.clock_name(device),
        "smoke": bool(args.smoke),
        "metrics_schema_version": SCHEMA_VERSION,
        "config": {"arch": "llama3-1b" + ("/reduced" if args.reduced
                                          else ""),
                   "layers": cfg.n_layers, "requests": n_req,
                   "max_new": max_new, "slots": slots, "max_len": max_len,
                   "page_size": page, "prefill_chunk": chunk,
                   "trace_tokens": total},
        "rows": rows,
    }
    _check_schema(rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    history = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            history = json.load(f).get("history", [])
    # trajectory guard: a row stamped with an older telemetry schema than
    # the history's newest means this checkout regressed (or the schema
    # bump was reverted) - refuse to append rather than mix schemas
    newest = max((h.get("metrics_schema_version", 0) for h in history),
                 default=0)
    if out["metrics_schema_version"] < newest:
        raise SystemExit(
            f"refusing to append a metrics_schema_version="
            f"{out['metrics_schema_version']} row to a history whose newest "
            f"is {newest}")
    history.append(out)
    with open(args.out, "w") as f:
        json.dump({"history": history}, f, indent=1)
    print(f"wrote {args.out} ({len(history)} entries)")
    return out


if __name__ == "__main__":
    main()
