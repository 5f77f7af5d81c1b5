"""Serving launcher: quantise seeded weights with the paper's PTQ pipeline,
then serve them through the paged-KV continuous-batching engine.

    python -m repro_torch.launch.serve --arch llama3-1b --preset perq_star \\
        --block-size 16 [--integer-path --kv-bits 4 | --no-quant]

Runs on a CUDA device by default (`--device cpu` for a CPU run; with
`--device cuda` and no card it exits non-zero). The weights are freshly
initialised from a seeded generator and given LLM-like outlier channels;
unless `--no-quant`, `core.pipeline.quantize_model` then quantises them
with `--preset` (every preset of the reference, `perq_star` by default),
calibrated on one [4, 128] token batch drawn from
`numpy.random.default_rng(seed + 1)`. Three paths serve through the same
engine: the fake-quant model (the default: the `Model` with the PTQ hooks,
f32 KV pages), the bf16 model (`--no-quant`), and the packed-int4 integer
path (`--integer-path`, dense archs, optional `--kv-bits {4,8}` integer KV
pages), which packs the PTQ result. `--legacy-scheduler` serves the bf16 or
fake-quant model through the dense-slot `serve.step.BatchScheduler`
instead (attention-cache families only, as the reference). Every
decode-capable token-LM family serves: dense, MoE (its routed experts
ride inside the forward), SSM (Mamba2: fixed-size register slots, no kv
pages) and hybrid (Zamba2: register slots and the shared attention block's
kv pages). `--layers N` cuts the depth.

The engine options are the JAX launcher's: `--admission` (`optimistic`, the
default, or `reserve`), `--deadline-s`, `--prefix-cache` /
`--prefix-cache-pages` (with `--shared-prefix N` to give every prompt the
same N-token system prompt), `--swap-host-mb` / `--swap-policy` and
`--drain-after N` (after N engine steps stop admission and drain). The pool
is sized for every slot's worst case, so the launcher itself never
preempts.

Observability, as in the JAX launcher: `--metrics-json PATH` writes the
engine's schema-validated registry snapshot, `--trace PATH` records request
lifecycles and each forward as Chrome Trace JSON (open in
https://ui.perfetto.dev), and `--probe-every K` samples the rotation-quality
activation probes every K decode forwards (integer path). Both files pass
`python -m repro_torch.serve.telemetry.check m.json --trace t.json`.

Every engine run ends with `served N requests...`, one `req i: prompt ->
tokens` line per request and a one-line `summary:` from the engine's
metrics registry (and a `quality:` line when probes ran).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config
from ..core import pipeline as PL
from ..core.synthetic import inject_outlier_channels
from ..models.transformer import build_model
from ..serve.engine import (EngineRequest, SamplingParams, ServeEngine,
                            as_servable, derive_state_spec, pages_for)
from ..serve.quantized import QuantizedDenseLM, pack_dense_params
from ..serve.step import BatchScheduler, Request
from ..serve.telemetry import (QualityProbes, Tracer, validate_snapshot,
                               validate_trace)

CALIB_SHAPE = (4, 128)      # the reference launcher's calibration batch


def _ms(v) -> str:
    return "n/a" if v is None else f"{v * 1e3:.1f}ms"


def summary_line(snap: dict) -> str:
    """One-line end-of-run summary from a registry snapshot."""
    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
    toks = c["engine.generated_tokens"]
    wall = h["engine.step.wall_s"]["sum"]
    lat = h["engine.decode.token_latency_s"]
    wait = h["engine.admission.wait_s"]
    out = (f"summary: {toks} tokens in {wall:.2f}s engine time "
           f"({toks / max(wall, 1e-9):.1f} tok/s) | "
           f"token latency p50 {_ms(lat['p50'])} p95 {_ms(lat['p95'])} | "
           f"peak pages {g['engine.pages.peak_in_use']:.0f}"
           f"/{g['engine.pages.capacity']:.0f} "
           f"({g['engine.pages.utilization_peak']:.0%} peak util)")
    if "engine.register_slots.peak_in_use" in g:
        out += (f" | peak slots {g['engine.register_slots.peak_in_use']:.0f}"
                f"/{g['engine.register_slots.capacity']:.0f}")
    lookups = c["engine.prefix.hits"] + c["engine.prefix.misses"]
    if lookups:
        out += (f" | prefix hit-rate "
                f"{c['engine.prefix.hits'] / lookups:.0%} "
                f"({c['engine.prefix.hit_tokens']} tokens, "
                f"{c['engine.prefix.cow_copies']} COW)")
    if c["engine.swap.out"] or c["engine.swap.in"] or c["engine.swap.fallbacks"]:
        out += (f" | swap out {c['engine.swap.out']} "
                f"in {c['engine.swap.in']} "
                f"({c['engine.swap.bytes'] / 2**20:.1f} MiB, "
                f"{c['engine.swap.retries']} retries, "
                f"{c['engine.swap.fallbacks']} fallbacks)")
    out += (f" | preempt {c['engine.preemptions']} "
            f"cancel {c['engine.requests.cancelled']} "
            f"expire {c['engine.requests.expired']} "
            f"fail {c['engine.requests.failed']}")
    return out + f" | admission wait p95 {_ms(wait['p95'])}"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", "--model", dest="arch",
                    default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="cut the model to its first N layers (widths "
                    "unchanged)")
    ap.add_argument("--preset", default="perq_star",
                    choices=sorted(PL.PRESETS))
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", default="3-8", metavar="LO-HI",
                    help="prompt lengths are drawn uniformly from [LO, HI]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k most likely tokens "
                    "(0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 disables)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--integer-path", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[4, 8])
    ap.add_argument("--no-quant", action="store_true",
                    help="serve the bf16 model instead")
    ap.add_argument("--legacy-scheduler", action="store_true",
                    help="use the dense-slot BatchScheduler (no paging)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the schema-validated engine metrics "
                    "snapshot as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a Chrome Trace Event JSON (Perfetto)")
    ap.add_argument("--probe-every", type=int, default=0, metavar="K",
                    help="sample rotation-quality activation probes every "
                    "K decode dispatches (integer path only; 0 disables)")
    ap.add_argument("--admission", default="optimistic",
                    choices=["optimistic", "reserve"],
                    help="admission policy: optimistic (prompt pages + "
                    "headroom, preemption-backed) or reserve (worst-case "
                    "pages up front, never preempts)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request TTL in seconds, enforced at step "
                    "boundaries (expired requests return their pages)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the prefix-sharing radix cache "
                    "(refcounted copy-on-write KV pages)")
    ap.add_argument("--prefix-cache-pages", type=int, default=None,
                    metavar="N", help="LRU budget of pool pages the radix "
                    "tree may hold (default: unbounded - pressure evicts)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend the same N-token system prompt to every "
                    "request (exercises the prefix cache)")
    ap.add_argument("--swap-host-mb", type=float, default=None, metavar="MB",
                    help="attach a host KV swap tier of this many MiB: "
                    "under page pressure the engine may swap a victim's "
                    "pages to host instead of preempting it for recompute")
    ap.add_argument("--swap-policy", default="cost",
                    choices=["never", "cost", "always"],
                    help="when to prefer swap over recompute-by-replay "
                    "under pressure: cost-model the round-trip bytes vs "
                    "replayed tokens (default), always swap, or never")
    ap.add_argument("--drain-after", type=int, default=None, metavar="N",
                    help="after N engine steps stop admission and drain: "
                    "never-admitted requests cancel, in-flight work "
                    "(swapped residents included) finishes, and the engine "
                    "asserts every tier came back empty")
    return ap


def _refuse(args, cfg):
    """Exit with one line for a combination the launcher does not serve:
    the reference's refusals."""
    if args.probe_every and not args.integer_path:
        raise SystemExit("--probe-every needs --integer-path: the probes "
                         "read the fused rotate+quantize site")
    if args.integer_path and cfg.family not in ("dense", "vlm"):
        raise SystemExit(f"--integer-path packs dense projections only; "
                         f"{cfg.name} is family {cfg.family!r}")
    if args.legacy_scheduler:
        if args.integer_path:
            raise SystemExit("--legacy-scheduler cannot drive the integer "
                             "path; the paged engine serves it")
        if args.metrics_json or args.trace:
            raise SystemExit("--metrics-json/--trace instrument the paged "
                             "engine; drop --legacy-scheduler")
        if args.top_k > 0 or args.top_p < 1.0:
            raise SystemExit("--legacy-scheduler has no top-k/top-p "
                             "support; drop the flags or use the engine")
        if args.prefix_cache:
            raise SystemExit("--prefix-cache is a paged-engine feature; "
                             "drop --legacy-scheduler")
        if args.swap_host_mb is not None or args.drain_after is not None:
            raise SystemExit("--swap-host-mb/--drain-after are paged-"
                             "engine features; drop --legacy-scheduler")
    else:
        try:
            derive_state_spec(cfg)
        except ValueError as e:
            raise SystemExit(str(e))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for a CPU run)")
    device = torch.device(args.device)
    try:
        lo, hi = (int(v) for v in args.prompt_len.split("-"))
    except ValueError:
        raise SystemExit(f"--prompt-len wants LO-HI, got {args.prompt_len!r}")
    if not 1 <= lo <= hi:
        raise SystemExit("--prompt-len wants 1 <= LO <= HI")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=args.layers).validate()
    _refuse(args, cfg)

    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = inject_outlier_channels(model.init(gen))
    if args.no_quant:
        smodel, sparams = model, params
    else:
        crng = np.random.default_rng(args.seed + 1)
        tokens = torch.from_numpy(crng.integers(0, cfg.vocab, CALIB_SHAPE))
        res = PL.quantize_model(
            model, params, [{"tokens": tokens.to(device)}],
            PL.preset(args.preset, block_size=args.block_size,
                      cayley_steps=8))
        smodel, sparams = PL.build_quantized_model(model, res), res.params
        print(f"quantized {cfg.name} with {args.preset} "
              f"(b={args.block_size}) on {device}")
    del params

    rng = np.random.default_rng(args.seed)
    system = rng.integers(0, cfg.vocab, size=args.shared_prefix).tolist()
    prompts = [system + rng.integers(
        0, cfg.vocab, size=int(rng.integers(lo, hi + 1))).tolist()
        for _ in range(args.requests)]

    if args.legacy_scheduler:
        sched = BatchScheduler(smodel, sparams, slots=args.slots,
                               max_len=args.max_len,
                               temperature=args.temperature, seed=args.seed)
        for rid, prompt in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=prompt,
                                 max_new=args.max_new))
        done = sched.run()
        print(f"legacy scheduler: served {len(done)} requests over "
              f"{args.slots} slots")
        for r in sorted(done, key=lambda r: r.rid):
            print(f"req {r.rid}: {r.prompt} → {r.generated}")
        return {"done": done, "scheduler": sched}

    if args.integer_path:
        qlm = QuantizedDenseLM(cfg, block_size=args.block_size,
                               kv_bits=args.kv_bits)
        adapter = as_servable(qlm, pack_dense_params(sparams, cfg))
        del sparams
        label = f"integer path (kv_bits={args.kv_bits})"
    else:
        label = "bf16" if args.no_quant else "fake-quant"
        adapter = as_servable(smodel, sparams, name=label)

    # enough pool for every slot to hold its worst-case sequence (the larger
    # of --max-len and the longest prompt + --max-new, which is what
    # admission reserves), plus the reserved scratch page
    per_seq = max([pages_for(args.max_len, args.page_size)]
                  + [pages_for(len(p) + args.max_new, args.page_size)
                     for p in prompts])
    n_pages = args.slots * per_seq + 1
    tracer = Tracer() if args.trace else None
    probes = QualityProbes(every_k=args.probe_every) if args.probe_every \
        else None
    engine = ServeEngine(adapter, n_pages=n_pages, page_size=args.page_size,
                         max_seqs=args.slots,
                         prefill_chunk=args.prefill_chunk,
                         admission=args.admission, seed=args.seed,
                         deadline_s=args.deadline_s,
                         max_context=max(args.max_len,
                                         per_seq * args.page_size),
                         prefix_cache=args.prefix_cache,
                         prefix_cache_pages=args.prefix_cache_pages,
                         swap_host_mb=args.swap_host_mb,
                         swap_policy=args.swap_policy,
                         tracer=tracer, quality_probes=probes)
    for rid, prompt in enumerate(prompts):
        engine.submit(EngineRequest(
            rid=rid, prompt=prompt,
            sampling=SamplingParams(temperature=args.temperature,
                                    max_new=args.max_new,
                                    top_k=args.top_k, top_p=args.top_p)))
    if args.drain_after is not None:
        done = []
        while (engine.queue or engine.active) \
                and engine.n_steps < args.drain_after:
            done.extend(engine.step())
        done.extend(engine.drain())
    else:
        done = engine.run()
    engine.check_books()
    print(f"{label}: served {len(done)} requests over {args.slots} slots "
          f"in {engine.n_steps} engine steps "
          f"({engine.n_prefill_tokens} prefill + "
          f"{engine.n_decode_tokens} decode tokens)")
    for r in sorted(done, key=lambda r: r.rid):
        mark = "" if r.outcome in ("length", "stop") else f" [{r.outcome}]"
        print(f"req {r.rid}: {r.prompt} → {r.generated}{mark}")

    snap = engine.metrics_snapshot()
    validate_snapshot(snap)     # never write an off-schema artifact
    print(summary_line(snap))
    if probes is not None:
        imb = snap["histograms"]["quality.l1_imbalance_post"]
        print(f"quality: post-rotation l1 imbalance p50 {imb['p50']:.3f} "
              f"over {imb['count']} layer observations "
              f"({snap['counters']['quality.probe_dispatches']} probed "
              "dispatches)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=1)
        print(f"metrics snapshot → {args.metrics_json}")
    if tracer is not None:
        validate_trace(tracer.to_dict())
        tracer.save(args.trace)
        print(f"trace ({len(tracer.events)} events) → {args.trace}")
    return {"done": done, "engine": engine, "snapshot": snap}


if __name__ == "__main__":
    main()
