"""Serve a PeRQ-quantized model through the paged-KV serving engine.

Quantize with PeRQ*, then run batched requests through
`repro_torch.serve.engine` with the fake-quant model: the online block
Hadamard and the W4A4 fake quantisers live in every forward call, KV rows
live in f32 pages that the paged-attention kernel walks (on a card).

* **Paged KV cache** (`engine.pages`): KV lives in fixed-size pages in one
  shared pool; each sequence holds a block table of page ids, allocated as
  it grows and freed on completion.
* **Continuous batching + chunked prefill** (`engine.scheduler`): prompts
  stream through `forward_chunk` several tokens per step; decodes advance
  every generating sequence in one batched call with per-slot fill
  positions (one captured CUDA graph per variant on a card).
* **Unified adapter** (`engine.adapter`): the same engine serves the bf16
  model, the fake-quant PTQ output (shown here), and the packed-int4
  `QuantizedDenseLM`; `as_servable(model, params)` picks the adapter.
* **Telemetry** (`repro_torch.serve.telemetry`): the engine's counters in
  a versioned, schema-validated snapshot, and an optional `Tracer` that
  records request lifecycles as Chrome Trace JSON for Perfetto.

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--device cpu] [--trace t.json]
"""
import argparse

import numpy as np
import torch

from ..configs.registry import get_config
from ..core import pipeline as PL
from ..core.synthetic import inject_outlier_channels
from ..models.transformer import build_model
from ..serve.engine import (EngineRequest, SamplingParams, ServeEngine,
                            as_servable)
from ..serve.telemetry import Tracer, validate_snapshot


ARCH = "qwen1.5-0.5b"            # served at its reduced() widths
N_PAGES, PAGE_SIZE, MAX_SEQS, PREFILL_CHUNK = 33, 8, 4, 8
MAX_NEW = 8


def quantize(device="cuda"):
    """PeRQ* (b = 16) of the seeded, outlier-injected reduced model on one
    random [4, 128] calibration batch; returns (fake-quant model, params)."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = inject_outlier_channels(model.init(gen))

    rng = np.random.default_rng(1)
    calib = [{"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 128))).to(device)}]
    result = PL.quantize_model(model, params, calib,
                               PL.preset("perq_star", block_size=16))
    return PL.build_quantized_model(model, result), result.params


def serve(qmodel, params, tracer: Tracer | None = None):
    """Runs 6 seeded requests to the end; returns (finished requests,
    engine)."""
    engine = ServeEngine(as_servable(qmodel, params, name="fake-quant"),
                         n_pages=N_PAGES, page_size=PAGE_SIZE,
                         max_seqs=MAX_SEQS, prefill_chunk=PREFILL_CHUNK,
                         tracer=tracer)
    rng = np.random.default_rng(0)
    for rid in range(6):
        prompt = rng.integers(0, qmodel.cfg.vocab,
                              size=rng.integers(3, 9)).tolist()
        engine.submit(EngineRequest(rid=rid, prompt=prompt,
                                    sampling=SamplingParams(max_new=MAX_NEW)))
    return engine.run(), engine


def main(device="cuda", trace_path: str | None = None) -> dict:
    """Serves 6 requests; returns {"done", "engine", "snapshot", "qmodel",
    "params"}."""
    qmodel, params = quantize(device)
    tracer = Tracer()
    done, engine = serve(qmodel, params, tracer)
    print(f"served {len(done)} requests in {engine.n_steps} engine steps "
          f"(paged KV over {engine.kv.allocator.capacity} pages, "
          f"{engine.n_prefill_tokens} prefill + {engine.n_decode_tokens} "
          f"decode tokens)")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid}: prompt {r.prompt} -> generated {r.generated}")

    # the registry snapshot is the one export surface: versioned, validated
    snap = engine.metrics_snapshot()
    validate_snapshot(snap)
    occ = snap["histograms"]["engine.decode.batch_occupancy"]
    print(f"telemetry: schema v{snap['schema_version']}, "
          f"peak pages {snap['gauges']['engine.pages.peak_in_use']:.0f}, "
          f"decode batch occupancy p50 {occ['p50']:.2f}")
    if trace_path:
        tracer.save(trace_path)     # open in https://ui.perfetto.dev
        print(f"trace: {len(tracer.events)} events -> {trace_path}")
    return {"done": done, "engine": engine, "snapshot": snap,
            "qmodel": qmodel, "params": params}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    main(args.device, args.trace)
