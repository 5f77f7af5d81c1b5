"""The correctness check at a size a CPU holds: the reference passes the
program's integer path (its plain versions on the CPU) and fails it with
the timed path broken underneath. These drive the whole run but the look
for a card: weights, PTQ, packing, engine, warm-up, closed loop, window,
sample and reference."""
import time

import pytest
import torch

from perfbench.harness import spec
from perfbench.harness.cell import run_cell
from perfbench.harness.traffic import Traffic

BENCH = spec.load_benchmark()
CELL = "qwen1.5-0.5b.longctx"


def small_config(dtype: str) -> dict:
    """qwen1.5-0.5b's configuration at the program's `.reduced()` size."""
    cfg = spec.config(BENCH, "qwen1.5-0.5b-w4a4")
    cfg.update(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=4, head_dim=32,
               vocab_size=512, torch_dtype=dtype)
    return cfg


def small_granite() -> dict:
    """granite-3-2b's configuration (its four multipliers, its eps) at a
    tiny size."""
    cfg = spec.config(BENCH, "granite-3-2b-w4a4")
    cfg.update(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=32,
               vocab_size=512, torch_dtype="float32")
    return cfg


TRAFFIC = Traffic.from_dict(dict(
    clients=4, prompt_tokens=[5, 40], output_tokens=[6, 14], page_size=16,
    prefill_chunk=32, settle_steps=2, sample_requests=3, trace_steps=2))


def run(dtype="float32", seed=2**33 + 5, control=False, cfg=None,
        cell=CELL):
    return run_cell(cfg or small_config(dtype), TRAFFIC, seed=seed,
                    seconds=1.0, trace=False, device="cpu",
                    t_start=time.perf_counter(), limits=spec.limits(cell),
                    control=control)


def numbers(out):
    return {k: c["value"] for k, c in out["checks"].items()
            if k not in ("short_outputs", "failed_requests")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_passes(dtype):
    out = run(dtype)
    assert out["correct"], out["checks"]
    assert out["check"]["positions"] >= 40
    assert out["check"]["served_tokens"] >= 1
    # the plain versions compute what the reference computes
    assert set(numbers(out)) == {"kv_mismatch.layer0", "kv_far.layer1",
                                 "head_rank.median"}
    assert max(numbers(out).values()) <= 1e-3


def _kv_writes_dropped(monkeypatch):
    from repro_torch.serve.quantized import QuantizedDenseLM
    monkeypatch.setattr(QuantizedDenseLM, "_paged_cache_write",
                        lambda self, cache, *a, **k: cache)


def _half_the_batch(monkeypatch):
    """A decode step that computes only the first half of its rows."""
    from repro_torch.serve.quantized import QuantizedDenseLM
    orig = QuantizedDenseLM.forward_chunk

    def forward_chunk(self, params, tokens, cache, index, block_table=None,
                      seq_lengths=None, **k):
        b = tokens.shape[0]
        if b == 1:
            return orig(self, params, tokens, cache, index, block_table,
                        seq_lengths, **k)
        h = b // 2
        lg, cache = orig(self, params, tokens[:h], cache, index[:h],
                         block_table[:h], seq_lengths[:h], **k)
        return torch.cat([lg, torch.zeros_like(lg)]), cache
    monkeypatch.setattr(QuantizedDenseLM, "forward_chunk", forward_chunk)


def _attention_left_out(monkeypatch):
    """Paged attention that returns zeros (prefill chunks and decode steps
    alike)."""
    from repro_torch.kernels import ops
    orig = ops.paged_attention
    monkeypatch.setattr(ops, "paged_attention",
                        lambda *a, **k: torch.zeros_like(orig(*a, **k)))


def _token_altered(monkeypatch):
    """Every token altered where the engine picks it."""
    from repro_torch.serve.engine import scheduler
    orig = scheduler._pick_tokens

    def pick(lg, *a, **k):
        out = orig(lg, *a, **k)
        out[0] = (out[0] + 1) % lg.shape[-1]
        return out
    monkeypatch.setattr(scheduler, "_pick_tokens", pick)


@pytest.mark.parametrize("fault, caught_by", [
    (_kv_writes_dropped, "kv_mismatch.layer0"),
    (_half_the_batch, "kv_mismatch.layer0"),
    (_attention_left_out, "kv_far.layer1"),
    (_token_altered, "head_rank.median")],
    ids=["state_unchanged", "half_the_batch", "attention_wrong",
         "token_altered"])
def test_broken_path_is_not_correct(fault, caught_by, monkeypatch):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]
    assert out["checks"][caught_by]["value"] \
        > out["checks"][caught_by]["limit"], out["checks"]


GRANITE_CELL = "granite-3-2b.prefill"


def test_granite_limits_pass():
    out = run(cfg=small_granite(), cell=GRANITE_CELL)
    assert out["correct"], out["checks"]
    assert set(numbers(out)) == {"kv_mismatch.layer0", "kv_far.layer1"}
    assert max(numbers(out).values()) <= 1e-3


@pytest.mark.parametrize("fault, caught_by", [
    (_kv_writes_dropped, "kv_mismatch.layer0"),
    (_half_the_batch, "kv_mismatch.layer0"),
    (_attention_left_out, "kv_far.layer1")],
    ids=["state_unchanged", "half_the_batch", "attention_wrong"])
def test_broken_path_fails_granite_limits(fault, caught_by, monkeypatch):
    """Granite's cell compares no head (`PERF.md` section 2): a token
    altered where it is picked is the one fault it cannot see."""
    fault(monkeypatch)
    out = run(cfg=small_granite(), cell=GRANITE_CELL)
    assert not out["correct"], out["checks"]
    assert out["checks"][caught_by]["value"] \
        > out["checks"][caught_by]["limit"], out["checks"]


def test_control_is_not_correct():
    """The control: the reference itself in fp8 (the precision below the
    configuration's bf16) in the program's place fails a limit."""
    out = run("bfloat16", seed=2**31 + 9, control=True)
    lims = spec.limits(CELL).limit_of()
    assert any(out["check"]["control"][k] > lim for k, lim in lims.items())
