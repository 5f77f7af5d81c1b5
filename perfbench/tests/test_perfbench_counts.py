"""The work and byte counts against a hand count of one decode step and
one prefill chunk of each configuration."""
import pytest

from perfbench.harness import counts, spec
from perfbench.harness.cell import StepRecord

BENCH = spec.load_benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _family(name):
    return spec.family(spec.config(BENCH, name))


def _dims(name):
    return _family(name).dims(spec.config(BENCH, name))


def _params(m):
    d, f, h, kv, dh = (m["d_model"], m["d_ff"], m["n_heads"],
                       m["n_kv_heads"], m["head_dim"])
    return d * (h + 2 * kv) * dh + h * dh * d + 3 * d * f


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_step(name):
    m = _dims(name)
    ctx = [100, 2000, 6000]
    w = _family(name).step_work(m, StepRecord(0, 1, ctx, []))
    n = m["n_layers"]
    # projections: 2 ops per weight per row; int4 weights read once
    assert w["proj"][0] == 2 * 3 * _params(m) * n
    weight_bytes = _params(m) / 2 * n
    assert weight_bytes < w["proj"][1] < 1.1 * weight_bytes
    # attention: every key of every row, K and V as int4 + f32 scale, zero
    keys = sum(ctx)
    assert w["attn"][0] == 4 * m["n_heads"] * m["head_dim"] * keys * n
    kv = 2 * keys * m["n_kv_heads"] * (m["head_dim"] / 2 + 8) * n
    q_out = 2 * 3 * m["n_heads"] * m["head_dim"] * 2 * n
    assert w["attn"][1] == kv + q_out
    # decode is bound by bytes
    assert w["attn"][2] == pytest.approx(w["attn"][1] / counts.HBM_BYTES_PER_S)
    assert w["head"][0] == 2 * 3 * m["d_model"] * m["vocab"]


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_chunk(name):
    m = _dims(name)
    start, real = 1024, 1000
    step_work = _family(name).step_work
    w = step_work(m, StepRecord(0, 1, [], [(start, real, True)]))
    n = m["n_layers"]
    assert w["proj"][0] == 2 * real * _params(m) * n
    # causal: query i sees start + i + 1 keys; padding does not count
    keys = sum(start + i + 1 for i in range(real))
    assert w["attn"][0] == 4 * m["n_heads"] * m["head_dim"] * keys * n
    assert w["head"][0] == 2 * m["d_model"] * m["vocab"]   # last row only
    # a chunk that does not complete its prompt needs no logits
    w2 = step_work(m, StepRecord(0, 1, [], [(0, real, False)]))
    assert w2["head"][0] == 0
    assert w["ideal_s"] == pytest.approx(
        w["proj"][0] / counts.INT8_OPS_PER_S
        + (w["attn"][0] + w["head"][0]) / counts.BF16_FLOPS_PER_S)


def test_padding():
    assert [counts.next_pow2(n) for n in (1, 2, 3, 64, 65, 2047, 2048)] \
        == [1, 2, 4, 64, 128, 2048, 2048]
