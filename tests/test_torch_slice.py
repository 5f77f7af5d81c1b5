"""The ported serving path as a whole, on the CPU: the launcher end to
end for every KV page format, and the port's paged engine against the JAX
package's integer model with the weights carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.synthetic import inject_outlier_channels as jax_inject
from repro.models.transformer import build_model
from repro.serve import quantized as jq
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as cli
from repro_torch.serve.engine import (EngineRequest, SamplingParams,
                                      ServeEngine, as_servable)
from repro_torch.serve.quantized import QuantizedDenseLM

FRAC = 5e-3      # of max|logit|: rounding ties of the activation quantiser


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_launcher_serves_on_the_cpu(kv_bits, capsys, tmp_path):
    argv = ["--arch", "llama3-1b", "--reduced", "--integer-path",
            "--preset", "rtn_only",
            "--device", "cpu", "--block-size", "16", "--requests", "4",
            "--max-new", "4", "--slots", "2", "--prompt-len", "5-20",
            "--prefill-chunk", "8", "--page-size", "8",
            "--metrics-json", str(tmp_path / "m.json")]
    if kv_bits is not None:
        argv += ["--kv-bits", str(kv_bits)]
    result = cli.main(argv)
    out = capsys.readouterr().out
    assert f"integer path (kv_bits={kv_bits}): served 4 requests over 2 slots" in out
    assert sum(line.startswith("req ") and " → " in line
               for line in out.splitlines()) == 4
    assert "summary: 16 tokens in" in out and "tok/s" in out
    assert (tmp_path / "m.json").exists()
    assert all(r.outcome == "length" for r in result["done"])
    alloc = result["engine"].kv.allocator
    assert alloc.in_use == 0 and alloc.n_free == alloc.capacity
    counts = result["snapshot"]["counters"]
    for entry in ("quantize_act", "hadamard_quant", "int4_matmul",
                  "paged_attention"):
        assert counts[f"kernels.dispatch.{entry}.ref"] > 0
        assert f"kernels.dispatch.{entry}.kernels" not in counts


def test_launcher_is_seeded(capsys):
    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--integer-path",
            "--preset", "rtn_only",
            "--device", "cpu", "--requests", "2", "--max-new", "3",
            "--layers", "1"]
    a = [r.generated for r in cli.main(argv)["done"]]
    b = [r.generated for r in cli.main(argv)["done"]]
    c = [r.generated for r in cli.main(argv + ["--seed", "1"])["done"]]
    capsys.readouterr()
    assert a == b and a != c


@pytest.mark.parametrize("arch,family", [
    ("mamba2-1.3b", "ssm"), ("zamba2-1.2b", "hybrid"),
    ("deepseek-moe-16b", "moe"), ("llama4-maverick-400b-a17b", "moe"),
])
def test_launcher_names_the_queue_item_of_what_it_does_not_serve(arch,
                                                                 family):
    """The MoE, SSM and hybrid families serve (ROADMAP A10, see
    `tests/test_torch_families_engine.py`); what the launcher still refuses
    for them is the reference's: the integer path packs dense projections
    only, and the exit names the family."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                  "--integer-path"])
    assert "--integer-path packs dense projections only" in str(e.value)
    assert f"family {family!r}" in str(e.value)


@pytest.mark.parametrize("extra,label", [
    (["--no-quant"], "bf16"),
    ([], "fake-quant"),                             # the default path
    (["--integer-path", "--preset", "perq_star"], "integer path"),
    (["--integer-path", "--legacy-scheduler"], None),
])
def test_launcher_serves_every_mode_on_the_cpu(extra, label, capsys):
    """Every mode of the reference launcher serves on the CPU (the default
    preset is perq_star, as there); the legacy scheduler refuses the
    integer path with the reference's message."""
    argv = ["--arch", "llama3-1b", "--reduced", "--device", "cpu",
            "--block-size", "16", "--requests", "3", "--max-new", "3",
            "--slots", "2"] + extra
    if label is None:
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert "cannot drive the integer path" in str(e.value)
        return
    kops.reset_dispatch_counts()
    result = cli.main(argv)
    out = capsys.readouterr().out
    assert f"{label}" in out and "served 3 requests over 2 slots" in out
    assert ("quantized llama3-1b-smoke with perq_star (b=16)" in out) \
        == ("--no-quant" not in extra)
    assert all(r.outcome == "length" and len(r.generated) == 3
               for r in result["done"])
    counts = kops.dispatch_counts()
    assert counts[("paged_attention", "ref")] > 0
    assert (("int4_matmul", "ref") in counts) == ("--integer-path" in extra)


def test_legacy_scheduler_serves_the_bf16_and_fake_quant_models(capsys):
    """`--legacy-scheduler` drives the bf16 model through the dense slot
    scheduler with the paged engine's greedy tokens, and serves the
    fake-quant model too."""
    argv = ["--arch", "llama3-1b", "--reduced", "--device", "cpu",
            "--layers", "1", "--block-size", "16", "--requests", "3",
            "--max-new", "3", "--slots", "2", "--max-len", "32"]
    legacy = cli.main(argv + ["--no-quant", "--legacy-scheduler"])
    engine = cli.main(argv + ["--no-quant"])
    fake = cli.main(argv + ["--legacy-scheduler"])
    out = capsys.readouterr().out
    assert out.count("legacy scheduler: served 3 requests over 2 slots") == 2
    assert {r.rid: r.generated for r in legacy["done"]} \
        == {r.rid: r.generated for r in engine["done"]}
    assert all(len(r.generated) == 3 for r in fake["done"])


ROBUST_ARGV = ["--arch", "llama3-1b", "--reduced", "--integer-path",
               "--preset", "rtn_only",
               "--device", "cpu", "--layers", "1", "--block-size", "16",
               "--requests", "4", "--max-new", "4", "--slots", "2",
               "--prompt-len", "5-12", "--prefill-chunk", "8",
               "--page-size", "4", "--kv-bits", "4"]


@pytest.mark.parametrize("extra", [
    ["--prefix-cache", "--shared-prefix", "9"],
    ["--swap-host-mb", "4", "--swap-policy", "always"],
    ["--drain-after", "3"],
    ["--admission", "optimistic", "--deadline-s", "600"],
])
def test_launcher_serves_the_robustness_options_on_the_cpu(extra, capsys):
    """The options the JAX launcher has for the engine's robustness serve
    on the CPU: the default admission is optimistic and gives the tokens a
    reserve run gives on the launcher's worst-case pool; the prefix cache
    hits on a shared system prompt; the swap tier is attached (and, the
    pool being worst-case sized, never needed); a drain after 3 steps
    finishes what was admitted, cancels the rest and leaves both tiers
    empty."""
    prompts = extra[extra.index("--shared-prefix"):][:2] \
        if "--shared-prefix" in extra else []
    reserve = cli.main(ROBUST_ARGV + prompts + ["--admission", "reserve"])
    result = cli.main(ROBUST_ARGV + extra)
    out = capsys.readouterr().out
    engine, snap, done = result["engine"], result["snapshot"], result["done"]
    assert engine.admission == ("reserve" if "reserve" in extra
                                else "optimistic")
    assert reserve["engine"].admission == "reserve"
    want = {r.rid: r.generated for r in reserve["done"]}
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert "served 4 requests" in out and "summary:" in out
    alloc = engine.kv.allocator
    tree = engine.prefix_cache
    assert alloc.in_use == (tree.n_pages if tree is not None else 0)
    assert snap["counters"]["engine.preemptions"] == 0
    for r in done:
        if r.outcome == "length":
            assert r.generated == want[r.rid]
        else:
            assert "--drain-after" in extra
            assert r.outcome == "cancelled" and not r.generated
    if "--prefix-cache" in extra:
        assert snap["counters"]["engine.prefix.hits"] > 0
        assert "prefix hit-rate" in out
        assert snap["counters"]["engine.prefill_tokens"] < \
            reserve["snapshot"]["counters"]["engine.prefill_tokens"]
    if "--swap-host-mb" in extra:
        assert engine.kv.host_pool.capacity == \
            4 * 2 ** 20 // engine.kv.page_bytes
        assert snap["gauges"]["engine.swap.host_pages"] == 0
    if "--drain-after" in extra:
        assert engine._draining and alloc.in_use == 0
        assert snap["counters"]["engine.requests.cancelled"] >= 1
        assert engine.kv.host_pool is None
    if "--deadline-s" in extra:
        assert all(r.deadline_s == 600.0 for r in done)
        assert all(r.outcome == "length" for r in done)


def test_launcher_wants_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cli.main(["--arch", "llama3-1b", "--reduced", "--integer-path"])
    assert "no CUDA device" in str(e.value)
    with pytest.raises(SystemExit):
        cli.main(["--arch", "mamba2-1.3b", "--reduced", "--integer-path",
                  "--device", "cpu"])


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_engine_first_tokens_match_the_jax_model(kv_bits):
    """Weights carried across; the port's engine (chunked prefill through
    block tables and the paged attention walk) against the JAX
    `QuantizedDenseLM.prefill` (dense cache, interpret-mode kernels) on the
    same prompts. Per request, the logits the first token was sampled from
    agree within 5e-3 * max|logit| - one request may carry a flipped
    rounding tie from an early layer and is then held to 10 % - and the
    tokens are equal wherever the reference's top-2 gap exceeds the
    bound."""
    cfg = jax_get_config("llama3-1b").reduced()
    params = jax_inject(build_model(cfg).init(jax.random.PRNGKey(0)))
    packed = jq.pack_dense_params(params, cfg)
    jm = jq.QuantizedDenseLM(cfg, block_size=16, kv_bits=kv_bits)
    tcfg = get_config("llama3-1b").reduced()
    tp = interop.params_from_jax(jax.tree.map(np.asarray, packed), "cpu")
    tm = QuantizedDenseLM(tcfg, block_size=16, kv_bits=kv_bits)
    engine = ServeEngine(as_servable(tm, tp), n_pages=3 * 4 + 1, page_size=8,
                         max_seqs=3, prefill_chunk=4, record_logits=True)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 8, 11, 16, 3)]
    for rid, p in enumerate(prompts):
        engine.submit(EngineRequest(rid=rid, prompt=p,
                                    sampling=SamplingParams(max_new=2)))
    done = {r.rid: r for r in engine.run()}
    engine.check_books()
    off = 0
    for rid, p in enumerate(prompts):
        logits, _ = jm.prefill(packed, jnp.asarray([p], jnp.int32),
                               jm.init_cache(1, 16))
        want = np.asarray(logits[0, -1], np.float32)
        got = done[rid].step_logits[0]
        top = np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= 0.1 * top
        if err > FRAC * top:
            off += 1
            continue
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > 2 * FRAC * top:
            assert done[rid].generated[0] == int(np.argmax(want))
    assert off <= 1
