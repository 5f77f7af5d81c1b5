"""The port's examples (`repro_torch.examples`) at their own reduced sizes
on the CPU: the quickstart reports a finite error; the served example
gives every request its tokens, a valid telemetry snapshot, and the same
tokens when its quantized model is served again; `quantize_llm` trains
through the driver and prints a finite perplexity per pipeline, its bf16
perplexity that of the JAX package's example's protocol (its driver, step
and evaluation, on the same initial parameters) within 1e-4.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import DataConfig, SyntheticCorpus, batch_iterator
from repro.models.transformer import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.runtime.driver import RuntimeConfig, TrainDriver
from repro.train.step import TrainConfig, make_train_step
from repro_torch.examples import quantize_llm, quickstart, serve_quantized


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module; the worker's own
    setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_main(capsys):
    err = quickstart.main(device="cpu")
    assert math.isfinite(err) and err > 0
    assert "MassDiff" in capsys.readouterr().out


def test_serve_quantized_main_then_serve_again(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    out = serve_quantized.main(device="cpu", trace_path=str(trace))
    done = {r.rid: r.generated for r in out["done"]}
    assert sorted(done) == list(range(6))
    assert all(len(g) == serve_quantized.MAX_NEW for g in done.values())
    assert out["snapshot"]["counters"]
    assert trace.exists()
    again, _ = serve_quantized.serve(out["qmodel"], out["params"])
    assert {r.rid: r.generated for r in again} == done
    assert "served 6 requests" in capsys.readouterr().out


def reference_bf16_ppl(params, steps, eval_batches, workdir):
    """`examples/quantize_llm.py`'s training and bf16 evaluation, through
    the JAX package, from `params` (numpy)."""
    cfg = jax_get_config("llama3-1b").reduced(**quantize_llm.SURROGATE)
    model = jax_build(cfg)
    params = jax.tree.map(jax.numpy.asarray, params)
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    opt_cfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    opt = jadamw.init_state(opt_cfg, params)
    step = jax.jit(make_train_step(model, opt_cfg, TrainConfig(remat=False)))
    mgr = JCkpt(str(workdir), keep=2)
    mgr.save(0, {"params": params, "opt": opt}, blocking=True)
    driver = TrainDriver(step, mgr, RuntimeConfig(checkpoint_every=100))
    it = batch_iterator(corpus, DataConfig(cfg.vocab, 64, 16))
    (params, opt), _ = driver.run(params, opt, it, num_steps=steps)
    ev = jax.jit(lambda pp, b: model.loss_fn(pp, b)[1]["nll"])
    eit = batch_iterator(corpus, DataConfig(cfg.vocab, 64, 16, seed=999))
    tot = sum(float(ev(params, next(eit))) for _ in range(eval_batches))
    return math.exp(tot / eval_batches)


def test_quantize_llm_main(tmp_path, capsys):
    out = quantize_llm.main(["--steps", "3", "--eval-batches", "1",
                             "--device", "cpu", "--workdir",
                             str(tmp_path / "torch")])
    text = capsys.readouterr().out
    assert sorted(out["ppl"]) == sorted(quantize_llm.PIPELINES)
    for name, v in out["ppl"].items():
        assert math.isfinite(v) and v > 1, name
        assert name in text
    assert "bf16 perplexity" in text
    assert (tmp_path / "torch" / "ckpt" / "step_000000003").is_dir()
    _, _, params, _ = quantize_llm.surrogate("cpu")
    want = reference_bf16_ppl(jax.tree.map(lambda t: t.numpy(), params),
                              3, 1, tmp_path / "jax")
    np.testing.assert_allclose(out["bf16"], want, rtol=1e-4)
