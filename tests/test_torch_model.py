"""The port's bf16 / fake-quant `Model` against the JAX package's, with the
JAX parameters carried across: full-sequence forward (with and without PTQ
hooks), prefill and decode on the dense cache (scalar and per-slot index),
the paged `forward_chunk` over a page pool, and `DenseModelAdapter`
through the paged engine. Reduced configs, f32, inputs from numpy with a
seed.

Tolerance: 1e-5 of max|logit| (f32, other summation orders). The JAX
paged path cannot run on this JAX (the Pallas kernel needs a TPU compiler
parameter this version lacks, and its plain version raises), so the port's
paged logits are held against the JAX dense-cache `forward_chunk` and the
engine's tokens against the JAX `Model.forward`, teacher-forced.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import hadamard as JH
from repro.core import quantizers as JQ
from repro.core.synthetic import inject_outlier_channels as jax_inject
from repro.models.transformer import build_model as jax_build
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.core import hadamard as TH
from repro_torch.core import quantizers as TQ
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import (DenseModelAdapter, EngineRequest,
                                      SamplingParams, ServeEngine,
                                      as_servable)

FRAC = 1e-5          # of max|logit|
TOKEN_LMS = ["llama3-1b", "qwen1.5-0.5b"]
ARCHS = TOKEN_LMS + ["internvl2-2b", "hubert-xlarge"]


def jax_hooks():
    spec = JQ.QuantSpec()
    return {"act_in": lambda x, tag: JQ.quantize_act(x, spec),
            "down_proj_fn": lambda h, w: JQ.quantize_act(
                JH.block_hadamard_transform(h, 16), spec) @ w}


def torch_hooks():
    spec = TQ.QuantSpec()
    return {"act_in": lambda x, tag: TQ.quantize_act(x, spec),
            "down_proj_fn": lambda h, w: TQ.quantize_act(
                TH.block_hadamard_transform(h, 16), spec) @ w}


def batch_for(cfg, rng, b, s):
    batch = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.standard_normal((b, s, 512)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.standard_normal((b, 4, 1024)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def carried(name):
    """The JAX model, its params (outliers injected where the family has
    an RMSNorm stream) and the port's model with the params carried
    across."""
    jcfg = jax_get_config(name).reduced()
    jm = jax_build(jcfg)
    p = jm.init(jax.random.PRNGKey(0))
    if jcfg.norm == "rmsnorm":
        p = jax_inject(p)
    tcfg = get_config(name).reduced()
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    return jcfg, jm, p, build_model(tcfg), tp


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return carried(request.param)


@pytest.fixture(scope="module", params=TOKEN_LMS)
def token_lm(request):
    """The causal token LMs (no frontend), which prefill, decode and page."""
    return carried(request.param)


def close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= FRAC * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("hooked", [False, True])
def test_forward_matches_the_jax_model(arch, hooked):
    jcfg, jm, p, tm, tp = arch
    batch = batch_for(jcfg, np.random.default_rng(1), 2, 12)
    if hooked:
        jm = jax_build(jcfg, quant_hooks=jax_hooks())
        tm = build_model(tm.cfg, quant_hooks=torch_hooks())
    want = jax.jit(jm.forward)(p, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tm.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    close(got, want)


def test_dense_cache_prefill_and_decode_match_the_jax_model(token_lm):
    jcfg, jm, p, tm, tp = token_lm
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab, (2, 7)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab, (2, 3)).astype(np.int32)
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    tc = tm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    want, jc = jax.jit(jm.prefill)(p, {"tokens": jnp.asarray(prompt)}, jc)
    got, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, tc)
    close(got, want)
    step = jax.jit(jm.decode_step)
    for i in range(3):                          # scalar index, lockstep
        tok = nxt[:, i:i + 1]
        want, jc = step(p, jnp.asarray(tok), jc, jnp.asarray(7 + i, jnp.int32))
        got, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, 7 + i)
        close(got, want)
    # per-slot index: the rows at different fill positions
    idx = np.array([10, 4], np.int32)
    tok = nxt[:, :1]
    want, _ = step(p, jnp.asarray(tok), jc, jnp.asarray(idx))
    got, _ = tm.decode_step(tp, torch.from_numpy(tok), tc,
                            torch.from_numpy(idx))
    close(got, want)


def test_paged_forward_chunk_matches_the_jax_dense_cache(token_lm):
    """Chunked prefill and a per-slot decode step through a page pool
    (rows scattered into their pages, attention walking the table) give
    the logits of the JAX model's dense-cache `forward_chunk`."""
    jcfg, jm, p, tm, tp = token_lm
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 11)).astype(np.int32)
    t, n_pages = 4, 9
    pool = tm.init_paged_state(n_pages, t, 0, dtype=torch.float32,
                               device="cpu")["kv"]
    bt = torch.tensor([[3, 7, 1, 5], [2, 8, 4, 6]], dtype=torch.int32)
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    fc = jax.jit(jm.forward_chunk)
    for start, stop in ((0, 4), (4, 10)):
        chunk = toks[:, start:stop]
        want, jc = fc(p, jnp.asarray(chunk), jc, jnp.asarray(start, jnp.int32))
        lens = torch.full((2,), stop, dtype=torch.int32)
        got, _ = tm.forward_chunk(tp, torch.from_numpy(chunk), pool, start,
                                  bt, lens)
        close(got, want)
    idx = np.array([10, 10], np.int32)
    want, _ = fc(p, jnp.asarray(toks[:, 10:]), jc, jnp.asarray(idx))
    got, _ = tm.forward_chunk(tp, torch.from_numpy(toks[:, 10:]), pool,
                              torch.from_numpy(idx), bt,
                              torch.full((2,), 11, dtype=torch.int32))
    close(got, want)


def test_dense_model_adapter_serves_the_jax_models_greedy_tokens():
    """bf16 and fake-quant `Model`s through `ServeEngine` (chunked prefill,
    f32 pages): the logits each token was taken from agree with the JAX
    `Model.forward` over the whole sequence (teacher-forced) within
    1e-5 of max|logit|, and the tokens are its argmax wherever the top-2
    gap exceeds twice that."""
    jcfg = jax_get_config("llama3-1b").reduced()
    p = jax_inject(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    tcfg = get_config("llama3-1b").reduced()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab, n).tolist() for n in (5, 9, 3)]
    for hooked in (False, True):
        jm = jax_build(jcfg, quant_hooks=jax_hooks() if hooked else None)
        tm = build_model(tcfg, quant_hooks=torch_hooks() if hooked else None)
        adapter = as_servable(tm, tp, name="fake-quant" if hooked else "bf16")
        assert isinstance(adapter, DenseModelAdapter)
        engine = ServeEngine(adapter, n_pages=3 * 4 + 1, page_size=4,
                             max_seqs=2, prefill_chunk=4, record_logits=True)
        for rid, pr in enumerate(prompts):
            engine.submit(EngineRequest(rid=rid, prompt=pr,
                                        sampling=SamplingParams(max_new=3)))
        done = {r.rid: r for r in engine.run()}
        engine.check_books()
        fwd = jax.jit(jm.forward)
        for rid, pr in enumerate(prompts):
            r = done[rid]
            seq = np.asarray([pr + r.generated], np.int32)
            want = np.asarray(fwd(p, {"tokens": jnp.asarray(seq)}))[0]
            for j, got in enumerate(r.step_logits):
                row = want[len(pr) - 1 + j]
                top = np.abs(row).max()
                assert np.abs(got - row).max() <= FRAC * top
                top2 = np.sort(row)[-2:]
                if top2[1] - top2[0] > 2 * FRAC * top:
                    assert r.generated[j] == int(np.argmax(row))
