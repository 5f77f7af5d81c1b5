"""The paper's harnesses in the port (`repro_torch.paper`) against the JAX
package's (`benchmarks/`), on a surrogate the reference trains for a few
steps here (its `bench_model` steps rebuilt inline: the reference's own
caches under `artifacts/bench_model/`, which no test writes), carried
across as numpy.

Tolerances: Tables 3/4 line for line; held-out perplexity rel 1e-5 (f32);
PTQ + perplexity with RTN rel 1e-3, its weights on the reference's grid
points but at rounding ties (<= 0.1 %): the rest is the fake-quant
forward, whose int4 activation quantiser can flip a rounding tie per token
row (an almost untrained surrogate, 3 steps, lands at 1.5e-3 with equal
weights); with Qronos rel 1e-2 and every leaf at most half off the
reference's grid points (Qronos is chaotic in the last bits of its inputs,
and on the port's result about a third of some leaf's entries are off).
On this 8-step surrogate perplexity alone tells little: a planted
identity permutation lands within 1 % of the reference's perplexity. The
grid points tell faults apart: each planted fault below puts some leaf
more than half off. The captured down-projection inputs within 1e-5 of
their largest magnitude. Every harness's `main` at a tiny size:
`tests/test_torch_paper_mains.py`.
"""
import contextlib
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as JC  # noqa: E402
from benchmarks import table34_opcounts as JT34  # noqa: E402
from repro.core import pipeline as JPL  # noqa: E402
from repro.core.pipeline import _Capture as JCapture  # noqa: E402
from repro.core.synthetic import inject_outlier_channels as jax_inject  # noqa: E402
from repro.models.transformer import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.step import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.data.pipeline import SyntheticCorpus  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.paper import common, fig3_delta, table34_opcounts  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TRAIN = 8            # reference train steps of the shared surrogate
N_EVAL = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module (under several
    test workers a thread pool per worker oversubscribes the cores); the
    worker's own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.fixture(scope="module")
def surrogate():
    """The reference's bench_model steps (TRAIN of them) and the port's
    bench tuple over the same trained, outlier-injected params."""
    jcfg = JC.get_config("llama3-1b").reduced(**JC.BENCH_CFG)
    jm = jax_build(jcfg)
    jcorpus = JC.SyntheticCorpus(jcfg.vocab, seed=0)
    opt_cfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=TRAIN)
    step = jax.jit(jax_make_train_step(jm, opt_cfg, JTrainConfig(remat=False)))
    jp = jm.init(jax.random.PRNGKey(0))
    opt = jadamw.init_state(opt_cfg, jp)
    it = JC.batch_iterator(jcorpus, JC.DataConfig(jcfg.vocab, JC.SEQ,
                                                  JC.BATCH, seed=0))
    for _ in range(TRAIN):
        jp, opt, _ = step(jp, opt, next(it))
    jp = jax_inject(jp, strength=1.0, strength2=1.0, hidden_strength=24.0,
                    seed=0)
    cfg = common.get_config("llama3-1b").reduced(**common.BENCH_CFG)
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    bench = (cfg, build_model(cfg), tp, SyntheticCorpus(cfg.vocab, seed=0))
    return jcfg, jm, jp, jcorpus, bench


PERQ = dict(block_size=16, permutation="massdiff", rotation="quarot")


@pytest.fixture(scope="module")
def ref_perq(surrogate):
    """The reference's PeRQ (b = 16, MassDiff, QuaRot) with Qronos on the
    surrogate."""
    jcfg, jm, jp, jcorpus, _ = surrogate
    return JPL.quantize_model(jm, jp, JC.calib_batches(jcorpus, jcfg),
                              JPL.PTQConfig(**PERQ, rounding="qronos"))


def off_grid(got, want) -> list[float]:
    """Per leaf, the share of the port's entries off the reference's (by
    more than 1e-5 of the leaf's largest magnitude)."""
    got_w, want_w = leaves(got), jax.tree.leaves(want)
    assert len(got_w) == len(want_w)
    return [float((np.abs(g.numpy() - np.asarray(w))
                   > 1e-5 * np.abs(np.asarray(w)).max()).mean())
            for g, w in zip(got_w, want_w)]


def test_tables_3_and_4_line_for_line():
    assert _stdout(table34_opcounts.main) == _stdout(JT34.main)


def test_eval_ppl_matches_the_reference(surrogate):
    jcfg, jm, jp, jcorpus, (cfg, model, tp, corpus) = surrogate
    want = JC.eval_ppl(jm, jp, jcorpus, n_batches=N_EVAL)
    got = common.eval_ppl(model, tp, corpus, n_batches=N_EVAL)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("rounding,rel,off_share", [("rtn", 1e-3, 1e-3),
                                                    ("qronos", 1e-2, 0.5)])
def test_quantize_and_eval_matches_the_reference(surrogate, ref_perq,
                                                 rounding, rel, off_share):
    """`quantize_and_eval`, with the reference's taken through its parts
    (`calib_batches`, `quantize_model`, `eval_ppl`, as its
    `quantize_and_eval` does) so that the weights are held too: at most
    `off_share` of each leaf's entries off the reference's grid points."""
    jcfg, jm, jp, jcorpus, (cfg, model, tp, corpus) = surrogate
    kw = dict(**PERQ, rounding=rounding)
    jres = ref_perq if rounding == "qronos" else JPL.quantize_model(
        jm, jp, JC.calib_batches(jcorpus, jcfg), JPL.PTQConfig(**kw))
    want = JC.eval_ppl(jm, jres.params, jcorpus, hooks=jres.hooks,
                       n_batches=N_EVAL)
    got = common.quantize_and_eval(model, tp, corpus, PL.PTQConfig(**kw),
                                   n_eval=N_EVAL)
    np.testing.assert_allclose(got, want, rtol=rel)
    cal = common.calib_batches(corpus, cfg, device="cpu")
    res = PL.quantize_model(model, tp, cal, PL.PTQConfig(**kw))
    assert max(off_grid(res.params, jres.params)) <= off_share


@pytest.mark.parametrize("fault", [dict(permutation="identity"),
                                   dict(permutation="zigzag"),
                                   dict(block_size=32)],
                         ids=["identity", "zigzag", "b32"])
def test_planted_faults_leave_the_references_grid(surrogate, ref_perq,
                                                  fault):
    """The Qronos check above rejects a pipeline that took another
    permutation or block size: some leaf of the port's result is more than
    half off the reference's PeRQ grid points."""
    cfg, model, tp, corpus = surrogate[4]
    cal = common.calib_batches(corpus, cfg, device="cpu")
    res = PL.quantize_model(model, tp, cal, PL.PTQConfig(
        **{**PERQ, "rounding": "qronos", **fault}))
    assert max(off_grid(res.params, ref_perq.params)) > 0.5


def test_collect_down_activations_matches_the_reference(surrogate):
    jcfg, jm, jp, jcorpus, bench = surrogate
    cap = JCapture()
    cmodel = jax_build(jcfg, quant_hooks=cap.hooks())
    for b in JC.calib_batches(jcorpus, jcfg, n=1):
        cap.reset_forward()
        cmodel.forward(jp, b, unroll=True)
    want = np.asarray(cap.get("down", 2))
    got = fig3_delta.collect_down_activations(bench).numpy()
    assert got.shape == want.shape == (8 * 128, jcfg.d_ff)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
