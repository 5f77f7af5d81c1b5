"""Training the families through the port: `Model.loss_fn`'s gradients of
reduced qwen1.5-0.5b (QKV bias), deepseek-moe-16b (routed and shared
experts), mamba2-1.3b (SSM) and zamba2-1.2b (hybrid) against the JAX
package's on the same parameters and batch, every leaf within 1e-5 of its
largest magnitude (the tolerance of `tests/test_torch_train.py`); with
`remat=True` the same loss and gradients as without (1e-6); and the
training launcher's CLI on a reduced SSM on the CPU.
"""
import functools
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models.transformer import build_model as jax_build
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import build_model
from repro_torch.tree import flatten_with_paths, leaves, unflatten

ARCHS = ["qwen1.5-0.5b", "deepseek-moe-16b", "mamba2-1.3b", "zamba2-1.2b"]
LEAF_FRAC = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread for this module; the worker's own
    setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def bridged(arch):
    jcfg = jax_get_config(arch).reduced()
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)}
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, build_model(get_config(arch).reduced()), tp, batch


def port_grads(tm, tp, batch, remat):
    flat = [p.detach().requires_grad_(True) for p in leaves(tp)]
    loss, _ = tm.loss_fn(unflatten(tp, flat),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         remat=remat)
    return loss.detach(), torch.autograd.grad(loss, flat, allow_unused=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_the_reference(arch):
    jm, jp, tm, tp, batch = bridged(arch)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, remat=False), has_aux=True))(jp, batch)
    tl, tg = port_grads(tm, tp, batch, remat=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LEAF_FRAC)
    want = {tuple(getattr(k, "key", k) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = [(p, g) for (p, _), g in zip(flatten_with_paths(tp), tg)]
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        w = want[path]
        g = np.zeros_like(w) if g is None else g.numpy()
        tol = LEAF_FRAC * max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol, (path, np.abs(g - w).max(), tol)


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_remat_matches_no_remat(arch):
    _, _, tm, tp, batch = bridged(arch)
    l0, g0 = port_grads(tm, tp, batch, remat=False)
    l1, g1 = port_grads(tm, tp, batch, remat=True)
    assert float(l0) == float(l1)
    for a, b in zip(g0, g1):
        if a is None or b is None:
            assert a is None and b is None
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_train_cli_on_a_reduced_ssm(tmp_path, monkeypatch, capsys):
    """`python -m repro_torch.launch.train ...`, run as `__main__` in this
    process."""
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "4", "--seq", "16", "--workdir",
        str(tmp_path)])
    monkeypatch.delitem(sys.modules, "repro_torch.launch.train",
                        raising=False)
    runpy.run_module("repro_torch.launch.train", run_name="__main__")
    assert "finished at step 2; failures=0 restores=0" in \
        capsys.readouterr().out
    assert (tmp_path / "ckpt" / "step_000000002").is_dir()
