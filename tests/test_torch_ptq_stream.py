"""The full-depth memory plan of `Model.init` and `quantize_model`: each
stacked leaf is built in place, and the PTQ pipeline streams the layers.

One small model per family (dense, MoE, SSM, hybrid; reduced width, 6
layers), shared by the module:

* `Model.init` equals, bit for bit, `torch.stack` over the per-layer
  `_init_block` draws from the same seeded generator (the draws and their
  order are the stacked build's);
* calibration is causal in depth and a learned R1 reads layers 0-3 only, so
  `quantize_model` of the 6-layer model and of its first 4 layers give the
  same first 4 layers, embedding, head and first report entries, bit for
  bit (the hybrid's shared block pools every group, so it is left out);
* at 6 layers, where a learned R1 holds layers 0-3 back until it is
  learned and finishes layers 4-5 as they are calibrated, the port's
  `quantize_model` matches the JAX package's on the same (carried) params
  and calibration tokens, with `tests/test_torch_pipeline.py`'s bars: the
  report's block masses within 1e-5 relative, the RTN weights on the
  reference's grid points (<= 0.1 % of the entries of every leaf differ),
  the fake-quant logit MSE against the bf16 model within 5 %. The SSM
  scans' roundoff compounds through the layers a calibration forward
  runs (the block masses of layers 0-4 differ by 0, 6e-7, 2e-6, 7e-6 and
  2e-5 relative under `rtn_only`), so the SSM families' report is held
  within 1e-4, the bar `tests/test_torch_families.py` holds their
  forward to. MassDiff's
  greedy assignment is discontinuous in its input: under the learned R1 a
  ~1e-7 difference of the captures flips a near-tie at one site (dense
  layer 5's FFN, the SSM's layer-3 out-projection, the hybrid's shared
  FFN; the port before streaming chose the same), which reassigns
  channels across blocks with the same block masses. So under
  `perq_dagger` the grid bar holds the leaves no permutation reaches, and
  the same preset with the identity permutation holds every leaf;
* the tensors `quantize_model` holds beyond its input and output trees
  are one layer's working set: their peak at 8 layers is within 10 % of
  the peak at 2 (counted by storage under a `TorchDispatchMode`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import get_config as jax_get_config
from repro.core import pipeline as JP
from repro.core.synthetic import inject_outlier_channels as jax_inject
from repro.models.transformer import build_model as jax_build
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.core import pipeline as PL
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.models import layers as L
from repro_torch.models.transformer import build_model
from repro_torch.tree import flatten_with_paths

ARCHS = ("llama3-1b", "deepseek-moe-16b", "mamba2-1.3b", "zamba2-1.2b")
PRESETS = ("rtn_only", "perq_dagger", "perq_star")
DEPTH, PREFIX = 6, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread for this module (under several
    test workers a thread pool per worker oversubscribes the cores); the
    worker's own setting comes back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(arch: str, n_layers: int, **over):
    return build_model(get_config(arch).reduced(n_layers=n_layers, **over))


def calib(cfg) -> list:
    rng = np.random.default_rng(1)
    return [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)))}]


@functools.lru_cache(maxsize=None)
def setup(arch: str):
    model = small(arch, DEPTH)
    gen = torch.Generator()
    gen.manual_seed(0)
    return model, inject_outlier_channels(model.init(gen))


def bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def assert_bit_equal(got, want, where=""):
    g, w = flatten_with_paths(got), flatten_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w], where
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, path)
        assert np.array_equal(bits(a), bits(b)), (where, path)


def stacked(nodes: list):
    if isinstance(nodes[0], dict):
        return {k: stacked([n[k] for n in nodes]) for k in nodes[0]}
    return torch.stack(nodes)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_init_builds_the_stack_in_place(arch, dtype):
    model = small(arch, DEPTH, param_dtype=dtype, compute_dtype=dtype)
    cfg = model.cfg
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    got = model.init(g1)
    # the draws in `init`'s order, stacked afterwards
    want = {"embed": L._normal(g2, (cfg.vocab, cfg.d_model), 0.02,
                               model.pdt)}
    want["layers"] = stacked([model._init_block(g2)
                              for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        want["shared_attn"] = model._shared_attn_block(g2)
    want["lm_head"] = L._normal(g2, (cfg.d_model, cfg.vocab),
                                cfg.d_model ** -0.5, model.pdt)
    for key in want:
        assert_bit_equal(got[key], want[key], key)
    shapes = model.init_shapes()
    for (path, m), (_, t) in zip(flatten_with_paths(shapes),
                                 flatten_with_paths(got)):
        assert m.device.type == "meta", path
        assert (m.shape, m.dtype) == (t.shape, t.dtype), path


def cut(params: dict, n: int) -> dict:
    """`params` with its layer leaves cut to the first `n` layers."""
    return {**params, "layers": _cut_tree(params["layers"], n)}


def _cut_tree(tree, n):
    if isinstance(tree, dict):
        return {k: _cut_tree(v, n) for k, v in tree.items()}
    return tree[:n].clone()


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_depth_prefix_is_bit_equal(arch, preset):
    model, params = setup(arch)
    short = small(arch, PREFIX)
    cal = calib(model.cfg)
    cfg = PL.preset(preset, block_size=16, cayley_steps=3)
    deep = PL.quantize_model(model, params, cal, cfg)
    head = PL.quantize_model(short, cut(params, PREFIX), cal, cfg)
    assert_bit_equal(_cut_tree(deep.params["layers"], PREFIX),
                     head.params["layers"], "layers")
    for key in ("embed", "lm_head", "final_norm"):
        assert_bit_equal(deep.params[key], head.params[key], key)
    # a hybrid's last entry is its shared block's, pooled over every group
    n = len(head.report["per_layer"]) - (model.cfg.family == "hybrid")
    assert n >= PREFIX
    assert deep.report["per_layer"][:n] == head.report["per_layer"][:n]
    assert deep.report["r1"] == head.report["r1"]


MSE_FRAC = 0.05
REPORT_FRAC = {"ssm": 1e-4, "hybrid": 1e-4}        # else 1e-5
# (preset, overrides); "permutation" off leaves every leaf comparable
REF_RUNS = (("rtn_only", ()), ("perq_dagger", ()),
            ("perq_dagger", (("permutation", "identity"),)))


@functools.lru_cache(maxsize=None)
def carried(arch: str):
    """The reference's model and params at `DEPTH` layers (outlier
    channels injected), the port's model, and the params carried across;
    a [4, 128] calibration batch and a held-out [8, 64] one, and the bf16
    reference model's logits on the latter."""
    jcfg = jax_get_config(arch).reduced(n_layers=DEPTH)
    jm = jax_build(jcfg)
    p = jax_inject(jm.init(jax.random.PRNGKey(0)))
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    rng = np.random.default_rng(0)
    cal = rng.integers(0, jcfg.vocab, (4, 128)).astype(np.int32)
    held = rng.integers(0, jcfg.vocab, (8, 64)).astype(np.int32)
    want = np.asarray(jax.jit(jm.forward)(p, {"tokens": jnp.asarray(held)}))
    return jm, p, small(arch, DEPTH), tp, cal, held, want


def grid_bar(path: str, permuted: bool) -> bool:
    """Whether the leaf at `path` is held to the reference's grid points:
    under a MassDiff permutation only the attention weights and the
    embedding and head, which no permutation reaches."""
    return not permuted or ".attn." in path or path in ("embed", "lm_head")


@pytest.mark.parametrize("preset, over", REF_RUNS)
@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_depth_matches_the_reference(arch, preset, over):
    jm, p, tm, tp, cal, held, want = carried(arch)
    over = dict(over, block_size=16, cayley_steps=4)
    jr = JP.quantize_model(jm, p, [{"tokens": jnp.asarray(cal)}],
                           JP.preset(preset, **over))
    tr = PL.quantize_model(tm, tp, [{"tokens": torch.from_numpy(cal)}],
                           PL.preset(preset, **over))
    assert tr.report["r1"] == jr.report["r1"]
    assert len(tr.report["per_layer"]) == len(jr.report["per_layer"])
    frac = REPORT_FRAC.get(tm.cfg.family, 1e-5)
    for a, b in zip(jr.report["per_layer"], tr.report["per_layer"]):
        for k in a:
            assert abs(b[k] - a[k]) <= frac * abs(a[k])
    ref = {".".join(map(str, path)): np.asarray(leaf) for path, leaf
           in flatten_with_paths(jax.tree.map(np.asarray, jr.params))}
    permuted = PL.preset(preset, **over).permutation != "identity"
    for path, got in flatten_with_paths(tr.params):
        path = ".".join(map(str, path))
        if not grid_bar(path, permuted):
            continue
        r = ref[path]
        for i, (g, w) in enumerate(zip(got.numpy(), r) if
                                   path.startswith("layers.")
                                   else [(got.numpy(), r)]):
            off = ~np.isclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
            assert off.mean() <= 1e-3, (path, i, off.mean())
    jl = np.asarray(jax.jit(JP.build_quantized_model(jm, jr).forward)(
        jr.params, {"tokens": jnp.asarray(held)}))
    tl = PL.build_quantized_model(tm, tr).forward(
        tr.params, {"tokens": torch.from_numpy(held)}).numpy()
    j_mse = float(np.mean((jl - want) ** 2))
    t_mse = float(np.mean((tl - want) ** 2))
    assert abs(t_mse - j_mse) <= MSE_FRAC * j_mse, (t_mse, j_mse)


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes of the storages that the ops run under it
    allocate and that are alive at once (a storage dies with its last
    tensor: a weak reference per storage, swept whenever the running sum
    would pass the peak)."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, tuple] = {}
        self.bytes = 0
        self.peak = 0

    def _sweep(self):
        for k in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            self.bytes -= self.live.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage()._cdata
                for t in torch.utils._pytree.tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live and self.live[key][0].expired():
                # a dead storage's address, taken by a new one
                self.bytes -= self.live.pop(key)[1]
            if key in self.live or key in seen:
                continue
            if self.bytes + st.nbytes() > self.peak:
                self._sweep()
            self.live[key] = (StorageWeakRef(st), st.nbytes())
            self.bytes += st.nbytes()
            self.peak = max(self.peak, self.bytes)
        return out


def extra_bytes(arch: str, n_layers: int, preset: str) -> int:
    """The peak of what `quantize_model` holds beyond its output tree (its
    input is allocated before it runs, so never counted)."""
    model = small(arch, n_layers, param_dtype="bfloat16",
                  compute_dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = inject_outlier_channels(model.init(gen))
    with LiveBytes() as mode:
        res = PL.quantize_model(model, params, calib(model.cfg),
                                PL.preset(preset, block_size=16))
    out = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
           for _, t in flatten_with_paths(res.params)}
    return mode.peak - sum(out.values())


# the hybrid is left out: its shared block's captures pool every group, so
# they grow with depth by design
@pytest.mark.parametrize("arch, preset", (("llama3-1b", "perq_star"),
                                          ("deepseek-moe-16b", "rtn_only"),
                                          ("mamba2-1.3b", "perq_star")))
def test_working_set_is_one_layer(arch, preset):
    two, eight = extra_bytes(arch, 2, preset), extra_bytes(arch, 8, preset)
    assert two > 0
    assert abs(eight - two) <= 0.1 * two, (two, eight)
