"""The port's integer serving model against the JAX package, on the CPU.

Weights are drawn by the JAX package (its initialiser, its outlier
injection, its packer) and carried across as numpy arrays; tokens are fixed
lists. The JAX side runs its dense-cache path with the interpret-mode
kernels, as its own tests do; the port runs on `device="cpu"`.

Tolerance: logits (and block outputs) within 5e-3 * max|value| in f32. The
arithmetic is the same on both sides, but reductions are summed in other
orders, so an activation can land on the other side of a rounding tie of
the 4-bit activation quantiser; one flipped code moves an output by one
quantisation step of one input channel, which is what the bound leaves
room for. Comparisons are teacher-forced and layer by layer - the reduced,
untrained, outlier-injected model is chaotic over long free-running
generations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.synthetic import inject_outlier_channels as jax_inject
from repro.kernels import ref as jref
from repro.models.transformer import build_model
from repro.serve import quantized as jq
from repro_torch import interop
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.synthetic import inject_outlier_channels
from repro_torch.models.layers import layer_view
from repro_torch.serve import quantized as tq
from repro_torch.serve.engine import pages_for

RTOL_MAX = 5e-3        # of max|reference|, see the module docstring
TOKENS = [3, 14, 15, 92, 6, 53, 58, 97, 9, 323, 84, 62]


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def N(t):
    return t.detach().to(torch.float32).cpu().numpy()


def assert_close_max(got, want, frac=RTOL_MAX):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    bound = frac * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"max err {err} > {bound}"


def assert_rows_close(got, want, *, frac=RTOL_MAX, loose=0.1, may_flip=1):
    """Row-wise form of the bound for whole-model runs, where one side's
    flipped rounding tie in an early layer is carried through every later
    layer of that token row: every [.., V] row meets `frac * max|want|`
    except at most `may_flip` rows, and those stay within
    `loose * max|want|` (one 4-bit step of an outlier channel is a few
    percent of the logit range on this model)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    top = np.abs(want).max()
    row_err = np.abs(got - want).reshape(-1, want.shape[-1]).max(-1)
    assert (row_err > frac * top).sum() <= may_flip, row_err / top
    assert row_err.max() <= loose * top, row_err / top


_CACHE = {}


def reference(arch, **overrides):
    """(jax cfg, float params, packed params) of the reduced `arch`, built
    once per configuration."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _CACHE:
        cfg = jax_get_config(arch).reduced(**overrides)
        params = jax_inject(build_model(cfg).init(jax.random.PRNGKey(0)))
        _CACHE[key] = (cfg, params, jq.pack_dense_params(params, cfg))
    return _CACHE[key]


def port(arch, **overrides):
    cfg = get_config(arch).reduced(**overrides)
    _, _, packed = reference(arch, **overrides)
    return cfg, interop.params_from_jax(to_numpy_tree(packed), "cpu")


def test_configs_are_the_reference_configs():
    import dataclasses
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) \
            == dataclasses.asdict(jax_get_config(arch))
        assert dataclasses.asdict(get_config(arch).reduced()) \
            == dataclasses.asdict(jax_get_config(arch).reduced())


@pytest.mark.parametrize("arch", ["llama3-1b", "qwen1.5-0.5b"])
def test_params_from_jax_and_port_packer(arch):
    """Carried-across packed params are bit-equal leaf for leaf, gain the
    column sums, and the port's own packer gives the same nibbles and scales
    from the same float weights."""
    cfg, params, packed = reference(arch)
    tcfg, tp = port(arch)
    flat_j = jax.tree_util.tree_leaves_with_path(packed)
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(N(node), np.asarray(leaf, np.float32))
    for name in ("wq", "wk", "wv", "wo"):
        proj = tp["layers"]["attn"][name]
        assert proj["packed"].dtype == torch.uint8
        assert proj["colsum"].dtype == torch.int32
        for l in range(cfg.n_layers):
            want = np.asarray(jref.int4_unpack(
                packed["layers"]["attn"][name]["packed"][l])).astype(np.int64).sum(0)
            np.testing.assert_array_equal(proj["colsum"][l].numpy(), want)
    assert ("bq" in tp["layers"]["attn"]) == cfg.qkv_bias
    own = tq.pack_dense_params(
        interop.tree_from_numpy(to_numpy_tree(params), "cpu"), tcfg)
    for grp in ("attn", "ffn"):
        for name, proj in own["layers"][grp].items():
            if not isinstance(proj, dict):
                continue
            for leaf in ("packed", "scale", "colsum"):
                np.testing.assert_array_equal(
                    N(proj[leaf]), N(tp["layers"][grp][name][leaf]))


def test_bf16_leaves_cross_bit_for_bit():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 33, dtype=np.float32),
                               jnp.bfloat16))
    t = interop.tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(N(t), a.astype(np.float32))


def test_inject_outlier_channels_same_indices():
    cfg = jax_get_config("llama3-1b").reduced()
    raw = build_model(cfg).init(jax.random.PRNGKey(0))
    want = to_numpy_tree(jax_inject(raw))
    got = inject_outlier_channels(
        interop.tree_from_numpy(to_numpy_tree(raw), "cpu"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(N(node), leaf)


def _layer(tree, l):
    return jax.tree.map(lambda a: a[l], tree)


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_block_layer_by_layer(kv_bits):
    """Each layer's `_block` fed the reference's own input and cache: a
    6-token prefill chunk at index 0, then a per-slot decode step."""
    cfg, _, packed = reference("llama3-1b")
    tcfg, tp = port("llama3-1b")
    jm = jq.QuantizedDenseLM(cfg, block_size=16, kv_bits=kv_bits)
    tm = tq.QuantizedDenseLM(tcfg, block_size=16, kv_bits=kv_bits)
    # compiled, as the serving path runs it (the compiler turns divisions by
    # constants into multiplies by reciprocals, which the port mirrors)
    jblock = jax.jit(lambda x, blk, cache, index:
                     jm._block(x, blk, cache, index)[:2])
    b, s, max_len = 2, 6, 16
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (b, s + 1))
    jcache = jm.init_cache(b, max_len)
    x = jnp.take(packed["embed"], jnp.asarray(tokens[:, :s]), axis=0)
    phases = [(x, jnp.asarray(0, jnp.int32), 0)]
    for phase in range(2):
        x, jindex, tindex = phases[phase]
        new_layers = []
        for l in range(cfg.n_layers):
            cache_l = _layer(jcache, l)
            want_x, want_cache = jblock(x, _layer(packed["layers"], l),
                                        cache_l, jindex)
            tcache = interop.cache_from_jax(to_numpy_tree(cache_l), "cpu")
            got_x, got_cache, _ = tm._block(
                torch.from_numpy(np.array(x)), layer_view(tp["layers"], l),
                tcache, tindex)
            assert_close_max(N(got_x), want_x)
            for name in want_cache:
                w = np.asarray(want_cache[name], np.float32)
                g = N(got_cache[name])
                if name in ("k", "v") and kv_bits is not None:
                    # integer codes: equal except at rounding ties
                    assert np.mean(g != w) <= 0.01 and np.abs(g - w).max() <= 1
                else:
                    assert_close_max(g, w)
            new_layers.append(want_cache)
            x = want_x
        jcache = jax.tree.map(lambda *xs: jnp.stack(xs), *new_layers)
        if phase == 0:
            x1 = jnp.take(packed["embed"], jnp.asarray(tokens[:, s:]), axis=0)
            phases.append((x1, jnp.asarray([s, s], jnp.int32),
                           torch.tensor([s, s], dtype=torch.int32)))


@pytest.mark.parametrize("arch", ["llama3-1b", "qwen1.5-0.5b"])
@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_prefill_and_teacher_forced_decode(arch, kv_bits):
    """Whole model: an 8-token prefill and two teacher-forced decode steps.
    Each decode step starts from the reference's cache, so one side's
    rounding ties do not compound into the next comparison."""
    cfg, _, packed = reference(arch)
    tcfg, tp = port(arch)
    jm = jq.QuantizedDenseLM(cfg, block_size=16, kv_bits=kv_bits)
    tm = tq.QuantizedDenseLM(tcfg, block_size=16, kv_bits=kv_bits)
    toks = np.asarray([TOKENS[:8], TOKENS[2:10]]) % cfg.vocab
    jlogits, jcache = jm.prefill(packed, jnp.asarray(toks, jnp.int32),
                                 jm.init_cache(2, 16))
    tcache = tm.init_cache(2, 16, device="cpu")
    tlogits, tcache = tm.prefill(tp, torch.from_numpy(toks), tcache)
    assert tuple(tlogits.shape) == (2, 8, cfg.vocab)
    assert_rows_close(N(tlogits), jlogits)
    for step in range(2):
        nxt = np.asarray([[TOKENS[8 + step]], [TOKENS[10 + step]]]) % cfg.vocab
        tcache = interop.cache_from_jax(to_numpy_tree(jcache), "cpu")
        jl, jcache = jm.decode_step(packed, jnp.asarray(nxt, jnp.int32),
                                    jcache, jnp.asarray(8 + step, jnp.int32))
        tl, _ = tm.decode_step(tp, torch.from_numpy(nxt), tcache, 8 + step)
        assert tuple(tl.shape) == (2, cfg.vocab)
        assert_rows_close(N(tl), jl)


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_bfloat16_compute_block_by_block(kv_bits):
    """bf16 parameters and activations, layer by layer on the reference's
    input. What is written to the cache agrees exactly or to a last bit.
    The block output is held to a looser bound: the two frameworks round
    intermediate activations to bf16 (8 mantissa bits) at different places
    inside the gated FFN, a bf16 ulp is 0.4 %, and with so few mantissa
    bits exact rounding ties of the 4-bit quantiser are common - so some
    rows carry a flipped code or two of an outlier channel. Bound: half of
    the token rows within 2 % of max|x|, every row within 30 %."""
    over = dict(compute_dtype="bfloat16", param_dtype="bfloat16")
    cfg, _, packed = reference("llama3-1b", **over)
    tcfg, tp = port("llama3-1b", **over)
    assert tp["embed"].dtype == torch.bfloat16
    jm = jq.QuantizedDenseLM(cfg, block_size=16, kv_bits=kv_bits)
    tm = tq.QuantizedDenseLM(tcfg, block_size=16, kv_bits=kv_bits)
    jblock = jax.jit(lambda x, blk, cache, index:
                     jm._block(x, blk, cache, index)[:2])
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 6))
    x = jnp.take(packed["embed"], jnp.asarray(toks), axis=0)
    jcache = jm.init_cache(2, 16)
    for l in range(cfg.n_layers):
        cache_l = _layer(jcache, l)
        want_x, want_cache = jblock(x, _layer(packed["layers"], l), cache_l,
                                    jnp.asarray(0, jnp.int32))
        got_x, got_cache, _ = tm._block(
            interop.tensor_from_numpy(np.asarray(x), "cpu"),
            layer_view(tp["layers"], l),
            interop.cache_from_jax(to_numpy_tree(cache_l), "cpu"), 0)
        assert got_x.dtype == torch.bfloat16
        for name in want_cache:
            w = np.asarray(want_cache[name], np.float32)
            g = N(got_cache[name])
            if kv_bits is not None and name in ("k", "v"):
                assert np.mean(g != w) <= 5e-3 and np.abs(g - w).max() <= 1
            elif kv_bits is not None:
                np.testing.assert_allclose(g, w, rtol=1e-6)
            else:
                # bf16 rows: equal up to one bf16 ulp of a rare element
                assert np.mean(g != w) <= 5e-3
                np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6)
        w = np.asarray(want_x, np.float32)
        rows = np.abs(N(got_x) - w).reshape(-1, w.shape[-1]).max(-1) / np.abs(w).max()
        assert np.median(rows) <= 0.02 and rows.max() <= 0.30, rows
        x = want_x


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_paged_forward_equals_dense_forward_inside_the_port(kv_bits):
    """Chunked prefill through a block table, then a batched per-slot decode
    step, against the dense-cache path on the same tokens: the page walk's
    online softmax and the dense softmax agree to f32 rounding, which the
    next activation quantiser may turn into a flipped tie - same bound."""
    tcfg, tp = port("llama3-1b")
    tm = tq.QuantizedDenseLM(tcfg, block_size=16, kv_bits=kv_bits)
    page, n_pages, max_len = 4, 12, 16
    toks = torch.tensor([TOKENS[:8], TOKENS[3:11]]) % tcfg.vocab
    dense = tm.init_cache(2, max_len, device="cpu")
    want, dense = tm.prefill(tp, toks, dense)
    pool = tm.init_cache(n_pages, page, device="cpu")
    tables = [[3, 7, 1], [5, 2, 9]]                 # scattered, page 0 unused
    got = []
    for i in range(2):
        bt = torch.tensor([tables[i] + [0]], dtype=torch.int32)
        rows = []
        for start in (0, 4):                        # two 4-token chunks
            lg, pool = tm.forward_chunk(
                tp, toks[i:i + 1, start:start + 4], pool, start, bt,
                torch.tensor([start + 4], dtype=torch.int32))
            rows.append(lg)
        got.append(torch.cat(rows, dim=1))
    assert_close_max(N(torch.cat(got)), N(want))
    nxt = torch.tensor([[TOKENS[8]], [TOKENS[11]]]) % tcfg.vocab
    fill = torch.tensor([8, 8], dtype=torch.int32)
    want_d, _ = tm.forward_chunk(tp, nxt, dense, fill)
    bt = torch.tensor([t + [0] for t in tables], dtype=torch.int32)
    got_d, _ = tm.forward_chunk(tp, nxt, pool, fill, bt,
                                torch.tensor([9, 9], dtype=torch.int32))
    assert_close_max(N(got_d), N(want_d))
    assert pages_for(9, page) == 3
    with pytest.raises(ValueError):
        tm.forward_chunk(tp, toks, dense, fill)     # per-slot index, S > 1
