"""True-integer W4A4 serving path for dense-family archs.

Every projection is packed to int4 (two nibbles per byte, per-output-channel
scale, int32 column sums) and executed in integer arithmetic:

    per projection:  x -> per-token asymmetric int4 codes (+ scale, + zero)
                     q_a @ q_w, exact int32 accumulation
                     float epilogue  s_a * s_w * (acc + z_a * colsum)

Every online op goes through `repro_torch.kernels.ops`, so a model on a CUDA
device runs the hand-written kernels and a model on the CPU (the tests) runs
their plain PyTorch versions. The one online rotation left at inference, the
block-Hadamard in front of `w_down`, runs fused with its quantiser
(`ops.hadamard_quant`).

The KV cache is float (the compute dtype's companion, bf16 by default) or,
with `kv_bits` in {4, 8}, integer codes with asymmetric per-(position, head)
scale + zero pairs; integer caches store K *before* RoPE and the rotation is
re-applied after dequantisation at read time (RoPE would smear each outlier
channel over a position-dependent pair of channels and waste code points).

Under the paged engine `forward_chunk` also takes per-sequence block tables:
new KV rows are scattered straight into their pool pages and attention walks
the table through `ops.paged_attention`, which dequantises and re-rotates K
inside the kernel.

`forward_chunk(probe=True)` also returns the per-layer rotation-quality
stats of `serve.telemetry.quality` at the fused rotate+quantize site; the
logits are equal bit for bit with and without it.

**Caches are updated in place.** The cache (or page pool) handed to
`forward_chunk` is the one returned; the JAX counterpart is functional and
returns new arrays. Layer leaves of parameters and caches are stacked
`[n_layers, ...]`, and layer `l` works on views of index `l`.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.hadamard_quant import _recip_f32
from ..models import layers as L
from ..models.config import ArchConfig
from .telemetry.quality import activation_probe_stats

Params = dict[str, Any]

PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _pack_stack(w: torch.Tensor) -> Params:
    """Pack a `[n_layers, K, N]` stack layer by layer (bounds the transient
    memory of the scale search to one layer)."""
    packed = [kops.pack_int4_weights(w[l]) for l in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in packed]) for k in packed[0]}


def pack_dense_params(params: Params, cfg: ArchConfig) -> Params:
    """Pack every per-layer projection; keep embeddings / norms / head as
    they are. Uses the shared `kernels.ops.pack_int4_weights` packer."""
    layers = params["layers"]
    out = {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "lm_head": params["lm_head"],
        "layers": {
            "attn_norm": layers["attn_norm"],
            "ffn_norm": layers["ffn_norm"],
        },
    }
    attn = {name: _pack_stack(layers["attn"][name])
            for name in ("wq", "wk", "wv", "wo")}
    for bias in ("bq", "bk", "bv"):
        if bias in layers["attn"]:
            attn[bias] = layers["attn"][bias]
    out["layers"]["attn"] = attn
    out["layers"]["ffn"] = {name: _pack_stack(layers["ffn"][name])
                            for name in ("w_gate", "w_up", "w_down")
                            if name in layers["ffn"]}
    return out


def _int_matmul(quant, packed: Params, dtype) -> torch.Tensor:
    codes, s, z = quant
    y = kops.int4_matmul(codes, s, z, packed["packed"], packed["scale"],
                         packed.get("colsum"))
    return y.to(dtype)


def _int_linear(x: torch.Tensor, packed: Params, *, bits: int = 4):
    """x [..., K] float -> int4 quantise per token -> integer GEMM -> float."""
    return _int_matmul(kops.quantize_act(x, bits), packed, x.dtype)


def _rot_int_linear(h: torch.Tensor, packed: Params, block_size: int):
    """Online block rotation fused with quantisation, then the integer GEMM
    (the down-projection path). Also returns the activation codes."""
    quant = kops.hadamard_quant(h, block_size, bits=4)
    return _int_matmul(quant, packed, h.dtype), quant[0]


class QuantizedDenseLM:
    """Integer-arithmetic decode for dense-family configs.

    Built from packed parameters (`pack_dense_params`, or the JAX package's
    packed tree through `interop.params_from_jax`). The device is that of
    the parameters and caches it is given; `init_cache` takes it explicitly.
    """

    def __init__(self, cfg: ArchConfig, *, block_size: int = 32,
                 kv_bits: int | None = None):
        if cfg.family not in ("dense", "vlm"):
            raise ValueError("integer serving path covers dense archs")
        if kv_bits not in (None, 4, 8):
            raise ValueError(f"kv_bits must be None, 4 or 8, got {kv_bits}")
        self.cfg = cfg.validate()
        self.block_size = block_size
        self.kv_bits = kv_bits
        self.attn_spec = L.AttnSpec(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, causal=True, rope_theta=cfg.rope_theta,
            qkv_bias=cfg.qkv_bias)
        # one (scale, zero) pair per (position, head)
        self.kv_group = cfg.head_dim

    @property
    def compute_dtype(self) -> torch.dtype:
        return L.DTYPES[self.cfg.compute_dtype]

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda") -> Params:
        """Dense cache `[n_layers, batch, max_len, ...]` per leaf; called
        with (n_pages, page_size) it is the engine's page pool."""
        n = self.cfg.n_layers
        kv, dh = self.cfg.n_kv_heads, self.cfg.head_dim
        if self.kv_bits is None:
            shp = (n, batch, max_len, kv, dh)
            return {"k": torch.zeros(shp, dtype=dtype, device=device),
                    "v": torch.zeros(shp, dtype=dtype, device=device)}
        ng = dh // self.kv_group
        codes = (n, batch, max_len, kv, dh)
        aux = (n, batch, max_len, kv, ng)
        f32 = torch.float32
        return {
            "k": torch.zeros(codes, dtype=torch.int8, device=device),
            "v": torch.zeros(codes, dtype=torch.int8, device=device),
            "k_scale": torch.ones(aux, dtype=f32, device=device),
            "v_scale": torch.ones(aux, dtype=f32, device=device),
            "k_zero": torch.zeros(aux, dtype=f32, device=device),
            "v_zero": torch.zeros(aux, dtype=f32, device=device),
        }

    @staticmethod
    def _write_rows(buf, val, index):
        """Update `buf` [B, L, ...] in place with `val` [B, S, ...] at fill
        position `index` - an int (all rows at the same offset, any S) or a
        [B] tensor (per-slot offsets, S == 1: the continuous-batching decode
        case)."""
        if torch.is_tensor(index) and index.dim() == 1:
            rows = torch.arange(buf.shape[0], device=buf.device)
            buf[rows, index.to(torch.int64)] = val[:, 0].to(buf.dtype)
        else:
            i = int(index)
            buf[:, i:i + val.shape[1]] = val.to(buf.dtype)
        return buf

    def _quantize_kv(self, x):
        """Asymmetric per-(position, head) KV quantisation -> (codes int8,
        scale f32, zero f32). Codes are stored offset by 2^(bits-1) so the
        unsigned range fits int8 at kv_bits = 8."""
        bits = self.kv_bits
        levels = float(2 ** bits - 1)
        off = 2 ** (bits - 1)
        g = self.kv_group
        shp = x.shape
        xg = x.to(torch.float32).reshape(*shp[:-1], shp[-1] // g, g)
        mn = xg.amin(dim=-1, keepdim=True)
        mx = xg.amax(dim=-1, keepdim=True)
        # the floor keeps zero-range groups from dividing by 0 while leaving
        # the zero-point small enough for exact f32 arithmetic
        # (range * f32(1 / levels), the compiled reference's form of the
        # division by a constant - see kernels.hadamard_quant)
        s = torch.clamp_min((mx - mn) * _recip_f32(levels), 1e-6)
        z = torch.round(mn / s)
        codes = torch.clamp(torch.round(xg / s) - z, 0, levels)
        return ((codes - off).reshape(shp).to(torch.int8),
                s[..., 0], z[..., 0])

    def _kv_leaves(self, k, v):
        """The (leaf name, value) pairs one KV write must store."""
        if self.kv_bits is None:
            return (("k", k), ("v", v))
        kq, ks, kz = self._quantize_kv(k)
        vq, vs, vz = self._quantize_kv(v)
        return (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs),
                ("k_zero", kz), ("v_zero", vz))

    def _cache_write(self, cache, k, v, index):
        """Write new K/V rows at positions [index, index + S), in place.
        Integer caches receive and store K before RoPE."""
        for name, val in self._kv_leaves(k, v):
            self._write_rows(cache[name], val, index)
        return cache

    def _paged_cache_write(self, cache, k, v, positions, block_table):
        """Scatter new rows straight into their pages (pool leaves
        [n_pages, page_size, ...]), in place - same quantisation arithmetic
        as `_cache_write`."""
        for name, val in self._kv_leaves(k, v):
            L.paged_write_rows(cache[name], val, block_table, positions)
        return cache

    def _cache_read(self, cache):
        """Dequantise the whole cache -> (K, V); K is still pre-RoPE."""
        if self.kv_bits is None:
            return cache["k"], cache["v"]
        off = float(2 ** (self.kv_bits - 1))
        g = self.kv_group

        def dq(codes, scale, zero):
            shp = codes.shape
            cg = (codes.to(torch.float32) + off).reshape(
                *shp[:-1], shp[-1] // g, g)
            return (scale[..., None] * (cg + zero[..., None])).reshape(shp)

        return dq(cache["k"], cache["k_scale"], cache["k_zero"]), \
            dq(cache["v"], cache["v_scale"], cache["v_zero"])

    def _block(self, x, blk, cache, index, block_table=None,
               seq_lengths=None, probe=False):
        """One layer -> (x, cache, probe stats or None)."""
        cfg = self.cfg
        spec = self.attn_spec
        b, s, _ = x.shape
        h_, kv, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
        dev = x.device

        # q/k/v read the same normed input: quantise it once
        hx = L.apply_norm(x, blk["attn_norm"], cfg.norm)
        quant = kops.quantize_act(hx, 4)
        q = _int_matmul(quant, blk["attn"]["wq"], hx.dtype)
        k = _int_matmul(quant, blk["attn"]["wk"], hx.dtype)
        v = _int_matmul(quant, blk["attn"]["wv"], hx.dtype)
        if spec.qkv_bias:
            q = q + blk["attn"]["bq"]
            k = k + blk["attn"]["bk"]
            v = v + blk["attn"]["bv"]
        q = q.reshape(b, s, h_, dh)
        k = k.reshape(b, s, kv, dh)
        v = v.reshape(b, s, kv, dh)
        # index is an int (lockstep batch / prefill chunk) or a [B] tensor
        # (per-slot fill positions from the continuous-batching engine)
        per_slot = torch.is_tensor(index) and index.dim() == 1
        if per_slot and s != 1:
            raise ValueError("per-slot cache_index requires q_len == 1")
        pos = L.chunk_positions(b, s, index, dev)
        q = L.apply_rope(q, pos, spec.rope_theta)
        if self.kv_bits is None:
            # float cache: rotate only the new rows, store post-RoPE
            k = L.apply_rope(k, pos, spec.rope_theta)
        if block_table is not None:
            # block-table-native: scatter the new rows into their pages and
            # walk the table in the kernel (dequantisation and the K
            # rotation happen inside it for the integer page formats)
            self._paged_cache_write(cache, k, v, pos, block_table)
            quantized = self.kv_bits is not None
            attn = kops.paged_attention(
                q, cache, block_table, pos, seq_lengths,
                rope_theta=spec.rope_theta if quantized else None,
                kv_bits=self.kv_bits,
                kv_group=self.kv_group if quantized else None)
            attn = attn.reshape(b, s, h_ * dh).to(x.dtype)
        else:
            self._cache_write(cache, k, v, index)
            k_all, v_all = self._cache_read(cache)
            s_k = k_all.shape[1]
            if self.kv_bits is not None:
                # integer cache holds pre-RoPE K: rotate after dequant
                all_pos = torch.arange(s_k, device=dev)[None].expand(b, s_k)
                k_all = L.apply_rope(k_all.to(torch.float32), all_pos,
                                     spec.rope_theta)
            # the query at position p sees keys <= p
            valid = torch.arange(s_k, device=dev)[None, None, :] \
                <= pos[:, :, None]
            g = h_ // kv
            qg = q.reshape(b, s, kv, g, dh)
            logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                                  k_all.to(torch.float32)) \
                * _recip_f32(math.sqrt(dh))
            logits = torch.where(valid[:, None, None, :, :], logits,
                                 torch.full_like(logits, -1e30))
            probs = torch.softmax(logits, dim=-1)
            attn = torch.einsum("bkgqs,bskd->bqkgd", probs,
                                v_all.to(torch.float32))
            attn = attn.reshape(b, s, h_ * dh).to(x.dtype)
        x = x + _int_linear(attn, blk["attn"]["wo"])

        hx = L.apply_norm(x, blk["ffn_norm"], cfg.norm)
        quant = kops.quantize_act(hx, 4)          # shared by gate and up
        if "w_gate" in blk["ffn"]:
            gate = _int_matmul(quant, blk["ffn"]["w_gate"], hx.dtype)
            hid = (gate * torch.sigmoid(gate)) \
                * _int_matmul(quant, blk["ffn"]["w_up"], hx.dtype)
        else:
            hid = F.gelu(_int_matmul(quant, blk["ffn"]["w_up"], hx.dtype),
                         approximate="tanh")
        down, act_codes = _rot_int_linear(hid, blk["ffn"]["w_down"],
                                          self.block_size)
        x = x + down
        stats = None
        if probe:
            # rotation-quality probe on the fused rotate+quantize site: it
            # reads the main path's values and writes none of them (the
            # rotated activation is recomputed - the fused kernel never
            # writes it out). The stats pool over every row of the chunk,
            # padding rows included, as in the reference.
            hid_p = hid.to(torch.float32)
            post = kops.block_hadamard(hid_p, self.block_size)
            stats = activation_probe_stats(hid_p, post, act_codes, bits=4,
                                           block_size=self.block_size)
        return x, cache, stats

    def _forward(self, params: Params, tokens: torch.Tensor, cache: Params,
                 index, block_table=None, seq_lengths=None, probe=False):
        cfg = self.cfg
        x = params["embed"][tokens.to(torch.int64)].to(self.compute_dtype)
        per_layer = []
        for l in range(cfg.n_layers):
            x, _, stats = self._block(
                x, L.layer_view(params["layers"], l), L.layer_view(cache, l),
                index, block_table, seq_lengths, probe)
            per_layer.append(stats)
        x = L.apply_norm(x, params["final_norm"], cfg.norm)
        logits = x @ params["lm_head"].to(x.dtype)
        if probe:
            # name -> [n_layers] tensor, still on the device
            return logits, cache, {k: torch.stack([s[k] for s in per_layer])
                                   for k in per_layer[0]}
        return logits, cache

    @torch.no_grad()
    def forward_chunk(self, params: Params, tokens: torch.Tensor,
                      cache: Params, index,
                      block_table: torch.Tensor | None = None,
                      seq_lengths: torch.Tensor | None = None, *,
                      probe: bool = False):
        """Token chunk [B, S] at fill position `index` -> per-position
        logits [B, S, V] and the cache, updated in place. S == 1 with a [B]
        tensor index is a per-slot continuous-batching decode step; S > 1
        with an int index is one chunk of a chunked prefill (causal within
        the chunk, attending to everything already cached). With
        `block_table` [B, P] the cache is the engine's page pool and
        attention runs block-table-native; `seq_lengths` [B] feed the paged
        kernel's ragged early exit. `probe=True` also returns the per-layer
        rotation-quality stats (name -> [n_layers] tensor, see
        `serve.telemetry.quality`); the logits are equal bit for bit either
        way."""
        return self._forward(params, tokens, cache, index, block_table,
                             seq_lengths, probe)

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, index):
        """One decode step for [B, 1] tokens at fill position `index` (int,
        or [B] per-slot fill positions)."""
        logits, cache = self.forward_chunk(params, tokens, cache, index)
        return logits[:, 0], cache

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params):
        """Process a [B, S] prompt from position 0 (causal within the
        block); returns per-position logits [B, S, V] and the filled cache -
        decode then continues at index S."""
        return self.forward_chunk(params, tokens, cache, 0)
