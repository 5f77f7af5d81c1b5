"""The bf16 / fake-quant model of every family: dense, vlm, encoder, MoE,
SSM (Mamba2) and hybrid (Zamba2: Mamba2 layers and one shared attention +
FFN block after every `hybrid_period` of them).

Parameters are plain dict trees with per-layer leaves stacked on axis 0
(`[n_layers, ...]`), the JAX package's layout, so the PTQ pipeline walks and
merges the same tree and parameters cross between the packages leaf for
leaf. The layer stack runs as a Python loop over views of each layer.

`quant_hooks` is the PTQ seam, as in the reference: `act_in(x, tag)` on
every projection input (tags `qkv`, `wo`, `ffn`, `expert_in`, `ssm_in`),
`down_proj_fn(h, w)` in place of the FFN's (and the shared experts') last
projection, `moe_down_proj_fn(h, w)` of the routed experts' and
`ssm_out_proj_fn(y, w)` of the Mamba2 block's. The calibration installs
capture hooks, the fake-quant model quantising ones.

Caches are updated **in place** (the JAX counterpart returns new arrays).
With a block table the kv leaves are the engine's page pool and attention
walks it through `kernels.ops.paged_attention`; with a register index the
SSM leaves are the engine's register slot pools. A decode step's positions
are computed on the device from its [B] index, so the step reads nothing
back to the host and can be captured in a CUDA graph.

`loss_fn` and `train_forward` are the training path: they carry
gradients, and `remat=True` recomputes each layer in the backward
(`torch.utils.checkpoint`). The inference entry points (`forward`,
`prefill`, `forward_chunk`) run under `torch.no_grad()`.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..distributed.context import (gather_weights, local_offset,
                                   local_shard, on_mesh, reduce_over,
                                   shard_act, with_axis)

from . import layers as L
from . import moe as M
from . import ssm as S
from .config import ArchConfig

Params = dict[str, Any]

FRONTEND_DIMS = {"audio_frames": 512, "vision_patches": 1024}

# the matmuls of `x @ w` (2-D products once the batch is folded); the
# attention's batched einsums are not among them, as in the reference's
# `dots_with_no_batch_dims_saveable`
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_POLICIES = ("nothing", "dots")


def _stack(nodes: list):
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return torch.stack(nodes)


class _MetaGenerator(torch.Generator):
    """A generator that reports the meta device, so `Model.init` draws
    nothing and builds meta tensors."""

    @property
    def device(self):
        return torch.device("meta")


class Model:
    """Functional model wrapper for one ArchConfig."""

    def __init__(self, cfg: ArchConfig, *, quant_hooks=None,
                 remat_policy: str = "nothing",
                 moe_dense_oracle: bool = False):
        self.cfg = cfg.validate()
        self.pdt = L.DTYPES[cfg.param_dtype]
        self.cdt = L.DTYPES[cfg.compute_dtype]
        # {"act_in": fn(x, tag) -> x, "down_proj_fn": fn(h, w) -> out,
        #  "moe_down_proj_fn": ..., "ssm_out_proj_fn": ...}
        self.quant_hooks = quant_hooks or {}
        # route MoE FFNs through the evaluate-all-experts oracle
        # (per-token exact, chunking-invariant) instead of the capacity-
        # bounded dispatch: parity tests only, where chunk-length-dependent
        # capacity drops would break chunked == whole-prompt comparisons
        self.moe_dense_oracle = moe_dense_oracle
        # what a remat'd layer keeps for its backward: "nothing" keeps its
        # input alone and recomputes the rest, "dots" also keeps the
        # outputs of its weight matmuls (more memory, less recompute)
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {remat_policy!r}")
        self.remat_policy = remat_policy
        if cfg.n_heads:
            self.attn_spec = L.AttnSpec(
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, causal=cfg.causal,
                rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias)

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------

    def _init_block(self, gen: torch.Generator) -> Params:
        cfg, dt, dev = self.cfg, self.pdt, gen.device
        if cfg.family in ("ssm", "hybrid"):
            return {"norm": L.init_norm(cfg.d_model, cfg.norm, dt, dev),
                    "ssm": S.init_ssm(gen, cfg.d_model, expand=cfg.ssm_expand,
                                      head_dim=cfg.ssm_head_dim,
                                      state=cfg.ssm_state,
                                      conv_width=cfg.ssm_conv_width,
                                      dtype=dt)}
        blk = {
            "attn_norm": L.init_norm(cfg.d_model, cfg.norm, dt, dev),
            "attn": L.init_attention(gen, cfg.d_model, self.attn_spec, dt),
            "ffn_norm": L.init_norm(cfg.d_model, cfg.norm, dt, dev),
        }
        if cfg.uses_moe:
            blk["moe"] = M.init_moe(gen, cfg.d_model, cfg.n_experts,
                                    cfg.moe_d_ff, cfg.n_shared_experts,
                                    cfg.act, dt)
        else:
            blk["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt)
        return blk

    def _shared_attn_block(self, gen: torch.Generator) -> Params:
        """Hybrid (Zamba2): the one shared attention + FFN block."""
        cfg, dt, dev = self.cfg, self.pdt, gen.device
        return {
            "attn_norm": L.init_norm(cfg.d_model, cfg.norm, dt, dev),
            "attn": L.init_attention(gen, cfg.d_model, self.attn_spec, dt),
            "ffn_norm": L.init_norm(cfg.d_model, cfg.norm, dt, dev),
            "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt),
        }

    def init(self, gen: torch.Generator) -> Params:
        """Fresh parameters drawn from `gen`, on its device."""
        cfg, dt, dev = self.cfg, self.pdt, gen.device
        p: Params = {}
        if cfg.frontend != "audio_frames":
            p["embed"] = L._normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt)
        p["layers"] = _stack([self._init_block(gen)
                              for _ in range(cfg.n_layers)])
        if cfg.family == "hybrid":
            p["shared_attn"] = self._shared_attn_block(gen)
        p["final_norm"] = L.init_norm(cfg.d_model, cfg.norm, dt, dev)
        p["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab),
                                 cfg.d_model ** -0.5, dt)
        if cfg.frontend is not None:
            fdim = FRONTEND_DIMS[cfg.frontend]
            p["frontend_proj"] = L._normal(gen, (fdim, cfg.d_model),
                                           fdim ** -0.5, dt)
        return p

    def init_shapes(self) -> Params:
        """The parameter tree as meta tensors: every leaf's shape and
        dtype, no storage (the reference's `jax.eval_shape(model.init,
        key)`)."""
        return self.init(_MetaGenerator())

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------

    def _apply_block(self, x, blk: Params, cache, cache_index, *,
                     block_table=None, seq_lengths=None,
                     register_index=None, valid_len=None):
        cfg = self.cfg
        hooks = self.quant_hooks
        if cfg.family in ("ssm", "hybrid"):
            h = L.apply_norm(x, blk["norm"], cfg.norm)
            h = S.ssm_block(h, blk["ssm"], head_dim=cfg.ssm_head_dim,
                            state=cfg.ssm_state, chunk=cfg.ssm_chunk,
                            cache=cache, register_index=register_index,
                            valid_len=valid_len, act_in=hooks.get("act_in"),
                            out_proj_fn=hooks.get("ssm_out_proj_fn"))
            return x + h
        h = L.apply_norm(x, blk["attn_norm"], cfg.norm)
        h, _ = L.attention(h, blk["attn"], self.attn_spec, cache=cache,
                           cache_index=cache_index, block_table=block_table,
                           seq_lengths=seq_lengths,
                           act_in=hooks.get("act_in"))
        x = x + h
        h = L.apply_norm(x, blk["ffn_norm"], cfg.norm)
        if cfg.uses_moe:
            kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, act=cfg.act,
                      down_proj_fn=hooks.get("moe_down_proj_fn"),
                      act_in=hooks.get("act_in"),
                      shared_down_proj_fn=hooks.get("down_proj_fn"))
            if self.moe_dense_oracle:
                h = M.moe_ffn_dense_oracle(h, blk["moe"], **kw)
            else:
                h = M.moe_ffn(h, blk["moe"],
                              capacity_factor=cfg.capacity_factor, **kw)
        else:
            h = L.mlp(h, blk["ffn"], cfg.act,
                      down_proj_fn=hooks.get("down_proj_fn"),
                      act_in=hooks.get("act_in"))
        return x + h

    def _apply_shared(self, x, shared: Params, cache, cache_index, *,
                      block_table=None, seq_lengths=None):
        cfg = self.cfg
        hooks = self.quant_hooks
        h = L.apply_norm(x, shared["attn_norm"], cfg.norm)
        h, _ = L.attention(h, shared["attn"], self.attn_spec, cache=cache,
                           cache_index=cache_index, block_table=block_table,
                           seq_lengths=seq_lengths,
                           act_in=hooks.get("act_in"))
        x = x + h
        h = L.apply_norm(x, shared["ffn_norm"], cfg.norm)
        h = L.mlp(h, shared["ffn"], cfg.act,
                  down_proj_fn=hooks.get("down_proj_fn"),
                  act_in=hooks.get("act_in"))
        return x + h

    def _hybrid_groups(self) -> tuple[int, int, int]:
        """(n_groups, period, tail): L = n_groups * period + tail; the
        shared attention block runs after each full group."""
        cfg = self.cfg
        period = cfg.hybrid_period or cfg.n_layers
        n_groups = cfg.n_layers // period
        return n_groups, period, cfg.n_layers - n_groups * period

    def _run_layers(self, params: Params, x, *, caches=None,
                    cache_index=None, block_table=None, seq_lengths=None,
                    register_index=None, valid_len=None,
                    remat: bool = False):
        """Every layer in turn over the views of its params and caches (the
        caches' views write into the stacked pools); a hybrid runs the
        shared block after each full group of `hybrid_period` layers, on
        the group's own kv cache. With `remat` (no caches) each layer is
        checkpointed."""
        cfg = self.cfg
        n = cfg.n_layers
        hybrid = cfg.family == "hybrid"
        layer_caches = caches["ssm"] if hybrid and caches is not None \
            else caches
        views = [None] * n if caches is None else L.unstack(layer_caches, n)
        if hybrid:
            n_groups, period, _ = self._hybrid_groups()
            shared_views = [None] * n_groups if caches is None \
                else L.unstack(caches["shared"], n_groups)
        for i, (blk, cache) in enumerate(zip(
                L.unstack(params["layers"], n), views)):
            if remat:
                x = ckpt.checkpoint(self._apply_block, x, blk, None, None,
                                    use_reentrant=False,
                                    **self._remat_context())
            else:
                x = self._apply_block(x, blk, cache, cache_index,
                                      block_table=block_table,
                                      seq_lengths=seq_lengths,
                                      register_index=register_index,
                                      valid_len=valid_len)
            if hybrid and (i + 1) % period == 0 \
                    and (i + 1) // period <= n_groups:
                g = (i + 1) // period - 1
                if remat:
                    x = ckpt.checkpoint(self._apply_shared, x,
                                        params["shared_attn"], None, None,
                                        use_reentrant=False,
                                        **self._remat_context())
                else:
                    x = self._apply_shared(x, params["shared_attn"],
                                           shared_views[g], cache_index,
                                           block_table=block_table,
                                           seq_lengths=seq_lengths)
        return x

    def _remat_context(self) -> dict:
        if self.remat_policy == "dots":
            return {"context_fn": functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)}
        return {}

    def _head(self, params: Params, x):
        x = L.apply_norm(x, params["final_norm"], self.cfg.norm)
        head = gather_weights({"w": params["lm_head"]})["w"]
        return shard_act(x @ head.to(self.cdt),
                         ("batch", "seq", "vocab"))

    def _embed_tokens(self, params: Params, tokens):
        if on_mesh(params["embed"]):
            return embed_on_mesh(params["embed"], tokens).to(self.cdt)
        return params["embed"][tokens.to(torch.int64)].to(self.cdt)

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def _embed_inputs(self, params: Params, batch: Params):
        cfg = self.cfg
        proj = gather_weights({"w": params.get("frontend_proj")})["w"] \
            if cfg.frontend is not None else None
        if cfg.frontend == "audio_frames":
            x = batch["frames"].to(self.cdt) @ proj
        elif cfg.frontend == "vision_patches":
            pe = batch["patches"].to(self.cdt) @ proj
            te = self._embed_tokens(params, batch["tokens"])
            x = torch.cat([pe, te], dim=1)
        else:
            x = self._embed_tokens(params, batch["tokens"])
        return x.to(self.cdt)

    @torch.no_grad()
    def forward(self, params: Params, batch: Params) -> torch.Tensor:
        """Full-sequence forward -> logits [B, S, vocab]. The layer stack
        is a Python loop, so capture hooks see every layer in turn (the
        reference's `unroll=True`)."""
        return self.train_forward(params, batch)

    def train_forward(self, params: Params, batch: Params, *,
                      remat: bool = False) -> torch.Tensor:
        """`forward` carrying gradients to every parameter that requires
        them; `remat=True` checkpoints each layer."""
        x = self._embed_inputs(params, batch)
        return self._head(params, self._run_layers(params, x, remat=remat))

    def loss_fn(self, params: Params, batch: Params, *,
                remat: bool = False):
        """Mean next-token (or frame-label) cross-entropy + 1e-4 z-loss
        over the positions whose label is >= 0. Returns (loss, {"nll",
        "zloss", "tokens"})."""
        logits = self.train_forward(params, batch,
                                    remat=remat).to(torch.float32)
        labels = batch["labels"]
        if self.cfg.frontend == "vision_patches":
            # labels cover text positions only (after the patch prefix)
            logits = logits[:, -labels.shape[1]:]
        if on_mesh(logits):
            return _vocab_parallel_loss(logits, labels)
        mask = (labels >= 0).to(torch.float32)
        labels = torch.clamp_min(labels, 0).to(torch.int64)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = (lse - gold) * mask
        tokens = torch.sum(mask)
        denom = torch.clamp_min(tokens, 1.0)
        loss = torch.sum(nll) / denom
        zloss = 1e-4 * torch.sum((lse * mask) ** 2) / denom
        return loss + zloss, {"nll": loss, "zloss": zloss, "tokens": tokens}

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def _stacked(self, one: Params, n: int) -> Params:
        return {k: v[None].repeat(n, *([1] * v.dim())) for k, v in one.items()}

    def _ssm_cache(self, batch: int, dtype, device) -> Params:
        cfg = self.cfg
        return self._stacked(S.init_ssm_cache(
            batch, cfg.d_model, expand=cfg.ssm_expand,
            head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
            conv_width=cfg.ssm_conv_width, dtype=dtype, device=device),
            cfg.n_layers)

    def _attn_cache(self, batch: int, max_len: int, n: int, dtype,
                    device) -> Params:
        return self._stacked(L.init_attention_cache(
            batch, max_len, self.attn_spec, dtype, device), n)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda") -> Params:
        """The native dense cache: `[n_layers, batch, max_len, KH, Dh]` per
        kv leaf (with (n_pages, page_size) a page pool); an SSM's
        `{"conv": [n_layers, batch, W-1, C] in dtype, "state": [n_layers,
        batch, H, N, P] f32}`; a hybrid's `{"ssm": ..., "shared": kv leaves
        [n_groups, ...]}`."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return self._ssm_cache(batch, dtype, device)
        if cfg.family == "hybrid":
            n_groups, _, _ = self._hybrid_groups()
            return {"ssm": self._ssm_cache(batch, dtype, device),
                    "shared": self._attn_cache(batch, max_len, n_groups,
                                               dtype, device)}
        return self._attn_cache(batch, max_len, cfg.n_layers, dtype, device)

    def init_paged_state(self, n_pages: int, page_size: int, n_slots: int,
                         dtype=torch.bfloat16, device="cuda") -> Params:
        """The engine's `{"kv": ..., "register": ...}` state: kv leaves are
        page pools ([n_layers or n_groups, n_pages, page_size, ...]),
        register leaves slot pools ([n_layers, n_slots, ...], one slot per
        admitted sequence). Dense and MoE state is pure kv, SSM pure
        register, a hybrid both."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return {"kv": {}, "register": self._ssm_cache(n_slots, dtype,
                                                          device)}
        if cfg.family == "hybrid":
            n_groups, _, _ = self._hybrid_groups()
            return {"kv": {"shared": self._attn_cache(
                        n_pages, page_size, n_groups, dtype, device)},
                    "register": {"ssm": self._ssm_cache(n_slots, dtype,
                                                        device)}}
        return {"kv": self.init_cache(n_pages, page_size, dtype, device),
                "register": {}}

    @torch.no_grad()
    def prefill(self, params: Params, batch: Params, caches: Params):
        """Process the prompt from position 0, fill the caches in place;
        returns the last position's logits [B, V] and the caches."""
        x = self._embed_inputs(params, batch)
        x = self._run_layers(params, x, caches=caches, cache_index=0)
        return self._head(params, x[:, -1:])[:, 0], caches

    @torch.no_grad()
    def forward_chunk(self, params: Params, tokens: torch.Tensor,
                      caches: Params, index,
                      block_table: torch.Tensor | None = None,
                      seq_lengths: torch.Tensor | None = None,
                      register_index: torch.Tensor | None = None):
        """Token chunk [B, S] at fill position `index` -> per-position
        logits [B, S, V] and the caches, updated in place. S == 1 with a
        [B] tensor index is a per-slot decode step; S > 1 with an int index
        is one chunk of a chunked prefill. With `block_table` [B, P] the
        kv caches are the engine's page pools ([n_layers, n_pages, T, ...])
        and `seq_lengths` [B] end each sequence's walk. With
        `register_index` [B] the SSM caches are the engine's register slot
        pools ([n_layers, n_slots, ...]), and in a prefill chunk
        `seq_lengths` also bound each row's live tokens, so a right-padded
        tail stays out of the carried state."""
        x = self._embed_tokens(params, tokens)
        valid_len = None
        if register_index is not None and seq_lengths is not None \
                and tokens.shape[1] > 1:
            # a prefill chunk: the row's live tokens in this chunk end at
            # seq_lengths - index
            valid_len = seq_lengths.to(torch.int64) - int(index)
        x = self._run_layers(params, x, caches=caches, cache_index=index,
                             block_table=block_table,
                             seq_lengths=seq_lengths,
                             register_index=register_index,
                             valid_len=valid_len)
        return self._head(params, x), caches

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    caches: Params, index):
        """One decode step. tokens: [B, 1]; index: an int or [B] tensor."""
        logits, caches = self.forward_chunk(params, tokens, caches, index)
        return logits[:, 0], caches


def embed_on_mesh(table, tokens):
    """The rows of `table` [V, d] (a DTensor, split by vocabulary over the
    model axis or not split) for `tokens` [B, S] on a mesh of ranks: each
    rank looks up the ids that fall in its rows (zeros for the others) and
    the lookups are summed over the model axis, XLA's partitioning of the
    reference's gather. -> [B, S, d] DTensor, batch-split as `tokens`."""
    from torch.distributed.tensor import Replicate, Shard
    ids = tokens if on_mesh(tokens) else None
    for ax in ("pod", "data"):           # a ZeRO-3 table: gathered first
        table = with_axis(table, ax, Replicate())
    tl = local_shard(table)
    v0, vl = local_offset(table, 0), tl.shape[0]
    tok = (ids.to_local() if ids is not None else tokens).to(torch.int64)
    inside = (tok >= v0) & (tok < v0 + vl)
    rows = F.embedding((tok - v0).clamp(0, vl - 1), tl)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    like = ids if ids is not None else table
    if vl < table.shape[0]:
        rows = reduce_over(rows, like, "model")
    names = table.device_mesh.mesh_dim_names
    pl = [p if ids is not None and a != "model" else Replicate()
          for a, p in zip(names, like.placements)]
    pl = [p if isinstance(p, (Shard, Replicate)) else Replicate() for p in pl]
    from ..distributed.context import local_to_dtensor
    return local_to_dtensor(rows, table,
                            (*tokens.shape, table.shape[1]), pl)


def _vocab_parallel_loss(logits, labels):
    """`Model.loss_fn`'s loss on a mesh of ranks, from logits [B, S, V]
    split by vocabulary over the model axis: each rank takes the max, the
    sum of exponentials and the gold logit over its own columns, and only
    those [B, S] partials are all-reduced (XLA's partitioning of the
    reference's logsumexp and gather), never the logits."""
    from torch.distributed.tensor import Shard
    logits = with_axis(logits, "model", Shard(2))
    ll = local_shard(logits)
    v0, vl = local_offset(logits, 2), ll.shape[2]
    lab = labels.to_local() if on_mesh(labels) else labels
    mask = (lab >= 0).to(torch.float32)
    lab = torch.clamp_min(lab, 0).to(torch.int64)
    mx = reduce_over(ll.detach().amax(-1), logits, "model", "max")
    lse = mx + torch.log(reduce_over(torch.exp(ll - mx[..., None]).sum(-1),
                                     logits, "model"))
    inside = (lab >= v0) & (lab < v0 + vl)
    own = torch.gather(ll, -1, (lab - v0).clamp(0, vl - 1)[..., None])[..., 0]
    gold = reduce_over(torch.where(inside, own, torch.zeros_like(own)),
                       logits, "model")
    # the sums over this rank's rows, added up over the axes that split
    # the rows (none where the batch does not divide them)
    data = tuple(a for a, p in zip(logits.device_mesh.mesh_dim_names,
                                   logits.placements)
                 if a in ("pod", "data") and p == Shard(0))
    tokens = reduce_over(torch.sum(mask), logits, data)
    denom = torch.clamp_min(tokens, 1.0)
    loss = reduce_over(torch.sum((lse - gold) * mask), logits, data) / denom
    zloss = 1e-4 * reduce_over(torch.sum((lse * mask) ** 2), logits,
                               data) / denom
    return loss + zloss, {"nll": loss, "zloss": zloss, "tokens": tokens}


def build_model(cfg: ArchConfig, **kw) -> Model:
    return Model(cfg, **kw)
