"""The bf16 / fake-quant model of the dense, vlm and encoder families.

Parameters are plain dict trees with per-layer leaves stacked on axis 0
(`[n_layers, ...]`), the JAX package's layout, so the PTQ pipeline walks and
merges the same tree and parameters cross between the packages leaf for
leaf. The layer stack runs as a Python loop over views of each layer.

`quant_hooks` is the PTQ seam, as in the reference: `act_in(x, tag)` on
every projection input (tags `qkv`, `wo`, `ffn`) and `down_proj_fn(h, w)`
in place of the FFN's last projection. The calibration installs capture
hooks, the fake-quant model quantising ones.

Caches are updated **in place** (the JAX counterpart returns new arrays).
With a block table the kv leaves are the engine's page pool and attention
walks it through `kernels.ops.paged_attention`; a decode step's positions
are computed on the device from its [B] index, so the step reads nothing
back to the host and can be captured in a CUDA graph.

`loss_fn` and `train_forward` are the training path: they carry
gradients, and `remat=True` recomputes each layer in the backward
(`torch.utils.checkpoint`). The inference entry points (`forward`,
`prefill`, `forward_chunk`) run under `torch.no_grad()`.

The MoE, SSM and hybrid families are ROADMAP Queue A10.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from . import layers as L
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


class Model:
    """Functional model wrapper for one ArchConfig (dense, vlm, encoder)."""

    def __init__(self, cfg: ArchConfig, *, quant_hooks=None,
                 remat_policy: str = "nothing"):
        self.cfg = cfg.validate()
        if cfg.family not in ("dense", "vlm", "encoder") or cfg.uses_moe:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family's model is ROADMAP "
                "Queue A10 (MoE, SSM and hybrid are not ported yet)")
        self.pdt = L.DTYPES[cfg.param_dtype]
        self.cdt = L.DTYPES[cfg.compute_dtype]
        # {"act_in": fn(x, tag) -> x, "down_proj_fn": fn(h, w) -> out}
        self.quant_hooks = quant_hooks or {}
        # what a remat'd layer keeps for its backward: "nothing" keeps its
        # input alone and recomputes the rest, "dots" also keeps the
        # outputs of its weight matmuls (more memory, less recompute)
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {remat_policy!r}")
        self.remat_policy = remat_policy
        self.attn_spec = L.AttnSpec(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, causal=cfg.causal,
            rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias)

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------

    def init(self, gen: torch.Generator) -> Params:
        """Fresh parameters drawn from `gen`, on its device."""
        cfg, dt, dev = self.cfg, self.pdt, gen.device
        p: Params = {}
        if cfg.frontend != "audio_frames":
            p["embed"] = L._normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt)
        p["layers"] = _stack([{
            "attn_norm": L.init_norm(cfg.d_model, cfg.norm, dt, dev),
            "attn": L.init_attention(gen, cfg.d_model, self.attn_spec, dt),
            "ffn_norm": L.init_norm(cfg.d_model, cfg.norm, dt, dev),
            "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt),
        } for _ in range(cfg.n_layers)])
        p["final_norm"] = L.init_norm(cfg.d_model, cfg.norm, dt, dev)
        p["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab),
                                 cfg.d_model ** -0.5, dt)
        if cfg.frontend is not None:
            fdim = FRONTEND_DIMS[cfg.frontend]
            p["frontend_proj"] = L._normal(gen, (fdim, cfg.d_model),
                                           fdim ** -0.5, dt)
        return p

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------

    def _apply_block(self, x, blk: Params, cache, cache_index, *,
                     block_table=None, seq_lengths=None):
        cfg = self.cfg
        hooks = self.quant_hooks
        h = L.apply_norm(x, blk["attn_norm"], cfg.norm)
        h, _ = L.attention(h, blk["attn"], self.attn_spec, cache=cache,
                           cache_index=cache_index, block_table=block_table,
                           seq_lengths=seq_lengths,
                           act_in=hooks.get("act_in"))
        x = x + h
        h = L.apply_norm(x, blk["ffn_norm"], cfg.norm)
        h = L.mlp(h, blk["ffn"], cfg.act,
                  down_proj_fn=hooks.get("down_proj_fn"),
                  act_in=hooks.get("act_in"))
        return x + h

    def _run_layers(self, params: Params, x, *, caches=None,
                    cache_index=None, block_table=None, seq_lengths=None,
                    remat: bool = False):
        """Every layer in turn over the views of its params and caches (the
        caches' views write into the stacked pools); with `remat` (no
        caches) each layer is checkpointed."""
        n = self.cfg.n_layers
        views = [None] * n if caches is None else L.unstack(caches, n)
        for blk, cache in zip(L.unstack(params["layers"], n), views):
            if remat:
                x = ckpt.checkpoint(self._apply_block, x, blk, None, None,
                                    use_reentrant=False,
                                    **self._remat_context())
            else:
                x = self._apply_block(x, blk, cache, cache_index,
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
        return x @ params["lm_head"].to(self.cdt)

    def _embed_tokens(self, params: Params, tokens):
        return params["embed"][tokens.to(torch.int64)].to(self.cdt)

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def _embed_inputs(self, params: Params, batch: Params):
        cfg = self.cfg
        if cfg.frontend == "audio_frames":
            x = batch["frames"].to(self.cdt) @ params["frontend_proj"]
        elif cfg.frontend == "vision_patches":
            pe = batch["patches"].to(self.cdt) @ params["frontend_proj"]
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

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda") -> Params:
        """Dense cache `[n_layers, batch, max_len, KH, Dh]` per leaf; with
        (n_pages, page_size) it is a page pool."""
        one = L.init_attention_cache(batch, max_len, self.attn_spec, dtype,
                                     device)
        return {k: v[None].repeat(self.cfg.n_layers, 1, 1, 1, 1)
                for k, v in one.items()}

    def init_paged_state(self, n_pages: int, page_size: int, n_slots: int,
                         dtype=torch.bfloat16, device="cuda") -> Params:
        """The engine's `{"kv": page pools, "register": {}}` state (the
        dense families carry kv state only)."""
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
                      seq_lengths: torch.Tensor | None = None):
        """Token chunk [B, S] at fill position `index` -> per-position
        logits [B, S, V] and the caches, updated in place. S == 1 with a
        [B] tensor index is a per-slot decode step; S > 1 with an int index
        is one chunk of a chunked prefill. With `block_table` [B, P] the
        caches are the engine's page pools ([n_layers, n_pages, T, ...])
        and `seq_lengths` [B] end each sequence's walk."""
        x = self._embed_tokens(params, tokens)
        x = self._run_layers(params, x, caches=caches, cache_index=index,
                             block_table=block_table,
                             seq_lengths=seq_lengths)
        return self._head(params, x), caches

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    caches: Params, index):
        """One decode step. tokens: [B, 1]; index: an int or [B] tensor."""
        logits, caches = self.forward_chunk(params, tokens, caches, index)
        return logits[:, 0], caches


def build_model(cfg: ArchConfig, **kw) -> Model:
    return Model(cfg, **kw)
