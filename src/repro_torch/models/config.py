"""Unified architecture configuration for the model zoo.

One `ArchConfig` describes every family in the assigned pool: dense decoder
LMs (GQA/RoPE/SwiGLU), MoE (shared + routed fine-grained experts), pure SSM
(Mamba2/SSD), hybrid (Mamba2 backbone + shared attention block), encoder-only
(audio backbone), and VLM backbones (vision-patch frontend stub).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encoder", "vlm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    vocab: int
    # attention (unused for pure-ssm layers)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    # feed-forward
    d_ff: int = 0
    act: str = "silu"            # "silu" (SwiGLU) | "gelu" (classic MLP)
    norm: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid: one shared attention(+FFN) block applied every `period` SSM layers
    hybrid_period: int = 0
    # modality frontend stub (input_specs provides precomputed embeddings)
    frontend: str | None = None  # None | "audio_frames" | "vision_patches"
    frontend_tokens: int = 0     # prefix length supplied by the stub (vlm)
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # notes for DESIGN/dry-run bookkeeping
    notes: str = ""

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM state or hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        """Encoder-only architectures have no autoregressive decode."""
        return self.family != "encoder"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def uses_moe(self) -> bool:
        return self.n_experts > 0

    def validate(self) -> "ArchConfig":
        if self.family in ("dense", "moe", "encoder", "vlm", "hybrid"):
            assert self.n_heads > 0 and self.head_dim > 0
            assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.uses_moe:
            assert self.top_k > 0 and self.moe_d_ff > 0
        return self

    def reduced(self, **overrides) -> "ArchConfig":
        """A small same-family config for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            vocab=min(self.vocab, 512),
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.head_dim else 0,
            d_ff=256 if self.d_ff else 0,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            hybrid_period=min(self.hybrid_period, 2),
            frontend_tokens=min(self.frontend_tokens, 16),
            param_dtype="float32",
            compute_dtype="float32",
            name=self.name + "-smoke",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base).validate()


# ---------------------------------------------------------------------------
# Input-shape cells (assigned per-arch; see system spec)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def applicable_shapes(cfg: ArchConfig) -> list[ShapeCell]:
    """Shape cells that are well-defined for this architecture.

    Skips (recorded in DESIGN.md §Arch-applicability):
      * decode shapes for encoder-only archs (no autoregressive step),
      * long_500k for pure full-attention archs (needs sub-quadratic decode).
    """
    cells = [TRAIN_4K, PREFILL_32K]
    if cfg.has_decode:
        cells.append(DECODE_32K)
        if cfg.subquadratic:
            cells.append(LONG_500K)
    return cells


def skipped_shapes(cfg: ArchConfig) -> dict[str, str]:
    out = {}
    if not cfg.has_decode:
        out["decode_32k"] = "encoder-only: no autoregressive decode step"
        out["long_500k"] = "encoder-only: no autoregressive decode step"
    elif not cfg.subquadratic:
        out["long_500k"] = ("pure full-attention arch: 500k decode needs "
                            "sub-quadratic attention (run for ssm/hybrid only)")
    return out
