"""DeepSeekMoE 16B [arXiv:2401.06066]: 2 shared + 64 routed fine-grained
experts, top-6, expert d_ff=1408.

Simplification (documented): the real model's dense first layer is modeled
as MoE like the rest — layer-heterogeneity is orthogonal to both the PTQ
technique and the distribution schema.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, vocab=102_400,
    n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, act="silu", norm="rmsnorm",
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    capacity_factor=1.25,
)
