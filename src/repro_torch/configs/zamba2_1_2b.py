"""Zamba2-1.2B hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242].

38 Mamba2 layers; one parameter-shared attention+FFN block is applied after
every 6 SSM layers (6 invocations; the 2 trailing layers run without a
shared-block call). ssm_state=64 per the assignment.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, vocab=32_000,
    n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, act="silu", norm="rmsnorm",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    hybrid_period=6,
    notes="sub-quadratic: runs long_500k",
)
