"""Llama-4 Maverick 400B-A17B MoE [hf:meta-llama/Llama-4]: 128 routed experts
top-1 + 1 shared expert, early fusion.

Simplification (documented): all 48 layers are MoE (the real model
interleaves dense layers); ZeRO-3 weight sharding is required to fit HBM.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, vocab=202_048,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=0, act="silu", norm="rmsnorm",
    n_experts=128, n_shared_experts=1, top_k=1, moe_d_ff=8192,
    capacity_factor=1.25,
)
