"""Qwen1.5-0.5B dense decoder [hf:Qwen/Qwen1.5-0.5B]: QKV bias, huge vocab."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, vocab=151_936,
    n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, act="silu", norm="rmsnorm",
    qkv_bias=True,
)
