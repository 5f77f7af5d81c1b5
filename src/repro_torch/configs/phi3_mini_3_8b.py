"""Phi-3-mini 3.8B dense decoder [arXiv:2404.14219]: RoPE/SwiGLU/GQA."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, vocab=32_064,
    n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, act="silu", norm="rmsnorm",
)
