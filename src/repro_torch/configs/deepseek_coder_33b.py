"""DeepSeek-Coder 33B dense decoder [arXiv:2401.14196]: llama-arch, GQA kv=8.

d_ff = 19200 exercises the non-power-of-2 full-vector Hadamard
(19200 = 2^6·300, Paley-II base H_300).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, vocab=32_256,
    n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19_200, act="silu", norm="rmsnorm",
)
