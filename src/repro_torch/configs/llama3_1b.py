"""Llama-3.2 1B [arXiv:2407.21783] — the paper's own evaluation family.
Used by the PTQ benchmark harnesses (Table 1/2 surrogates) and examples."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-1b", family="dense",
    n_layers=16, d_model=2048, vocab=128_256,
    n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, act="silu", norm="rmsnorm",
    rope_theta=500_000.0,
)
