"""Granite-3.0 2B dense decoder [hf:ibm-granite/granite-3.0-2b-base]: GQA kv=8."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, vocab=49_155,
    n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, act="silu", norm="rmsnorm",
)
