"""InternVL2-2B VLM backbone [arXiv:2404.16821]: InternLM2-1.8B LM with an
InternViT frontend stub (precomputed 1024-dim patch embeddings, 256 patches
prepended — early fusion)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, vocab=92_553,
    n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, act="silu", norm="rmsnorm",
    frontend="vision_patches", frontend_tokens=256,
)
