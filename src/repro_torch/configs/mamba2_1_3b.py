"""Mamba2-1.3B pure SSM (SSD) [arXiv:2405.21060]. Attention-free."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab=50_280,
    d_ff=0,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    notes="attention-free; sub-quadratic: runs long_500k. PeRQ applies to "
          "the in-proj gate region with head-preserving permutations "
          "(DESIGN.md §Arch-applicability).",
)
