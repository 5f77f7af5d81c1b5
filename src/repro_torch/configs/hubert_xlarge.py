"""HuBERT X-Large audio encoder backbone [arXiv:2106.07447].

Encoder-only (bidirectional), GELU MLP, LayerNorm. The conv waveform stem is
a stub: `input_specs` supplies precomputed 512-dim frame features which are
projected to d_model. vocab=504 is the masked-prediction codebook.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, vocab=504,
    n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, act="gelu", norm="layernorm",
    causal=False, rope_theta=10_000.0,
    frontend="audio_frames",
    notes="encoder-only: decode shapes skipped",
)
