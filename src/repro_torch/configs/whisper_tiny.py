"""Whisper-tiny [arXiv:2212.04356]: the encoder-decoder audio backbone.
Same values as ``repro.configs.whisper_tiny.CONFIG``.  The conv frontend is
a stub, as there: the caller gives precomputed frame embeddings (B, Te,
d_model).  4 encoder layers of non-causal softmax self-attention, 4
decoder layers of Chimera self-attention (the default m 128, L 256) with
cross-attention to the encoder's output, LayerNorm throughout."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm_type="layernorm",
    rope_theta=1e4,
)
