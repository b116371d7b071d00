"""Jamba-1.5-Large (398B) [arXiv:2403.19887]: Mamba and attention
interleaved 7:1, MoE of 16 experts top-2 at every other layer.  72 layers =
9 groups of [m m m a m m m m], MoE at the even positions of a group.  Same
values as ``repro.configs.jamba_15_large.CONFIG``.  Its attention layer is
Chimera by default (m 128, L 256, n_global 32, d_head 128, Gq 8): the
prefill runs the ``chimera_attention`` kernel, the decode ``decode_step``;
the Mamba layers are plain tensor code (``models/mamba.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba"),
    moe_experts=16,
    moe_top_k=2,
    moe_every=2,
    moe_d_ff=24576,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    mamba_chunk=64,
    rope_theta=1e4,
)
