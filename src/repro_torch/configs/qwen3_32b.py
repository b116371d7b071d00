"""Qwen3-32B [hf:Qwen/Qwen3-8B family]: dense GQA kv=8 with qk-norm.  Same
values as ``repro.configs.qwen3_32b.CONFIG``; Chimera attention by default
(m 128, L 256, n_global 32, d_head 128, Gq 8)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)
