"""Yi-9B [arXiv:2403.04652]: llama-arch dense, GQA kv=4.  Same values as
``repro.configs.yi_9b.CONFIG``; Chimera attention by default (m 128, L 256,
n_global 32, d_head 128, Gq 8)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=1e4,
)
