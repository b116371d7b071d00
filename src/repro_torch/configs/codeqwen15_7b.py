"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: dense, qwen1.5-arch (qkv bias,
GQA kv=32, that is MHA).  Same values as ``repro.configs.codeqwen15_7b
.CONFIG``; Chimera attention by default (m 128, L 256, n_global 32, d_head
128, Gq 1)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1e6,
)
