"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM, dense GQA (kv 8)
with qk-norm.  Same values as ``repro.configs.chameleon_34b.CONFIG``.  Its
VQ image tokens are ordinary vocabulary ids, so the stack is a language
model's; the image tokenizer is not model code in either package.
Chimera attention by default (m 128, L 256, n_global 32, d_head 128, Gq
8)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,  # chameleon uses qk-norm for stability
    rope_theta=1e4,
)
