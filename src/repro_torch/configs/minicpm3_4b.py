"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: MLA (multi-head latent attention).
Same values as ``repro.configs.minicpm3_4b.CONFIG``; Chimera attention by
default (m 128, L 256, n_global 32) on 40 heads of q/k width 96 and v
width 64 (Gq 1).

Published MLA dims: q_lora_rank=768, kv_lora_rank=256, qk_nope=64,
qk_rope=32, v_head_dim=64.  40 heads on d_model=2560."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=96,  # qk_nope + qk_rope
    d_ff=6400,
    vocab_size=73448,
    attention_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
)
