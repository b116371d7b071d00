"""Moonshot-v1-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: MoE, 64 experts
top-6 with 2 shared experts (expert d_ff 1408).  Same values as
``repro.configs.moonshot_v1_16b_a3b.CONFIG``, whose fidelity note holds
here too: Moonlight's first dense layer is folded into the uniform MoE
pattern, the shared experts (2 x 1408) carry the dense path.  Chimera
attention by default (m 128, L 256, n_global 32, d_head 128, Gq 1)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,
    vocab_size=163840,
    moe_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    moe_shared_experts=2,
    rope_theta=5e4,
)
