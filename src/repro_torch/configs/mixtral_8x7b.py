"""Mixtral-8x7B [arXiv:2401.04088]: 8 experts top-2, sliding-window
attention (4096).  Same values as ``repro.configs.mixtral_8x7b.CONFIG``.
The registry default is its Chimera variant (m 128, L 256, n_global 32,
d_head 128, Gq 4), where the local SRAM layer subsumes the window: the
prefill runs the ``chimera_attention`` kernel, the decode ``decode_step``.
Its softmax variant (``use_chimera=False``) runs the banded SWA path
through the ``window_attention`` kernel."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    attention_kind="swa",
    sliding_window=4096,
    moe_experts=8,
    moe_top_k=2,
    moe_d_ff=14336,
    rope_theta=1e6,
)
