"""Registry of the configurations the port has (port of
``repro.configs.registry``: ``get_config`` and ``smoke_config`` :49-89).

``smoke_config``'s reductions are the JAX package's, its Mamba and
enc-dec (``encoder_layers=2``) branches included.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    chameleon_34b,
    chimera_dataplane,
    codeqwen15_7b,
    jamba_15_large,
    minicpm3_4b,
    mixtral_8x7b,
    moonshot_v1_16b_a3b,
    qwen3_32b,
    whisper_tiny,
    xlstm_125m,
    yi_9b,
)
from repro_torch.configs.base import ArchConfig

ARCHS = {
    "codeqwen1.5-7b": codeqwen15_7b.CONFIG,
    "yi-9b": yi_9b.CONFIG,
    "minicpm3-4b": minicpm3_4b.CONFIG,
    "qwen3-32b": qwen3_32b.CONFIG,
    "whisper-tiny": whisper_tiny.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
    "jamba-1.5-large-398b": jamba_15_large.CONFIG,
    "chimera-dataplane": chimera_dataplane.CONFIG,
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(name)
    pattern = cfg.block_pattern
    n_layers = max(len(pattern), 2 if len(pattern) == 1 else len(pattern))
    replace = dict(
        n_layers=n_layers if n_layers % len(pattern) == 0 else len(pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        vocab_pad_multiple=32,
        dtype="float32",
        remat="none",
        softmax_blk=64,
        chimera=dataclasses.replace(
            cfg.chimera,
            feature_map=dataclasses.replace(cfg.chimera.feature_map, m=16),
            chunk_size=16,
            n_global=8,
            sig_bits=16,
            match_hamming=8,
        ),
    )
    if cfg.moe_experts:
        # capacity_factor = E makes the capacity drop-free so smoke tests can
        # assert decode == teacher-forced forward exactly
        replace.update(
            moe_experts=4, moe_top_k=2, moe_d_ff=64,
            moe_shared_experts=min(cfg.moe_shared_experts, 1),
            capacity_factor=4.0,
        )
    if cfg.attention_kind == "mla":
        replace.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                       v_head_dim=16)
    if cfg.encoder_layers:
        replace.update(encoder_layers=2)
    if "mamba" in pattern:
        replace.update(mamba_d_state=8, mamba_chunk=8, mamba_expand=2)
    return dataclasses.replace(cfg, **replace)
