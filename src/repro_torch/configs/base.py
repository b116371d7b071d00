"""Architecture configuration: the fields of ``repro.configs.base.ArchConfig``
that the ported paths read, with the same names and defaults: the dense
Chimera stack (decode and training) and the softmax sliding-window (SWA)
MoE stack of Mixtral (serving).

SSM, MLA and enc-dec are not ported yet, so their fields are absent here,
and so is ``swa_backend``: the device of the tensors chooses between a
kernel and its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.chimera_attention import ChimeraAttentionConfig
from repro_torch.core.feature_maps import FeatureMapConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # "dense", "moe" and "vlm" (a stack of attention blocks) are ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads
    vocab_pad_multiple: int = 256

    # attention
    attention_kind: str = "gqa"  # gqa | swa (mla is not ported)
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0  # swa only
    rope_theta: float = 1e4

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1  # MoE MLP every k-th layer (1 = all layers)
    moe_shared_experts: int = 0
    moe_d_ff: int = 0  # expert hidden dim (0 → d_ff)
    moe_first_dense: int = 0  # first N layers use dense MLP
    capacity_factor: float = 1.25

    block_pattern: Tuple[str, ...] = ("attn",)

    # chimera integration (the paper's technique)
    use_chimera: bool = True
    chimera: ChimeraAttentionConfig = ChimeraAttentionConfig(
        feature_map=FeatureMapConfig(kind="exp_prf", m=128),
        chunk_size=256,
        n_global=32,
    )

    norm_type: str = "rmsnorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.block_pattern)}"
            )
        return self.block_pattern

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.block_pattern)

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe_experts == 0:
            return False
        if layer_idx < self.moe_first_dense:
            return False
        return (layer_idx - self.moe_first_dense) % self.moe_every == 0
