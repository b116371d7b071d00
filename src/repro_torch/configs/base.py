"""Architecture configuration: the fields of ``repro.configs.base.ArchConfig``
that the dense Chimera decode and training paths read, with the same names and defaults.

Families other than a dense Chimera stack (MoE, SSM, MLA, enc-dec) are not
ported yet, so their fields are absent here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.chimera_attention import ChimeraAttentionConfig
from repro_torch.core.feature_maps import FeatureMapConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads
    vocab_pad_multiple: int = 256

    # attention
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4

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
    dtype: str = "float32"

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
