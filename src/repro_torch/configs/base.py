"""Architecture configuration: the fields of ``repro.configs.base.ArchConfig``
that the ported paths read, with the same names and defaults: stacks of
attention blocks (GQA, SWA or MLA attention, Chimera or softmax, dense or
MoE MLP), Mamba blocks and xLSTM's mLSTM and sLSTM blocks, for decode,
prefill and training, and the encoder-decoder stack (whisper-tiny:
``encoder_layers`` > 0) for its forward and decode.

``swa_backend`` and ``scan_layers`` are absent: the device of the tensors
chooses between a kernel and its plain version, and the port loops over the
layer groups.  ``remat`` is
JAX's: ``"full"`` (the default) recomputes each layer group's forward in
the backward pass (``torch.utils.checkpoint``, as
``jax.checkpoint`` around the scan body), ``"none"`` saves every layer's
activations.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.chimera_attention import ChimeraAttentionConfig
from repro_torch.core.feature_maps import FeatureMapConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads
    vocab_pad_multiple: int = 256

    # attention
    attention_kind: str = "gqa"  # gqa | swa | mla
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0  # swa only
    rope_theta: float = 1e4

    # MLA (MiniCPM3 / DeepSeek style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1  # MoE MLP every k-th layer (1 = all layers)
    moe_shared_experts: int = 0
    moe_d_ff: int = 0  # expert hidden dim (0 → d_ff)
    moe_first_dense: int = 0  # first N layers use dense MLP
    capacity_factor: float = 1.25

    # hybrid / SSM block pattern, repeated to n_layers.  entries:
    #   "attn" | "mamba" | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)

    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0  # 0 → ceil(d_model / 16)
    mamba_chunk: int = 64

    # enc-dec (whisper): encoder layers with non-causal self-attention;
    # decoder layers get cross-attention to the encoder output
    encoder_layers: int = 0
    encoder_seq_fraction: float = 0.5  # split of seq_len for train/prefill

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

    # execution
    remat: str = "full"  # none | full
    softmax_blk: int = 1024  # kv-block size of blockwise_softmax_attention's plain version

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

    def layer_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe_experts == 0:
            return False
        if layer_idx < self.moe_first_dense:
            return False
        return (layer_idx - self.moe_first_dense) % self.moe_every == 0

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head), the JAX
        package's formula."""
        d, dff, V = self.d_model, self.d_ff, self.padded_vocab
        n_attn_params = 0
        n_mlp = 0
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.attention_kind == "mla":
                    dn, dr = self.qk_nope_dim, self.qk_rope_dim
                    dv = self.v_head_dim or self.head_dim
                    r = self.kv_lora_rank
                    qin = self.q_lora_rank or d
                    n_attn_params += d * (self.q_lora_rank or 0)
                    n_attn_params += qin * self.n_heads * (dn + dr)
                    n_attn_params += d * (r + dr) + r * self.n_heads * (dn + dv)
                    n_attn_params += self.n_heads * dv * d
                else:
                    hd = self.head_dim
                    n_attn_params += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                    n_attn_params += self.n_heads * hd * d
            elif kind == "mamba":
                di = self.mamba_expand * d
                n_attn_params += d * 2 * di + di * self.mamba_d_conv
                dtr = self.mamba_dt_rank or -(-d // 16)
                n_attn_params += di * (2 * self.mamba_d_state + dtr) + dtr * di
                n_attn_params += di * self.mamba_d_state + di  # A, D
                n_attn_params += di * d
            elif kind in ("mlstm", "slstm"):
                di = 2 * d
                n_attn_params += d * 2 * di + 4 * di * (di // 4) + di * d
            if kind in ("attn", "mamba"):
                if self.layer_is_moe(i):
                    e_ff = self.moe_d_ff or dff
                    n_mlp += self.moe_experts * 3 * d * e_ff
                    n_mlp += self.moe_shared_experts * 3 * d * e_ff
                    n_mlp += d * self.moe_experts
                elif dff:
                    n_mlp += 3 * d * dff
        n_embed = V * d * (1 if self.tie_embeddings else 2)
        return n_embed + n_attn_params + n_mlp
