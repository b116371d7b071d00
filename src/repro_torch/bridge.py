"""Parameters and rules across the package boundary, as numpy.

The JAX package's model and classifier parameters are nested dicts whose
leaves are arrays; the port keeps the same nesting, names and layouts with
torch tensors.  The caller converts the JAX leaves to numpy first (for example
``jax.tree_util.tree_map(np.asarray, params)``), so this module needs
neither jax nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import symbolic
from repro_torch.core.chimera_attention import ChimeraAttentionConfig
from repro_torch.core.feature_maps import FeatureMapConfig
from repro_torch.train.classifier import ClassifierConfig


def arch_from_reference(ref) -> ArchConfig:
    """The port's ArchConfig from the JAX package's (read by attribute, so
    no import of the JAX package is needed), MLA widths, the Mamba fields,
    the enc-dec fields (``encoder_layers``, ``encoder_seq_fraction``),
    ``remat`` and ``softmax_blk`` included.  ``swa_backend`` is dropped: the
    device of the tensors chooses the kernel or its plain version."""
    ch, fm = ref.chimera, ref.chimera.feature_map
    if ref.use_chimera and (not (ch.use_local and ch.use_stream) or ch.expand_kv):
        raise NotImplementedError("the port runs Chimera with local + stream, no expand_kv")
    return ArchConfig(
        name=ref.name, family=ref.family, n_layers=ref.n_layers, d_model=ref.d_model,
        n_heads=ref.n_heads, n_kv_heads=ref.n_kv_heads, d_ff=ref.d_ff,
        vocab_size=ref.vocab_size, d_head=ref.d_head,
        vocab_pad_multiple=ref.vocab_pad_multiple, attention_kind=ref.attention_kind,
        qk_norm=ref.qk_norm, qkv_bias=ref.qkv_bias, sliding_window=ref.sliding_window,
        rope_theta=ref.rope_theta, q_lora_rank=ref.q_lora_rank,
        kv_lora_rank=ref.kv_lora_rank, qk_nope_dim=ref.qk_nope_dim,
        qk_rope_dim=ref.qk_rope_dim, v_head_dim=ref.v_head_dim, moe_experts=ref.moe_experts,
        moe_top_k=ref.moe_top_k,
        moe_every=ref.moe_every, moe_shared_experts=ref.moe_shared_experts,
        moe_d_ff=ref.moe_d_ff, moe_first_dense=ref.moe_first_dense,
        capacity_factor=ref.capacity_factor,
        block_pattern=tuple(ref.block_pattern), mamba_d_state=ref.mamba_d_state,
        mamba_d_conv=ref.mamba_d_conv, mamba_expand=ref.mamba_expand,
        mamba_dt_rank=ref.mamba_dt_rank, mamba_chunk=ref.mamba_chunk,
        encoder_layers=ref.encoder_layers, encoder_seq_fraction=ref.encoder_seq_fraction,
        use_chimera=ref.use_chimera,
        chimera=ChimeraAttentionConfig(
            feature_map=FeatureMapConfig(
                kind=fm.kind, m=fm.m, input_scale=fm.input_scale,
                codebook_size=fm.codebook_size, codebook_bits=fm.codebook_bits,
                orthogonal=fm.orthogonal,
            ),
            chunk_size=ch.chunk_size, n_global=ch.n_global, sig_bits=ch.sig_bits,
            match_hamming=ch.match_hamming, gamma=ch.gamma,
        ),
        norm_type=ref.norm_type, tie_embeddings=ref.tie_embeddings, dtype=ref.dtype,
        remat=ref.remat, softmax_blk=ref.softmax_blk,
    )


def classifier_config_from_reference(ref) -> ClassifierConfig:
    return ClassifierConfig(
        arch=arch_from_reference(ref.arch), n_classes=ref.n_classes,
        marker_base=ref.marker_base, sig_words=ref.sig_words, lambda_h=ref.lambda_h,
    )


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays (a JAX model or classifier pytree) -> the
    same nesting of tensors on ``device`` (``None`` means ``"cuda"``;
    without a GPU it raises): float leaves as float32, signed integer leaves
    (a fixed-point codebook table, an optimizer's step) in their own dtype.
    Every leaf is converted, the MoE tree's stacked expert tensors and its
    0-d ``_moe`` marker included, an MLA block's ``q_down``, ``q_norm``,
    ``q_up``, ``kv_down``, ``kv_norm``, ``k_up``, ``v_up``, ``wo`` and
    ``chimera``, a Mamba block's ``A_log``, ``D``, ``conv_w``, ``conv_b``
    and ``dt_proj`` (with its bias), an sLSTM block's ``r``, and the
    enc-dec tree's ``enc_in``, ``enc_blocks``, ``enc_norm`` and each decoder
    block's ``cross`` and ``ln_x`` (a LayerNorm's ``bias`` among them), under
    their own names; a leaf that is not an
    array, or of another dtype, raises, so nothing is silently dropped."""
    device = resolve_device(device, "params_from_jax")

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (np.ndarray, np.generic)):
            a = np.asarray(t)
            if a.dtype.kind == "f":
                return torch.from_numpy(np.array(a, np.float32)).to(device)
            if a.dtype.kind == "i":
                return torch.from_numpy(np.array(a)).to(device)
            raise TypeError(f"params_from_jax: parameter leaf of dtype {a.dtype}")
        raise TypeError(f"params_from_jax: unexpected leaf {type(t).__name__}")

    return conv(tree)


def rules_from_numpy(values, masks, weights, hard, device=None) -> symbolic.RuleSet:
    """A JAX ``RuleSet``'s arrays (uint32 words, float weights, bool hard
    flags) -> the port's RuleSet with int32 bit-pattern words, on ``device``
    (``None`` means ``"cuda"``; without a GPU it raises)."""
    device = resolve_device(device, "rules_from_numpy")
    return symbolic.RuleSet(
        values=symbolic.uint32_to_int32(values),
        masks=symbolic.uint32_to_int32(masks),
        weights=torch.from_numpy(np.array(weights, np.float32)),
        hard=torch.from_numpy(np.array(hard, bool)),
    ).to(device)


def quant_state_from_numpy(S_q, S_scale, Z_q, Z_scale, k_buf, v_buf, count, device=None):
    """A JAX ``QuantChimeraState``'s arrays, as numpy in its flatten order ->
    the port's :class:`~repro_torch.core.state_quant.QuantChimeraState` on
    ``device`` (``None`` means ``"cuda"``; without a GPU it raises).  The
    ints and scales keep their dtypes; bfloat16 ring buffers (numpy's
    ``ml_dtypes`` bfloat16) cross through float32, which holds them exactly."""
    from repro_torch.core.state_quant import QuantChimeraState

    device = resolve_device(device, "quant_state_from_numpy")

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        if a.dtype.kind not in "fi":
            raise TypeError(f"quant_state_from_numpy: leaf of dtype {a.dtype}")
        return torch.from_numpy(np.array(a))

    leaves = (S_q, S_scale, Z_q, Z_scale, k_buf, v_buf, count)
    return QuantChimeraState(*(conv(a).to(device) for a in leaves))
