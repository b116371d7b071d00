"""Attention layers: softmax GQA / SWA / MLA and the Chimera transform (port
of ``repro.models.attention``: ``_grouped`` :37, ``blockwise_softmax_attention``
:42, ``_masked_softmax_attention`` :89, ``init_attention`` :165,
``_project_qkv`` :193, ``attention_layer`` :207, ``init_attention_cache``
:234, ``attention_decode`` :249, ``init_mla`` :289, ``_mla_qkv`` :317,
``mla_attention_layer`` :340, ``init_mla_cache`` :355, ``mla_decode`` :367,
``attention_prefill`` :466, ``_fill_kv_cache`` :495 and ``mla_prefill`` :513).

Every mode is ported.  The Chimera transform (``use_chimera``, the
default of every config), on GQA/SWA heads or on MLA's materialized heads
(q/k width ``qk_nope_dim + qk_rope_dim``, v width ``v_head_dim``, Gq 1):
its prefill is ``chimera_prefill`` (the full chunks through the
``chimera_attention`` kernel, at chunks of 16 to 256 tokens), and its decode
cache is the bounded ``ChimeraState`` that ``decode_step`` updates.  Softmax
attention with a sliding window (``attention_kind="swa"``): the banded
softmax through the ``window_attention`` kernel, and a ring KV cache of
``min(max_len, window)`` tokens.  Full-causal softmax (``gqa``, or MLA with
``use_chimera=False``): ``blockwise_softmax_attention``, which on the card
runs the same ``window_attention`` kernel with the window at the sequence
length, and a ``max_len`` KV cache, or MLA's latent cache ``{"c_kv",
"k_r"}`` with the absorbed-matmul decode.  Non-causal softmax (the encoder
of whisper-tiny, and its cross-attention with ``use_chimera=False``):
``blockwise_softmax_attention(causal=False)``, queries and keys of their
own lengths, through the ``window_attention`` kernels' non-causal mode on
the card (forward, and backward in training).  Cross-attention (``init_cross_attention`` :408,
``cross_attention_layer`` :425 and ``encode_cross_kv`` :453): the encoder's
keys and values are computed once per request; the Chimera branch
linearises it over them in plain tensor code, as JAX does in jnp.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import chimera_attention as chimera
from repro_torch.core.feature_maps import _normalize, apply_feature_map, init_feature_map
from repro_torch.kernels.window_attention.ops import noncausal_attention, sliding_window_attention
from repro_torch.models.layers import (
    apply_norm,
    apply_rope,
    dense,
    init_dense,
    init_norm,
    promote,
)

Params = dict
KVCache = Dict[str, torch.Tensor]  # {"k", "v": (B, Hkv, length, dh)}; MLA {"c_kv", "k_r"}

NEG_INF = -1e30


def _is_swa(cfg: ArchConfig) -> bool:
    return cfg.attention_kind == "swa" and cfg.sliding_window > 0


def require_ported(cfg: ArchConfig) -> None:
    if cfg.attention_kind not in ("gqa", "swa", "mla"):
        raise NotImplementedError(f"attention_kind {cfg.attention_kind!r} is not ported: the "
                                  "port has gqa, swa and mla")


# --------------------------------------------------------------------------
# Full-causal and non-causal softmax attention
# --------------------------------------------------------------------------

def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    B, H, T, d = q.shape
    return q.reshape(B, n_kv, H // n_kv, T, d)


def _masked_softmax_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Dense (T, Tk) scores; causal with the rows aligned to the keys' end,
    else unmasked (the JAX function without a window)."""
    B, H, T, dh = q.shape
    n_kv, Tk = k.shape[1], k.shape[2]
    qg = _grouped(q, n_kv)
    s = torch.einsum("bhgid,bhjd->bhgij", qg, k) / math.sqrt(dh)
    if causal:
        ii = torch.arange(T, device=q.device)[:, None] + (Tk - T)  # align ends (prefill offsets)
        jj = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where((ii >= jj)[None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgij,bhjd->bhgid", w, v)
    return out.reshape(B, H, T, v.shape[-1])


def blockwise_softmax_attention_plain(
    q: torch.Tensor,  # (B, H, T, dh)
    k: torch.Tensor,  # (B, Hkv, Tk, dh)
    v: torch.Tensor,  # (B, Hkv, Tk, dv)
    blk: int = 1024,
    causal: bool = True,
) -> torch.Tensor:
    """The plain version of :func:`blockwise_softmax_attention`, the JAX
    function block for block: kv blocks of ``blk`` keys with the online
    max, sum and accumulator, ``NEG_INF`` on masked scores (causal only),
    and the dense form where ``Tk % blk != 0 or Tk <= blk``.  The running max, sum
    and accumulator are float32 (float64 for float64 inputs), where JAX
    keeps them in q's dtype: the kernel this stands beside keeps them in
    float32 whatever its inputs, and every config gives float32 queries
    (the float32 weights promote the projections), where the two agree."""
    B, H, T, dh = q.shape
    n_kv, Tk, dv = k.shape[1], k.shape[2], v.shape[-1]
    out_dtype = q.dtype
    q, k, v = (x.to(torch.promote_types(x.dtype, torch.float32)) for x in (q, k, v))
    if Tk % blk != 0 or Tk <= blk:
        return _masked_softmax_attention(q, k, v, causal).to(out_dtype)
    qg = _grouped(q, n_kv)
    scale = 1.0 / math.sqrt(dh)
    rows = torch.arange(T, device=q.device)
    m = torch.full((B, n_kv, H // n_kv, T), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, n_kv, H // n_kv, T, dv), dtype=q.dtype, device=q.device)
    for j in range(Tk // blk):
        k_j, v_j = k[:, :, j * blk:(j + 1) * blk], v[:, :, j * blk:(j + 1) * blk]
        s = torch.einsum("bhgid,bhjd->bhgij", qg, k_j) * scale
        if causal:
            cols = j * blk + torch.arange(blk, device=q.device)
            s = torch.where((rows[:, None] >= cols[None, :])[None, None, None], s, NEG_INF)
        m_cur = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgij,bhjd->bhgid", p, v_j)
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, T, dv).to(out_dtype)


def blockwise_softmax_attention(
    q: torch.Tensor,  # (B, H, T, dh)
    k: torch.Tensor,  # (B, Hkv, Tk, dh)
    v: torch.Tensor,  # (B, Hkv, Tk, dv)
    blk: int = 1024,
    causal: bool = True,
) -> torch.Tensor:
    """Softmax attention, query head h on kv-head h // (H / Hkv), scale
    1/sqrt(dh): (B, H, T, dv) in q's dtype.  Causal (T == Tk): on the card
    ``csrc/window_attention.cu`` with the window Tk (a band of width W >= T
    is causal attention, as the JAX package's ``tests/test_kernels.py:115``
    holds of its window kernel).  Non-causal (any T and Tk): on the card
    the same kernels' non-causal mode, differentiable.  On the CPU both run
    :func:`blockwise_softmax_attention_plain`."""
    if q.device.type == "cpu":
        return blockwise_softmax_attention_plain(q, k, v, blk, causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if not causal:
        return noncausal_attention(q, k, v)
    return sliding_window_attention(q, k, v, k.shape[2])


# --------------------------------------------------------------------------
# GQA / SWA attention layer (with optional Chimera transform)
# --------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, g: torch.Generator, device="cpu") -> Params:
    require_ported(cfg)
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init_dense(g, d, H * dh, bias=cfg.qkv_bias, device=device),
        "wk": init_dense(g, d, Hkv * dh, bias=cfg.qkv_bias, device=device),
        "wv": init_dense(g, d, Hkv * dh, bias=cfg.qkv_bias, device=device),
        "wo": init_dense(g, H * dh, d, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm(dh, device)
        p["k_norm"] = init_norm(dh, device)
    if cfg.use_chimera:
        p["chimera"] = chimera.init_chimera_attention(cfg.chimera, Hkv, dh, dh, g, device)
    return p


def _project_qkv(cfg: ArchConfig, params: Params, x: torch.Tensor, positions: torch.Tensor):
    B, T, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(params["wq"], x).reshape(B, T, H, dh).transpose(1, 2)
    k = dense(params["wk"], x).reshape(B, T, Hkv, dh).transpose(1, 2)
    v = dense(params["wv"], x).reshape(B, T, Hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = apply_norm(params["q_norm"], q, "rmsnorm")
        k = apply_norm(params["k_norm"], k, "rmsnorm")
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _swa(cfg: ArchConfig, q, k, v) -> torch.Tensor:
    """The banded softmax through the kernel's wrapper (K and V per kv-head)."""
    return sliding_window_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), cfg.sliding_window
    )


def attention_layer(
    cfg: ArchConfig,
    params: Params,
    x: torch.Tensor,  # (B, T, d)
    positions: torch.Tensor,  # (B, T)
    causal: bool = True,
) -> torch.Tensor:
    """Chimera or the banded softmax only when causal, as JAX routes them;
    every other case, the encoder's non-causal self-attention among them,
    takes the blockwise softmax."""
    require_ported(cfg)
    B, T, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x, positions)
    if cfg.use_chimera and causal:
        o = chimera.chimera_attention(cfg.chimera, params["chimera"], q, k, v)
    elif _is_swa(cfg) and causal:
        o = _swa(cfg, q, k, v)
    else:
        o = blockwise_softmax_attention(q, k, v, cfg.softmax_blk, causal=causal)
    o = o.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.head_dim)
    return dense(params["wo"], o)


def cache_length(cfg: ArchConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_attention_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32, device="cpu",
    lead: Tuple[int, ...] = (),
) -> Union[chimera.ChimeraState, KVCache]:
    """Chimera mode: bounded state (ring + (S, Z)), independent of flow length.
    Softmax mode: a KV cache of ``max_len`` tokens, a ring of
    ``min(max_len, window)`` with a sliding window.  ``lead`` prepends axes
    (the model's stacked layer axis)."""
    require_ported(cfg)
    dh = cfg.head_dim
    if cfg.use_chimera:
        return chimera.init_decode_state(
            cfg.chimera, batch, cfg.n_kv_heads, dh, dh, dtype, device, lead
        )
    length = cache_length(cfg, max_len)
    if length < 1:
        raise ValueError(f"init_attention_cache: max_len must be >= 1, got {max_len}")
    shape = lead + (batch, cfg.n_kv_heads, length, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(
    cfg: ArchConfig,
    params: Params,
    x_t: torch.Tensor,  # (B, 1, d)
    position: torch.Tensor,  # (B,) current position
    cache,  # ChimeraState or KVCache, updated in place
) -> torch.Tensor:
    require_ported(cfg)
    B = x_t.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, params, x_t, position[:, None])
    if cfg.use_chimera:
        o = chimera.chimera_decode_step(
            cfg.chimera, params["chimera"], q[:, :, 0].contiguous(), k[:, :, 0].contiguous(),
            v[:, :, 0].contiguous(), cache,
        )
    else:
        # as the reference does, the cache slot and the validity of every
        # batch row come from position[0] (attention.py:264-276)
        ck, cv = cache["k"], cache["v"]
        length = ck.shape[2]
        p0 = position[0].to(torch.long)
        idx = torch.arange(length, device=ck.device)
        if cfg.sliding_window:
            slot = p0 % length
            kpos = torch.where(idx <= slot, p0 - (slot - idx),
                               p0 + (length - slot) + idx - length)
            valid = ((idx <= slot) | (p0 >= length)) & (p0 - kpos < cfg.sliding_window)
        else:
            # jax's dynamic update clamps its index into the cache
            slot = torch.clamp(p0, max=length - 1)
            valid = idx <= p0
        ck.index_copy_(2, slot.reshape(1), k[:, :, :1].to(ck.dtype))
        cv.index_copy_(2, slot.reshape(1), v[:, :, :1].to(cv.dtype))
        qg = q[:, :, 0].reshape(B, Hkv, H // Hkv, dh)
        qg, ckp, cvp = promote(qg, ck, cv)
        s = torch.einsum("bhgd,bhjd->bhgj", qg, ckp) / math.sqrt(dh)
        s = torch.where(valid[None, None, None], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgj,bhjd->bhgd", w, cvp).reshape(B, H, dh)
    o = o.reshape(B, 1, H * dh)
    return dense(params["wo"], o)


def attention_prefill(
    cfg: ArchConfig,
    params: Params,
    x: torch.Tensor,  # (B, T, d)
    positions: torch.Tensor,  # (B, T)
    max_len: int,
):
    """Forward over the whole prompt + the decode cache to continue from:
    Chimera's chunked prefill and its bounded state (``max_len`` unused), or
    the banded or full-causal softmax and its KV cache."""
    require_ported(cfg)
    B, T, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x, positions)
    if cfg.use_chimera:
        o, cache = chimera.chimera_prefill(cfg.chimera, params["chimera"], q, k, v)
    else:
        o = (_swa(cfg, q, k, v) if _is_swa(cfg)
             else blockwise_softmax_attention(q, k, v, cfg.softmax_blk))
        cache = _fill_kv_cache(cfg, k, v, max_len)
    o = o.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.head_dim)
    return dense(params["wo"], o), cache


def _fill_kv_cache(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor, max_len: int) -> KVCache:
    B, Hkv, T, dh = k.shape
    length = cache_length(cfg, max_len)
    ck = k.new_zeros((B, Hkv, length, dh))
    cv = v.new_zeros((B, Hkv, length, v.shape[-1]))
    if cfg.sliding_window and T > length:
        # ring semantics: keep the last `length` tokens at their mod-slots
        slots = torch.arange(T - length, T, device=k.device) % length
        ck[:, :, slots] = k[:, :, -length:]
        cv[:, :, slots] = v[:, :, -length:]
    else:
        keep = min(T, length)
        ck[:, :, :keep] = k[:, :, :keep]
        cv[:, :, :keep] = v[:, :, :keep]
    return {"k": ck, "v": cv}


# --------------------------------------------------------------------------
# Cross-attention (enc-dec): the encoder's keys are the static global set
# --------------------------------------------------------------------------

def init_cross_attention(cfg: ArchConfig, g: torch.Generator, device="cpu") -> Params:
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    p = {
        "wq": init_dense(g, d, H * dh, device=device),
        "wk": init_dense(g, d, H * dh, device=device),
        "wv": init_dense(g, d, H * dh, device=device),
        "wo": init_dense(g, H * dh, d, device=device),
    }
    if cfg.use_chimera:
        p["fm"] = init_feature_map(cfg.chimera.feature_map, dh, g, device)
    return p


def cross_attention_layer(
    cfg: ArchConfig,
    params: Params,
    x: torch.Tensor,  # (B, Tq, d) decoder states
    enc_kv: Tuple[torch.Tensor, torch.Tensor],  # precomputed (k, v): (B, H, Te, dh)
) -> torch.Tensor:
    """Chimera: attention linearised over the encoder's keys, which are a
    static set per request (the paper's TCAM-resident G, Eq. 14 right
    term): s = phi(q) phi(k)^T (B, H, Tq, Te), then s v over s's row sums
    plus gamma, in JAX's order.  Softmax: the non-causal blockwise softmax
    (Tq against Te keys; Tq = 1 in decode)."""
    B, Tq, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    q = dense(params["wq"], x).reshape(B, Tq, H, dh).transpose(1, 2)
    k, v = enc_kv
    if cfg.use_chimera:
        fmc = cfg.chimera.feature_map
        pq = apply_feature_map(fmc, params["fm"], _normalize(q, fmc.input_scale))
        pk = apply_feature_map(fmc, params["fm"], _normalize(k, fmc.input_scale))
        pq, pk, vp = promote(pq, pk, v)
        s = torch.einsum("bhim,bhjm->bhij", pq, pk)
        num = torch.einsum("bhij,bhjd->bhid", s, vp)
        den = torch.sum(s, dim=-1)
        o = num / (den[..., None] + cfg.chimera.gamma)
    else:
        o = blockwise_softmax_attention(q, k, v, cfg.softmax_blk, causal=False)
    o = o.transpose(1, 2).reshape(B, Tq, H * dh)
    return dense(params["wo"], o)


def encode_cross_kv(cfg: ArchConfig, params: Params, enc_out: torch.Tensor):
    """The encoder output's cross-attention keys and values, (B, H, Te, dh)
    each."""
    B, Te, _ = enc_out.shape
    H, dh = cfg.n_heads, cfg.head_dim
    k = dense(params["wk"], enc_out).reshape(B, Te, H, dh).transpose(1, 2)
    v = dense(params["wv"], enc_out).reshape(B, Te, H, dh).transpose(1, 2)
    return k, v


# --------------------------------------------------------------------------
# Multi-head Latent Attention (MiniCPM3 / DeepSeek family)
# --------------------------------------------------------------------------

def _mla_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(qk_nope_dim, qk_rope_dim, v width, kv_lora_rank)."""
    return cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim or cfg.head_dim, cfg.kv_lora_rank


def init_mla(cfg: ArchConfig, g: torch.Generator, device="cpu") -> Params:
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = _mla_dims(cfg)
    qr = cfg.q_lora_rank
    p = {}
    if qr:
        p["q_down"] = init_dense(g, d, qr, device=device)
        p["q_norm"] = init_norm(qr, device)
        p["q_up"] = init_dense(g, qr, H * (dn + dr), device=device)
    else:
        p["q_up"] = init_dense(g, d, H * (dn + dr), device=device)
    p["kv_down"] = init_dense(g, d, r + dr, device=device)
    p["kv_norm"] = init_norm(r, device)
    p["k_up"] = init_dense(g, r, H * dn, device=device)
    p["v_up"] = init_dense(g, r, H * dv, device=device)
    p["wo"] = init_dense(g, H * dv, d, device=device)
    if cfg.use_chimera:
        p["chimera"] = chimera.init_chimera_attention(cfg.chimera, H, dn + dr, dv, g, device)
    return p


def _mla_qkv(cfg: ArchConfig, params: Params, x: torch.Tensor, positions: torch.Tensor):
    """Materialized heads ``q, k`` (B, H, T, dn + dr) and ``v`` (B, H, T, dv),
    the latent ``c_kv`` (B, T, r) and the shared rope key ``k_r`` (B, 1, T,
    dr)."""
    B, T, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv, r = _mla_dims(cfg)
    if cfg.q_lora_rank:
        ql = apply_norm(params["q_norm"], dense(params["q_down"], x), "rmsnorm")
    else:
        ql = x
    q = dense(params["q_up"], ql).reshape(B, T, H, dn + dr).transpose(1, 2)
    q_n, q_r = q[..., :dn], q[..., dn:]
    q_r = apply_rope(q_r, positions[:, None, :], cfg.rope_theta)
    kv = dense(params["kv_down"], x)
    c_kv = apply_norm(params["kv_norm"], kv[..., :r], "rmsnorm")
    k_r = apply_rope(kv[..., r:][:, None], positions[:, None, :], cfg.rope_theta)
    k_n = dense(params["k_up"], c_kv).reshape(B, T, H, dn).transpose(1, 2)
    v = dense(params["v_up"], c_kv).reshape(B, T, H, dv).transpose(1, 2)
    q_full = torch.cat([q_n, q_r], dim=-1)
    k_full = torch.cat([k_n, k_r.expand(B, H, T, dr).to(k_n.dtype)], dim=-1)
    return q_full, k_full, v, c_kv, k_r


def _mla_out(cfg: ArchConfig, params: Params, o: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dv) heads -> the output projection, (B, T, d)."""
    B, H, T, dv = o.shape
    return dense(params["wo"], o.transpose(1, 2).reshape(B, T, H * dv))


def mla_attention_layer(
    cfg: ArchConfig, params: Params, x: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    q, k, v, _, _ = _mla_qkv(cfg, params, x, positions)
    if cfg.use_chimera:
        o = chimera.chimera_attention(cfg.chimera, params["chimera"], q, k, v)
    else:
        o = blockwise_softmax_attention(q, k, v, cfg.softmax_blk)
    return _mla_out(cfg, params, o)


def init_mla_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32, device="cpu",
    lead: Tuple[int, ...] = (),
) -> Union[chimera.ChimeraState, KVCache]:
    """Chimera mode: the bounded state on the materialized heads (H heads,
    q/k width dn + dr, v width dv).  Softmax mode: the latent cache, ``c_kv``
    (batch, max_len, r) and ``k_r`` (batch, max_len, dr).  ``lead``
    prepends axes (the model's stacked layer axis)."""
    dn, dr, dv, r = _mla_dims(cfg)
    if cfg.use_chimera:
        return chimera.init_decode_state(cfg.chimera, batch, cfg.n_heads, dn + dr, dv, dtype,
                                         device, lead)
    return {"c_kv": torch.zeros(lead + (batch, max_len, r), dtype=dtype, device=device),
            "k_r": torch.zeros(lead + (batch, max_len, dr), dtype=dtype, device=device)}


def mla_decode(
    cfg: ArchConfig,
    params: Params,
    x_t: torch.Tensor,  # (B, 1, d)
    position: torch.Tensor,  # (B,) current position
    cache,  # ChimeraState or the latent cache, updated in place
) -> torch.Tensor:
    """MLA decode.  Chimera mode: the bounded state on the materialized heads.
    Softmax mode: the latent cache with the absorbed-matmul trick (scores and
    values in the rank-r latent space, MLA's memory saving); as the
    reference does, the slot and the validity of every batch row come from
    position[0] (attention.py:389-402)."""
    B = x_t.shape[0]
    H = cfg.n_heads
    dn, dr, dv, r = _mla_dims(cfg)
    q, k, v, c_kv, k_r = _mla_qkv(cfg, params, x_t, position[:, None])
    if cfg.use_chimera:
        o = chimera.chimera_decode_step(
            cfg.chimera, params["chimera"], q[:, :, 0].contiguous(), k[:, :, 0].contiguous(),
            v[:, :, 0].contiguous(), cache,
        )
        return _mla_out(cfg, params, o[:, :, None])
    cc, cr = cache["c_kv"], cache["k_r"]
    pos = position[0].to(torch.long)
    slot = torch.clamp(pos, max=cc.shape[1] - 1).reshape(1)  # jax clamps the update index
    cc.index_copy_(1, slot, c_kv[:, :1].to(cc.dtype))
    cr.index_copy_(1, slot, k_r[:, 0, :1].to(cr.dtype))
    # absorbed scores: q_n W_kup in the latent space, dotted with the cached c_kv
    w_kup = params["k_up"]["w"].reshape(r, H, dn)
    q_n, q_r, w_kup, ccp, crp = promote(q[:, :, 0, :dn], q[:, :, 0, dn:], w_kup, cc, cr)
    q_lat = torch.einsum("bhd,rhd->bhr", q_n, w_kup)
    s = torch.einsum("bhr,btr->bht", q_lat, ccp) + torch.einsum("bhd,btd->bht", q_r, crp)
    s = s / math.sqrt(dn + dr)
    valid = torch.arange(cc.shape[1], device=cc.device) <= pos
    s = torch.where(valid[None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bht,btr->bhr", w, ccp)  # latent-space values
    w_vup = params["v_up"]["w"].reshape(r, H, dv).to(o_lat.dtype)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_vup).reshape(B, 1, H * dv)
    return dense(params["wo"], o)


def mla_prefill(
    cfg: ArchConfig, params: Params, x: torch.Tensor, positions: torch.Tensor, max_len: int
):
    """Forward over the whole prompt + the decode cache to continue from:
    Chimera's chunked prefill on the materialized heads and its bounded
    state, or the full-causal softmax and the latent cache of the prompt's
    first ``max_len`` tokens."""
    B, T, _ = x.shape
    q, k, v, c_kv, k_r = _mla_qkv(cfg, params, x, positions)
    if cfg.use_chimera:
        o, cache = chimera.chimera_prefill(cfg.chimera, params["chimera"], q, k, v)
    else:
        o = blockwise_softmax_attention(q, k, v, cfg.softmax_blk)
        cc = c_kv.new_zeros((B, max_len, cfg.kv_lora_rank))
        cr = c_kv.new_zeros((B, max_len, cfg.qk_rope_dim))
        keep = min(T, max_len)
        cc[:, :keep] = c_kv[:, :keep]
        cr[:, :keep] = k_r[:, 0, :keep]
        cache = {"c_kv": cc, "k_r": cr}
    return _mla_out(cfg, params, o), cache
