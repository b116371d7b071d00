"""Attention layer, Chimera or softmax sliding-window (port of
``repro.models.attention``: ``init_attention`` :165, ``_project_qkv`` :193,
``attention_layer`` :207, ``init_attention_cache`` :234,
``attention_decode`` :249, ``attention_prefill`` :466 and
``_fill_kv_cache`` :495).

Two modes are ported.  The causal Chimera transform (``use_chimera``, the
default of every config): its prefill is ``chimera_prefill`` (the full
chunks through the ``chimera_attention`` kernel, at chunks of 16 to 256
tokens), and its decode cache is the bounded ``ChimeraState`` that
``decode_step`` updates.  Softmax attention with a sliding window
(``attention_kind="swa"`` with ``use_chimera=False``), whose prefill runs
through the ``window_attention`` kernel and whose decode keeps a ring KV
cache of ``min(max_len, window)`` tokens.  The other softmax paths
(full-causal ``blockwise_softmax_attention``, MLA, cross-attention) raise
``NotImplementedError``; they wait for ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import chimera_attention as chimera
from repro_torch.kernels.window_attention.ops import sliding_window_attention
from repro_torch.models.layers import (
    apply_norm,
    apply_rope,
    dense,
    init_dense,
    init_norm,
    promote,
)

Params = dict
KVCache = Dict[str, torch.Tensor]  # {"k", "v": (B, Hkv, length, dh)}

NEG_INF = -1e30


def _is_swa(cfg: ArchConfig) -> bool:
    return cfg.attention_kind == "swa" and cfg.sliding_window > 0


def require_ported(cfg: ArchConfig) -> None:
    if cfg.attention_kind not in ("gqa", "swa"):
        raise NotImplementedError(f"attention_kind {cfg.attention_kind!r} is not ported "
                                  "(ROADMAP Queue 1 item 11)")
    if not cfg.use_chimera and not _is_swa(cfg):
        raise NotImplementedError(
            "softmax attention is ported for sliding-window (swa) configs only; full-causal "
            "blockwise_softmax_attention waits for ROADMAP Queue 1 item 11")


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
    require_ported(cfg)
    if not causal:
        raise NotImplementedError("non-causal attention is not ported (ROADMAP Queue 1 item 11)")
    B, T, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x, positions)
    if cfg.use_chimera:
        o = chimera.chimera_attention(cfg.chimera, params["chimera"], q, k, v)
    else:
        o = _swa(cfg, q, k, v)
    o = o.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.head_dim)
    return dense(params["wo"], o)


def cache_length(cfg: ArchConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_attention_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32, device="cpu",
    lead: Tuple[int, ...] = (),
) -> Union[chimera.ChimeraState, KVCache]:
    """Chimera mode: bounded state (ring + (S, Z)), independent of flow length.
    Softmax SWA mode: a ring KV cache of ``min(max_len, window)`` tokens.
    ``lead`` prepends axes (the model's stacked layer axis)."""
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
        # as the reference does, the ring slot and the validity of every
        # batch row come from position[0] (attention.py:264-276)
        ck, cv = cache["k"], cache["v"]
        length = ck.shape[2]
        p0 = position[0].to(torch.long)
        slot = p0 % length
        ck.index_copy_(2, slot.reshape(1), k[:, :, :1].to(ck.dtype))
        cv.index_copy_(2, slot.reshape(1), v[:, :, :1].to(cv.dtype))
        idx = torch.arange(length, device=ck.device)
        kpos = torch.where(idx <= slot, p0 - (slot - idx), p0 + (length - slot) + idx - length)
        valid = ((idx <= slot) | (p0 >= length)) & (p0 - kpos < cfg.sliding_window)
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
    the banded softmax and its ring KV cache."""
    require_ported(cfg)
    B, T, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x, positions)
    if cfg.use_chimera:
        o, cache = chimera.chimera_prefill(cfg.chimera, params["chimera"], q, k, v)
    else:
        o = _swa(cfg, q, k, v)
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
