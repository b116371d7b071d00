"""Attention layer with the Chimera transform (port of
``repro.models.attention``: ``init_attention`` :165, ``_project_qkv`` :193,
the causal Chimera branch of ``attention_layer`` :207,
``init_attention_cache`` :234 and the Chimera branch of
``attention_decode`` :249).  Softmax, SWA and MLA are not ported."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import chimera_attention as chimera
from repro_torch.models.layers import apply_norm, apply_rope, dense, init_dense, init_norm

Params = dict


def _require_chimera(cfg: ArchConfig) -> None:
    if not cfg.use_chimera:
        raise NotImplementedError("only the Chimera attention path is ported")


def init_attention(cfg: ArchConfig, g: torch.Generator, device="cpu") -> Params:
    _require_chimera(cfg)
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


def attention_layer(
    cfg: ArchConfig,
    params: Params,
    x: torch.Tensor,  # (B, T, d)
    positions: torch.Tensor,  # (B, T)
    causal: bool = True,
) -> torch.Tensor:
    _require_chimera(cfg)
    if not causal:
        raise NotImplementedError("only causal Chimera attention is ported")
    B, T, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x, positions)
    o = chimera.chimera_attention(cfg.chimera, params["chimera"], q, k, v)
    o = o.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.head_dim)
    return dense(params["wo"], o)


def init_attention_cache(
    cfg: ArchConfig, batch: int, dtype=torch.float32, device="cpu", lead: Tuple[int, ...] = ()
) -> chimera.ChimeraState:
    """Chimera mode: bounded state (ring + (S, Z)), independent of flow length."""
    _require_chimera(cfg)
    dh = cfg.head_dim
    return chimera.init_decode_state(
        cfg.chimera, batch, cfg.n_kv_heads, dh, dh, dtype, device, lead
    )


def attention_decode(
    cfg: ArchConfig,
    params: Params,
    x_t: torch.Tensor,  # (B, 1, d)
    position: torch.Tensor,  # (B,) current position
    cache: chimera.ChimeraState,  # updated in place
) -> torch.Tensor:
    B = x_t.shape[0]
    q, k, v = _project_qkv(cfg, params, x_t, position[:, None])
    q_t = q[:, :, 0].contiguous()
    k_t = k[:, :, 0].contiguous()
    v_t = v[:, :, 0].contiguous()
    o = chimera.chimera_decode_step(cfg.chimera, params["chimera"], q_t, k_t, v_t, cache)
    o = o.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return dense(params["wo"], o)
