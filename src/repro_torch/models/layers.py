"""Shared layers (port of ``repro.models.layers``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts: a dense layer is ``{"w": (d_in, d_out)[, "b": (d_out,)]}``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def init_dense(
    g: torch.Generator, d_in: int, d_out: int, bias: bool = False,
    scale: Optional[float] = None, device="cpu",
) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": (torch.randn((d_in, d_out), generator=g) * scale).to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def init_norm(d: int, device="cpu") -> Params:
    return {"scale": torch.ones((d,), device=device)}


def apply_norm(params: Params, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-6):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported")
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params["scale"].to(x.dtype)


def init_embedding(g: torch.Generator, vocab: int, d: int, device="cpu") -> Params:
    return {"table": (torch.randn((vocab, d), generator=g) * 0.02).to(device)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def init_mlp(g: torch.Generator, d: int, d_ff: int, device="cpu") -> Dict[str, Params]:
    return {
        "wi": init_dense(g, d, d_ff, device=device),
        "wg": init_dense(g, d, d_ff, device=device),
        "wo": init_dense(g, d_ff, d, device=device),
    }


def mlp(params: Dict[str, Params], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    h = torch.nn.functional.silu(dense(params["wg"], x)) * dense(params["wi"], x)
    return dense(params["wo"], h)


def rope_frequencies(d_head: int, theta: float = 1e4, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., T, d) with d even; positions: broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # (d/2,)
    angles = positions[..., None].float() * freqs  # (..., T, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)
