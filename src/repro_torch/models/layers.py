"""Shared layers (port of ``repro.models.layers``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts: a dense layer is ``{"w": (d_in, d_out)[, "b": (d_out,)]}``.
Parameters are float32, as JAX draws them; activations may be bfloat16
(``ArchConfig.dtype``), and a product of the two is float32, as jnp's
type promotion makes it.

Random weights are drawn from a ``torch.Generator`` on that generator's
device (a CUDA generator draws on the card) and then moved to ``device``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.utils.checkpoint

Params = Dict[str, torch.Tensor]


def remat_call(on: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``on`` and gradients are enabled: only the inputs are kept, and the
    backward runs ``fn`` again (``jax.checkpoint`` around a scan body)."""
    if on and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def normal(g: torch.Generator, shape, scale: float, device="cpu") -> torch.Tensor:
    """``scale`` times standard normals drawn on ``g``'s device, on ``device``."""
    return (torch.randn(shape, generator=g, device=g.device) * scale).to(device)


def init_dense(
    g: torch.Generator, d_in: int, d_out: int, bias: bool = False,
    scale: Optional[float] = None, device="cpu",
) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal(g, (d_in, d_out), scale, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def promote(*xs: torch.Tensor):
    """The operands in their common type (jnp promotion: bf16 with f32 is f32);
    torch's matmul and einsum refuse mixed types."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    x, w = promote(x, params["w"])
    y = x @ w
    if "b" in params:
        y = y + params["b"]
    return y


def init_norm(d: int, device="cpu", kind: str = "rmsnorm") -> Params:
    p = {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device)
    return p


def apply_norm(params: Params, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-6):
    """RMSNorm, or LayerNorm (``kind="layernorm"``): the statistics in
    float32, the normalised value in x's dtype, then scale (and bias) in
    x's dtype, as the JAX package's ``apply_norm``."""
    if kind == "rmsnorm":
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + eps).to(x.dtype)
        return y * params["scale"].to(x.dtype)
    if kind != "layernorm":
        raise ValueError(f"unknown norm {kind!r}")
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = ((x - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def init_embedding(g: torch.Generator, vocab: int, d: int, device="cpu") -> Params:
    return {"table": normal(g, (vocab, d), 0.02, device)}


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
