"""Mamba (S6) selective-state-space block, Jamba's attention-free layer
(port of ``repro.models.mamba``: ``_dt_rank`` :25, ``init_mamba`` :29,
``_causal_conv`` :51, ``_ssm_chunk`` :65, ``mamba_layer`` :82,
``init_mamba_cache`` :161 and ``mamba_decode`` :169).

The selective scan runs over chunks of ``cfg.mamba_chunk`` tokens carrying
the state h (B, d_inner, d_state), as JAX's outer ``lax.scan`` does.
Within a chunk JAX takes ``jax.lax.associative_scan``; here the recurrence
h_t = dA_t ⊙ h_{t-1} + dBx_t runs token by token over the chunk (one fused
multiply-add per token on (B, d_inner, d_state)), which sums in another
order, so the two agree within a float32 tolerance, not bit for bit.  The
chunk loop runs under the profiler scope "mamba" (JAX's ``named_scope``).
With gradients on, each chunk's body (dA, dBx and the token loop) runs
under ``torch.utils.checkpoint``, JAX's nested remat (``jax.checkpoint``
around ``chunk_body``): the chunk's (B, c, d_inner, d_state) dA and dBx
are made again in the backward instead of being kept for every chunk.

Dtypes are JAX's: the parameters are float32, so every projection of a
bfloat16 input is float32; the state starts in x's dtype and the scan
carries it in the promoted type (JAX's ``lax.scan`` refuses that carry for
a bfloat16 x, see ROADMAP Queue 3; its first chunk starts from zeros, so
nothing is rounded).  The decode cache is ``{"conv": (B, d_conv - 1,
d_inner), "h": (B, d_inner, d_state)}``, bfloat16 unless asked otherwise,
and ``mamba_decode`` updates it in place, in its own dtype (JAX returns new
leaves in the promoted type; the serving engine's caches are float32,
where the two agree).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense, init_dense, normal, promote, remat_call

Params = dict


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.mamba_dt_rank or -(-cfg.d_model // 16)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    linear cut-off (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def init_mamba(cfg: ArchConfig, g: torch.Generator, device="cpu") -> Params:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dtr = _dt_rank(cfg)
    p = {"in_proj": init_dense(g, d, 2 * di, device=device)}
    p["conv_w"] = normal(g, (cfg.mamba_d_conv, di), 0.2, device)
    p["conv_b"] = torch.zeros((di,), device=device)
    p["x_proj"] = init_dense(g, di, dtr + 2 * n, device=device)
    p["dt_proj"] = init_dense(g, dtr, di, bias=True, device=device)
    # S4D-real initialization of A
    p["A_log"] = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device)
                           ).expand(di, n).contiguous()
    p["D"] = torch.ones((di,), device=device)
    p["out_proj"] = init_dense(g, di, d, device=device)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, carry=None):
    """Depthwise causal conv (k taps as shifted adds).  x: (B, T, di);
    ``carry`` (B, k - 1, di) holds the previous segment's last inputs.
    Returns (out, the new carry: the last k - 1 inputs, or None at k 1)."""
    k = w.shape[0]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[2])) if carry is None else carry
    xp = torch.cat(promote(pad, x), dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i] for i in range(k))
    new_carry = xp[:, -(k - 1):] if k > 1 else None
    return out + b, new_carry


def _ssm_chunk(h0, dA, dBx, C):
    """The chunk's scan: h_t = dA_t ⊙ h_{t-1} + dBx_t; y_t = Σ_n C_t·h_t.

    dA, dBx: (B, c, di, n); C: (B, c, n); h0: (B, di, n).  Returns (y (B,
    c, di), the last h)."""
    dt = torch.promote_types(torch.promote_types(dA.dtype, dBx.dtype), h0.dtype)
    dA, dBx = dA.to(dt), dBx.to(dt)
    h = h0.to(dt)
    # stacked, as autograd takes no ``out=``.  unbind, not dA[:, t]: each
    # index's backward would fill and add a whole (B, c, di, n) tensor
    steps = []
    for dA_t, dBx_t in zip(dA.unbind(1), dBx.unbind(1)):
        h = torch.addcmul(dBx_t, dA_t, h)
        steps.append(h)
    hs = torch.stack(steps, dim=1)
    hs_, C = promote(hs, C)
    y = torch.einsum("bcdn,bcn->bcd", hs_, C)
    return y, hs[:, -1]


def _chunk_body(h, dt_i, x_i, B_i, C_i, A):
    """One chunk of the selective scan from the carried state ``h``:
    ``(y (B, c, di), the last h)``."""
    dA = torch.exp(dt_i[..., None] * A)
    dBx = (dt_i * x_i)[..., None] * B_i[:, :, None, :]
    return _ssm_chunk(h, dA, dBx, C_i)


def mamba_layer(
    cfg: ArchConfig, params: Params, x: torch.Tensor, return_cache: bool = False,
    init_cache: Optional[dict] = None,
):
    """x: (B, T, d) -> (B, T, d).  Causal; full-sequence (train/prefill).
    With ``return_cache`` also returns the decode cache (final SSM state h +
    causal-conv tail); ``init_cache`` continues from a previous segment, so
    a ragged prompt splits into full chunks and a tail segment exactly."""
    B, T, d = x.shape
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dtr = _dt_rank(cfg)
    c = min(cfg.mamba_chunk, T)
    if T % c != 0:
        # ragged prompt: full chunks then a tail segment with carried state
        n_full = (T // c) * c
        out_full, mid = mamba_layer(cfg, params, x[:, :n_full], return_cache=True,
                                    init_cache=init_cache)
        out_tail, cache = mamba_layer(cfg, params, x[:, n_full:], return_cache=True,
                                      init_cache=mid)
        out = torch.cat([out_full, out_tail], dim=1)
        return (out, cache) if return_cache else out
    xz = dense(params["in_proj"], x)
    xin_raw, z = xz[..., :di], xz[..., di:]
    conv_carry_in = None if init_cache is None else init_cache["conv"]
    xin, _ = _causal_conv(xin_raw, params["conv_w"], params["conv_b"], conv_carry_in)
    xin = F.silu(xin)
    proj = dense(params["x_proj"], xin)  # (B, T, dtr + 2n)
    dt = _softplus(dense(params["dt_proj"], proj[..., :dtr]))  # (B, T, di)
    B_ssm = proj[..., dtr:dtr + n]
    C_ssm = proj[..., dtr + n:]
    A = -torch.exp(params["A_log"])  # (di, n)

    h = x.new_zeros((B, di, n)) if init_cache is None else init_cache["h"]
    ys = []
    with torch.profiler.record_function("mamba"):
        for s in range(0, T, c):
            y_i, h = remat_call(True, _chunk_body, h, dt[:, s:s + c], xin[:, s:s + c],
                                B_ssm[:, s:s + c], C_ssm[:, s:s + c], A)
            ys.append(y_i)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + params["D"] * xin
    y = y * F.silu(z)
    out = dense(params["out_proj"], y)
    if not return_cache:
        return out
    kc_ = cfg.mamba_d_conv - 1
    if kc_ and T >= kc_:
        conv_tail = xin_raw[:, -kc_:]
    elif kc_:  # short segment: splice the previous carry with the new inputs
        prev = x.new_zeros((B, kc_, di)) if conv_carry_in is None else conv_carry_in
        conv_tail = torch.cat(promote(prev, xin_raw), dim=1)[:, -kc_:]
    else:
        conv_tail = xin_raw[:, :0]
    # copies, so that the cache holds none of the layer's activations alive
    return out, {"conv": conv_tail.clone(), "h": h.clone()}


# --------------------------------------------------------------------------
# Decode (bounded state: conv tail + h)
# --------------------------------------------------------------------------

def init_mamba_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, device="cpu",
                     lead=()) -> dict:
    """Zero decode cache; ``lead`` prepends axes (the model's stacked layer
    axis)."""
    di = cfg.mamba_expand * cfg.d_model
    return {
        "conv": torch.zeros(lead + (batch, cfg.mamba_d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros(lead + (batch, di, cfg.mamba_d_state), dtype=dtype, device=device),
    }


def mamba_decode(cfg: ArchConfig, params: Params, x_t: torch.Tensor, cache: dict):
    """x_t: (B, 1, d) single-token step -> (B, 1, d); ``cache`` is updated
    in place."""
    di = cfg.mamba_expand * cfg.d_model
    n = cfg.mamba_d_state
    dtr = _dt_rank(cfg)
    xz = dense(params["in_proj"], x_t)
    xin, z = xz[..., :di], xz[..., di:]
    xin, conv_carry = _causal_conv(xin, params["conv_w"], params["conv_b"], cache["conv"])
    xin = F.silu(xin)
    proj = dense(params["x_proj"], xin)
    dt = _softplus(dense(params["dt_proj"], proj[..., :dtr]))[:, 0]  # (B, di)
    B_ssm = proj[:, 0, dtr:dtr + n]
    C_ssm = proj[:, 0, dtr + n:]
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[..., None] * A)  # (B, di, n)
    dBx = (dt * xin[:, 0])[..., None] * B_ssm[:, None, :]
    dA, h_prev = promote(dA, cache["h"])
    h = dA * h_prev + dBx
    h_, C_ = promote(h, C_ssm)
    y = torch.einsum("bdn,bn->bd", h_, C_) + params["D"] * xin[:, 0]
    y = y * F.silu(z[:, 0])
    out = dense(params["out_proj"], y[:, None])
    cache["conv"].copy_(conv_carry)
    cache["h"].copy_(h)
    return out
