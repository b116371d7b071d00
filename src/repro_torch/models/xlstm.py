"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), port of
``repro.models.xlstm``: ``init_mlstm`` :33, ``_mlstm_chunked`` :51,
``mlstm_layer`` :127, ``init_mlstm_cache`` :147, ``mlstm_decode`` :157,
``init_slstm`` :185, ``slstm_layer`` :199, ``init_slstm_cache`` :233 and
``slstm_decode`` :239.

The mLSTM recurrence C_t = f_t·C_{t-1} + i_t·v_t k_tᵀ runs chunked, as
JAX's ``lax.scan`` over chunks of ``cfg.chimera.chunk_size`` tokens
(intra-chunk decayed scores plus the carried (C, n) state), with sigmoid
input and forget gates (log-gates <= 0).  The intra-chunk decays are masked
before their exp, where JAX masks after it: above the diagonal the
exponent is a sum of -log f over the distance, which overflows float32
within xlstm-125m's chunk of 256 (JAX's layer then returns NaN, ROADMAP
Queue 3); wherever JAX's is finite the two are the same.  The sLSTM has a
sequential h_{t-1} dependence through its head-block-diagonal recurrent
weights, so it runs token by token, as JAX's per-token scan.  The chunk
loop and the token loop run under the profiler scopes "mlstm" and "slstm"
(JAX's ``named_scope``).  With gradients on, each mLSTM chunk runs under
``torch.utils.checkpoint``, JAX's nested remat (``jax.checkpoint`` around
the chunk body); the sLSTM's token loop has none, as in JAX (layer-level
remat comes from the model's group loop).

Dtypes are JAX's (float32 parameters; a bfloat16 input gives float32
projections).  The sLSTM state starts in x's dtype and is carried in the
promoted type (JAX's ``lax.scan`` refuses that carry for a bfloat16 x, see
ROADMAP Queue 3; it starts from zeros, so nothing is rounded).  The decode
caches are ``{"C", "n"}`` and ``{"c", "n", "h", "m"}``, bfloat16 unless
asked otherwise; the decode steps update them in place, in their own dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense, init_dense, normal, promote, remat_call

Params = dict


# ==========================================================================
# mLSTM
# ==========================================================================

def init_mlstm(cfg: ArchConfig, g: torch.Generator, device="cpu") -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    di = 2 * d  # xLSTM up-projection factor 2
    return {
        "up": init_dense(g, d, 2 * di, device=device),
        "wq": init_dense(g, di, di, device=device),
        "wk": init_dense(g, di, di, device=device),
        "wv": init_dense(g, di, di, device=device),
        "w_if": init_dense(g, di, 2 * H, bias=True, device=device),
        "down": init_dense(g, di, d, device=device),
    }


def _mlstm_chunk(C, n, q_i, k_i, v_i, li, lf, causal):
    """One chunk from the carried (C, n), q_i already scaled: ``(out (B, H,
    c, dh), C, n)``."""
    F_ = torch.cumsum(lf, dim=-1)  # (B, H, c): F_t = Σ_{τ≤t} logf
    # decay(s→t) = exp(F_t − F_s); score = q·k · decay · i_s.  Masked before
    # the exp: above the diagonal F_t − F_s >= 0 grows with the distance, and
    # JAX's exp-then-mask makes inf · 0 = NaN there
    w = torch.exp(torch.where(causal, F_[..., :, None] - F_[..., None, :] + li[..., None, :],
                              float("-inf")))
    sc = torch.einsum("bhid,bhjd->bhij", q_i, k_i) * w
    num = torch.einsum("bhij,bhjd->bhid", sc, v_i)
    den = torch.einsum("bhij,bhjd->bhid", sc, torch.ones_like(v_i[..., :1]))[..., 0]
    # carried-state contribution: decay exp(F_t)
    dq = torch.exp(F_)[..., None] * q_i
    num = num + torch.einsum("bhid,bhde->bhie", dq, C)
    den = den + torch.einsum("bhid,bhd->bhi", dq, n)
    out = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    # fold the chunk into the state with tail decays exp(F_last − F_s + logi_s)
    tail = torch.exp(F_[..., -1:] - F_ + li)  # (B, H, c)
    C = torch.exp(F_[..., -1])[..., None, None] * C + torch.einsum(
        "bhj,bhjd,bhje->bhde", tail, k_i, v_i)
    n = torch.exp(F_[..., -1])[..., None] * n + torch.einsum("bhj,bhjd->bhd", tail, k_i)
    return out, C, n


def _mlstm_chunked(q, k, v, logi, logf, chunk: int, state=None):
    """q, k, v: (B, H, T, dh); logi, logf: (B, H, T), <= 0.  Returns (out (B,
    H, T, dh), the carried (C (B, H, dh, dh), n (B, H, dh)))."""
    B, H, T, dh = q.shape
    c = min(chunk, T)
    if T % c != 0:  # ragged prompt: full chunks then a tail chunk
        n_full = (T // c) * c
        out_full, st = _mlstm_chunked(q[:, :, :n_full], k[:, :, :n_full], v[:, :, :n_full],
                                      logi[:, :, :n_full], logf[:, :, :n_full], chunk=c,
                                      state=state)
        out_tail, st = _mlstm_chunked(q[:, :, n_full:], k[:, :, n_full:], v[:, :, n_full:],
                                      logi[:, :, n_full:], logf[:, :, n_full:],
                                      chunk=T - n_full, state=st)
        return torch.cat([out_full, out_tail], dim=2), st
    if state is None:
        C = q.new_zeros((B, H, dh, dh))
        n = q.new_zeros((B, H, dh))
    else:
        C, n = state
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    inv_sqrt_dh = 1.0 / torch.sqrt(torch.tensor(dh, dtype=q.dtype, device=q.device))
    outs = []
    with torch.profiler.record_function("mlstm"):
        for s in range(0, T, c):
            out, C, n = remat_call(True, _mlstm_chunk, C, n,
                                   q[:, :, s:s + c] * inv_sqrt_dh,  # scale queries once
                                   k[:, :, s:s + c], v[:, :, s:s + c], logi[:, :, s:s + c],
                                   logf[:, :, s:s + c], causal)
            outs.append(out)
    out = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    return out, (C, n)


def _mlstm_qkv_gates(cfg: ArchConfig, params: Params, x: torch.Tensor):
    """(q, k, v (B, T, H, dh), gates (B, T, 2, H), z (B, T, di))."""
    B, T, d = x.shape
    H = cfg.n_heads
    di = 2 * d
    dh = di // H
    uz = dense(params["up"], x)
    u, z = uz[..., :di], uz[..., di:]
    q, k, v = (dense(params[w], u).reshape(B, T, H, dh) for w in ("wq", "wk", "wv"))
    return q, k, v, dense(params["w_if"], u).reshape(B, T, 2, H), z


def mlstm_layer(cfg: ArchConfig, params: Params, x: torch.Tensor, return_cache: bool = False):
    """x: (B, T, d) -> (B, T, d) [, the decode cache {"C", "n"}]."""
    B, T, d = x.shape
    q, k, v, gates, z = _mlstm_qkv_gates(cfg, params, x)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    logi = F.logsigmoid(gates[:, :, 0]).transpose(1, 2)  # (B, H, T)
    logf = F.logsigmoid(gates[:, :, 1]).transpose(1, 2)
    o, (Cst, nst) = _mlstm_chunked(q, k, v, logi, logf, chunk=cfg.chimera.chunk_size)
    o = o.transpose(1, 2).reshape(B, T, 2 * d)
    out = dense(params["down"], o * F.silu(z))
    if return_cache:
        return out, {"C": Cst, "n": nst}
    return out


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, device="cpu",
                     lead=()) -> dict:
    """Zero decode cache; ``lead`` prepends axes (the stacked layer axis)."""
    H = cfg.n_heads
    dh = 2 * cfg.d_model // H
    return {"C": torch.zeros(lead + (batch, H, dh, dh), dtype=dtype, device=device),
            "n": torch.zeros(lead + (batch, H, dh), dtype=dtype, device=device)}


def mlstm_decode(cfg: ArchConfig, params: Params, x_t: torch.Tensor, cache: dict):
    """x_t: (B, 1, d) -> (B, 1, d); ``cache`` is updated in place."""
    B = x_t.shape[0]
    H = cfg.n_heads
    di = 2 * cfg.d_model
    dh = di // H
    q, k, v, gates, z = _mlstm_qkv_gates(cfg, params, x_t)
    q, k, v = (t.reshape(B, H, dh) for t in (q, k, v))
    gates = gates.reshape(B, 2, H)
    i_g = torch.sigmoid(gates[:, 0])[..., None]
    f_g = torch.sigmoid(gates[:, 1])[..., None]
    f_g, C_prev, n_prev = promote(f_g, cache["C"], cache["n"])
    C = f_g[..., None] * C_prev + i_g[..., None] * k[..., :, None] * v[..., None, :]
    n = f_g * n_prev + i_g * k
    q = q / torch.sqrt(torch.tensor(dh, dtype=q.dtype, device=q.device))
    num = torch.einsum("bhd,bhde->bhe", *promote(q, C))
    den = torch.einsum("bhd,bhd->bh", *promote(q, n))
    o = (num / torch.clamp(torch.abs(den), min=1.0)[..., None]).reshape(B, 1, di)
    out = dense(params["down"], o * F.silu(z))
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    return out


# ==========================================================================
# sLSTM
# ==========================================================================

def init_slstm(cfg: ArchConfig, g: torch.Generator, device="cpu") -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "wx": init_dense(g, d, 4 * d, bias=True, device=device),
        # recurrent weights are head-block-diagonal: (H, dh, 4 dh)
        "r": normal(g, (H, dh, 4 * dh), 1.0 / dh ** 0.5, device),
        "out": init_dense(g, d, d, device=device),
    }


def _slstm_step(wx_t, r, c, n, h, m):
    """One token of the recurrence; every state (B, H, dh), m the
    stabilizer.  Returns the new (c, n, h, m)."""
    rec = torch.einsum("bhd,hde->bhe", *promote(h, r))
    g = wx_t + rec
    zt, it, ft, ot = torch.chunk(g, 4, dim=-1)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(logf + m - m_new)
    c = f_s * c + i_s * torch.tanh(zt)
    n = f_s * n + i_s
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
    return c, n, h, m_new


def slstm_layer(cfg: ArchConfig, params: Params, x: torch.Tensor, return_cache: bool = False):
    """Per-token recurrent scan (sequential; scope "slstm")."""
    B, T, d = x.shape
    H = cfg.n_heads
    dh = d // H
    wx = dense(params["wx"], x).reshape(B, T, H, 4 * dh)
    c = n = h = m = x.new_zeros((B, H, dh))
    hs = []
    with torch.profiler.record_function("slstm"):
        for wx_t in wx.unbind(1):  # not wx[:, t]: each index's backward fills all of wx
            c, n, h, m = _slstm_step(wx_t, params["r"], c, n, h, m)
            hs.append(h)
    out = dense(params["out"], torch.stack(hs, dim=1).reshape(B, T, d))
    if return_cache:
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, device="cpu",
                     lead=()) -> dict:
    """Zero decode cache; ``lead`` prepends axes (the stacked layer axis)."""
    shape = lead + (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {k: torch.zeros(shape, dtype=dtype, device=device) for k in ("c", "n", "h", "m")}


def slstm_decode(cfg: ArchConfig, params: Params, x_t: torch.Tensor, cache: dict):
    """x_t: (B, 1, d) -> (B, 1, d); ``cache`` is updated in place."""
    B = x_t.shape[0]
    H = cfg.n_heads
    dh = cfg.d_model // H
    wx_t = dense(params["wx"], x_t).reshape(B, H, 4 * dh)
    new = _slstm_step(wx_t, params["r"], cache["c"], cache["n"], cache["h"], cache["m"])
    out = dense(params["out"], new[2].reshape(B, 1, cfg.d_model))
    for key, t in zip(("c", "n", "h", "m"), new):
        cache[key].copy_(t)
    return out
