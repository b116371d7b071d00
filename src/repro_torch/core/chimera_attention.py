"""Chimera attention (port of ``repro.core.chimera_attention``: the config
:53, ``_group_queries`` :99, ``_global_partials`` :106, the train/prefill
``chimera_attention`` :134, the bounded-state decode :246-422,
``prefill_into_state`` :283, ``reference_attention`` :425 and
``chimera_prefill`` :475).

Per query and (flow, kv-head), three partials in the shared exp-kernel
space are summed and normalized (Eqs. 6, 9-10, 14):

* **local** — exact exp-kernel attention inside the current chunk of L
  tokens (the SRAM window, or ring in decode);
* **stream** — φ_qᵀS and φ_qᵀZ against the compressed history;
* **global** — the static global set G, gated by the TCAM-style match.

Train/prefill (:func:`chimera_attention`) computes the local and stream
partials of whole chunked sequences with
:func:`repro_torch.kernels.chimera_attention.ops.chimera_attention_partials`
(the Hopper kernels on a CUDA tensor, forward and backward; the plain
versions on a CPU tensor: the chunked backward never forms a (T, T)
tensor, as the JAX package's default scan path does not), as the JAX
package's ``use_pallas`` branch does.

Serving prefill (:func:`chimera_prefill`) runs the prompt's full chunks
through the same partials (the kernel on the card), computes the ragged
tail (T mod L tokens) as one partial chunk in plain PyTorch, as the JAX
package does in jnp, and returns the decode state that
:func:`prefill_into_state` builds: the full chunks folded into (S, Z) by
one product, the tail in the ring.  The tail's partials are computed in
float32, as the kernels compute the full chunks' (their wrappers' stated
cast of bfloat16 inputs).  :func:`reference_attention` is the O(T²)
oracle with dense masks that the tests hold both paths to.

Decode (:func:`chimera_decode_step`) runs the ring write, the local and
stream readouts, the merge and the fold-on-full in one call of
:func:`repro_torch.kernels.decode_step.ops.decode_step`, which also adds
the global partials.  Unlike the JAX package, which leaves ``n_global > 0``
on its jnp branch, the paper's configuration goes through the kernel.  The
decode state is updated **in place**: S, Z and the ring tensors of the
:class:`ChimeraState` passed in are overwritten, and its ``count`` is
replaced by the new fill levels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import key_selection as ks
from repro_torch.core.feature_maps import (
    FeatureMapConfig,
    _normalize,
    apply_feature_map,
    init_feature_map,
)
from repro_torch.kernels.chimera_attention.ops import (
    chimera_attention_partials,
    chimera_attention_partials_plain,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ChimeraAttentionConfig:
    feature_map: FeatureMapConfig = FeatureMapConfig(kind="exp_prf", m=64)
    chunk_size: int = 128  # L: the SRAM window / Partition size
    n_global: int = 32  # |G| static TCAM-indexed tokens (0 disables)
    sig_bits: int = 32
    match_hamming: int = 12
    gamma: float = 1e-6


def init_chimera_attention(
    cfg: ChimeraAttentionConfig, n_kv_heads: int, d_head: int, d_v: int,
    g: torch.Generator, device="cpu",
) -> Params:
    params: Params = {"fm": init_feature_map(cfg.feature_map, d_head, g, device)}
    if cfg.n_global > 0:
        params["sig_proj"] = ks.init_signature_projection(g, d_head, cfg.sig_bits, device)
        params["k_global"] = (
            torch.randn((n_kv_heads, cfg.n_global, d_head), generator=g, device=g.device)
            / math.sqrt(d_head)
        ).to(device)
        params["v_global"] = (
            torch.randn((n_kv_heads, cfg.n_global, d_v), generator=g, device=g.device)
            / math.sqrt(d_v)
        ).to(device)
    return params


def _global_partials(
    cfg: ChimeraAttentionConfig,
    params: Params,
    qh: torch.Tensor,  # (B, Hkv, Gq, T, d) normalized queries
    phi_q: torch.Tensor,  # (B, Hkv, Gq, T, m)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-global contribution with TCAM ternary gating (Eq. 14)."""
    kg = _normalize(params["k_global"], cfg.feature_map.input_scale)  # (Hkv,G,d)
    vg = params["v_global"]
    phi_kg = apply_feature_map(cfg.feature_map, params["fm"], kg)
    sig_q = ks.make_signature(qh, params["sig_proj"])  # (B,Hkv,Gq,T,W)
    sig_k = ks.make_signature(kg, params["sig_proj"])  # (Hkv,G,W)
    match = ks.ternary_match_mask(sig_q, sig_k[None, :, None], cfg.match_hamming)
    scores = torch.einsum("bhgtm,hcm->bhgtc", phi_q, phi_kg) * match
    # in the common type, as jnp promotes it: the float32 mask makes a
    # bfloat16 model's scores float32, against its bfloat16 values
    dt = torch.promote_types(scores.dtype, vg.dtype)
    num = torch.einsum("bhgtc,hcd->bhgtd", scores.to(dt), vg.to(dt))
    den = torch.sum(scores, dim=-1)
    return num, den


def _group_queries(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """(B, H, T, d) -> (B, Hkv, G, T, d) without materializing repeats."""
    B, H, T, d = q.shape
    return q.reshape(B, n_kv_heads, H // n_kv_heads, T, d)


def chimera_attention(
    cfg: ChimeraAttentionConfig,
    params: Params,
    q: torch.Tensor,  # (B, H, T, d)
    k: torch.Tensor,  # (B, Hkv, T, d)
    v: torch.Tensor,  # (B, Hkv, T, d_v)
) -> torch.Tensor:
    """Train/prefill path: chunked Chimera attention, causal.  Returns
    (B, H, T, d_v)."""
    B, H, T, d = q.shape
    n_kv = k.shape[1]
    d_v = v.shape[-1]
    L = cfg.chunk_size
    if T % L != 0:
        raise ValueError(f"T={T} must be divisible by chunk_size={L}")
    scale = cfg.feature_map.input_scale
    qh = _normalize(_group_queries(q, n_kv), scale)  # (B,Hkv,Gq,T,d)
    kh = _normalize(k, scale)  # (B,Hkv,T,d)
    phi_q = apply_feature_map(cfg.feature_map, params["fm"], qh)
    phi_k = apply_feature_map(cfg.feature_map, params["fm"], kh)
    num, den = chimera_attention_partials(qh, kh, v, phi_q, phi_k, chunk_size=L)
    if cfg.n_global > 0:
        gnum, gden = _global_partials(cfg, params, qh, phi_q)
        num = num + gnum
        den = den + gden
    out = num / (den[..., None] + cfg.gamma)
    return out.reshape(B, H, T, d_v)


@dataclasses.dataclass
class ChimeraState:
    """Per-request bounded decode state."""

    S: torch.Tensor  # (B, Hkv, m, d_v)
    Z: torch.Tensor  # (B, Hkv, m)
    k_buf: torch.Tensor  # (B, Hkv, L, d) normalized keys in the SRAM ring
    v_buf: torch.Tensor  # (B, Hkv, L, d_v)
    count: torch.Tensor  # (B,) int32 — fill level of the ring buffer

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.S, self.Z, self.k_buf, self.v_buf, self.count)


def init_decode_state(
    cfg: ChimeraAttentionConfig, batch: int, n_kv_heads: int, d_head: int, d_v: int,
    dtype=torch.float32, device="cpu", lead: Tuple[int, ...] = (),
) -> ChimeraState:
    """Zero state; ``lead`` prepends axes (the model's stacked layer axis)."""
    m = cfg.feature_map.feature_dim(d_head)
    L = cfg.chunk_size

    def z(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return ChimeraState(
        S=z(batch, n_kv_heads, m, d_v),
        Z=z(batch, n_kv_heads, m),
        k_buf=z(batch, n_kv_heads, L, d_head),
        v_buf=z(batch, n_kv_heads, L, d_v),
        count=z(batch, dt=torch.int32),
    )


def prefill_into_state(
    cfg: ChimeraAttentionConfig,
    params: Params,
    k: torch.Tensor,  # (B, Hkv, T, d) raw keys of the prompt
    v: torch.Tensor,  # (B, Hkv, T, d_v)
) -> ChimeraState:
    """Decode state from a prompt: the full chunks fold into (S, Z), the
    ragged tail occupies the ring, with the chunked path's boundaries."""
    B, n_kv, T, d = k.shape
    d_v = v.shape[-1]
    L = cfg.chunk_size
    n_full = T // L
    tail = T - n_full * L
    kh = _normalize(k, cfg.feature_map.input_scale)
    phi_k = apply_feature_map(cfg.feature_map, params["fm"], kh)
    m = phi_k.shape[-1]
    if n_full > 0:
        # in the common type, as jnp promotes the float32 features of a
        # bfloat16 model against its values
        dt = torch.promote_types(phi_k.dtype, v.dtype)
        pk, vv = phi_k[:, :, : n_full * L].to(dt), v[:, :, : n_full * L].to(dt)
        S = torch.einsum("bhjm,bhjd->bhmd", pk, vv)
        Z = torch.sum(pk, dim=2)
    else:
        S = k.new_zeros((B, n_kv, m, d_v))
        Z = k.new_zeros((B, n_kv, m))
    k_buf = k.new_zeros((B, n_kv, L, d))
    v_buf = v.new_zeros((B, n_kv, L, d_v))
    if tail:
        k_buf[:, :, :tail] = kh[:, :, n_full * L:]
        v_buf[:, :, :tail] = v[:, :, n_full * L:]
    count = torch.full((B,), tail, dtype=torch.int32, device=k.device)
    return ChimeraState(S=S, Z=Z, k_buf=k_buf, v_buf=v_buf, count=count)


def reference_attention(
    cfg: ChimeraAttentionConfig,
    params: Params,
    q: torch.Tensor,  # (B, H, T, d)
    k: torch.Tensor,  # (B, Hkv, T, d)
    v: torch.Tensor,  # (B, Hkv, T, d_v)
) -> torch.Tensor:
    """O(T²) oracle with dense masks: token i attends exactly (exp kernel)
    to the keys j <= i of its own chunk, through φ to every earlier chunk,
    plus the matched globals.  Any T (the last chunk may be partial)."""
    B, H, T, d = q.shape
    n_kv = k.shape[1]
    scale = cfg.feature_map.input_scale
    qh = _normalize(_group_queries(q, n_kv), scale)
    kh = _normalize(k, scale)
    phi_q = apply_feature_map(cfg.feature_map, params["fm"], qh)
    phi_k = apply_feature_map(cfg.feature_map, params["fm"], kh)
    num, den = chimera_attention_partials_plain(
        *(x.float() for x in (qh, kh, v, phi_q, phi_k)), cfg.chunk_size)
    if cfg.n_global > 0:
        gnum, gden = _global_partials(cfg, params, qh, phi_q)
        num = num + gnum
        den = den + gden
    out = num / (den[..., None] + cfg.gamma)
    return out.reshape(B, H, T, v.shape[-1])


def chimera_prefill(
    cfg: ChimeraAttentionConfig,
    params: Params,
    q: torch.Tensor,  # (B, H, T, d); T may be ragged (not a chunk multiple)
    k: torch.Tensor,  # (B, Hkv, T, d)
    v: torch.Tensor,  # (B, Hkv, T, d_v)
) -> Tuple[torch.Tensor, ChimeraState]:
    """Serving prefill: the outputs at every prompt position and the decode
    state, in one chunk-parallel pass.  A ragged tail is one partial chunk:
    exact local attention over the tail, the stream readout against the
    folded full chunks and the static-global partials; it stays in the ring
    unfolded, as token-by-token decode leaves it."""
    B, H, T, d = q.shape
    n_kv = k.shape[1]
    L = cfg.chunk_size
    n_full = T // L
    tail = T - n_full * L
    Gq = H // n_kv
    d_v = v.shape[-1]
    scale = cfg.feature_map.input_scale

    outs = []
    if n_full:
        outs.append(chimera_attention(cfg, params, q[:, :, : n_full * L],
                                      k[:, :, : n_full * L], v[:, :, : n_full * L]))
    state = prefill_into_state(cfg, params, k, v)

    if tail:
        qh = _normalize(_group_queries(q[:, :, n_full * L:], n_kv), scale).float()
        kh = _normalize(k[:, :, n_full * L:], scale).float()
        v_t = v[:, :, n_full * L:].float()
        phi_q = apply_feature_map(cfg.feature_map, params["fm"], qh)
        causal = torch.tril(torch.ones((tail, tail), device=q.device))
        s_loc = torch.exp(torch.einsum("bhgid,bhjd->bhgij", qh, kh) / math.sqrt(d)) * causal
        num = torch.einsum("bhgij,bhjd->bhgid", s_loc, v_t)
        den = torch.sum(s_loc, dim=-1)
        if n_full:
            num = num + torch.einsum("bhgim,bhmd->bhgid", phi_q, state.S.float())
            den = den + torch.einsum("bhgim,bhm->bhgi", phi_q, state.Z.float())
        if cfg.n_global > 0:
            gnum, gden = _global_partials(cfg, params, qh, phi_q)
            num = num + gnum
            den = den + gden
        out_tail = (num / (den[..., None] + cfg.gamma)).reshape(B, H, tail, d_v)
        outs.append(out_tail.to(outs[0].dtype) if outs else out_tail)
    out = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    return out, state


def chimera_decode_step(
    cfg: ChimeraAttentionConfig,
    params: Params,
    q_t: torch.Tensor,  # (B, H, d)
    k_t: torch.Tensor,  # (B, Hkv, d)
    v_t: torch.Tensor,  # (B, Hkv, d_v)
    state: ChimeraState,
) -> torch.Tensor:
    """One decode step; returns out (B, H, d_v) and updates ``state`` in place."""
    from repro_torch.kernels.decode_step.ops import decode_step

    B, H, d = q_t.shape
    n_kv = k_t.shape[1]
    Gq = H // n_kv
    d_v = v_t.shape[-1]
    L = cfg.chunk_size
    scale = cfg.feature_map.input_scale

    qh = _normalize(q_t.reshape(B, n_kv, Gq, d), scale)
    kh = _normalize(k_t, scale)
    phi_q = apply_feature_map(cfg.feature_map, params["fm"], qh)  # (B,Hkv,Gq,m)
    m = phi_q.shape[-1]
    # φ of the ring with the arriving key at its slot (the fold reads it)
    c = state.count
    slot = (torch.arange(L, device=c.device)[None, :] == c[:, None])[:, None, :, None]
    phi_buf = apply_feature_map(
        cfg.feature_map, params["fm"], torch.where(slot, kh[:, :, None, :], state.k_buf)
    )

    gnum = gden = None
    if cfg.n_global > 0:
        gnum, gden = _global_partials(
            cfg, params, qh[:, :, :, None, :], phi_q[:, :, :, None, :]
        )
        gnum = gnum[:, :, :, 0].reshape(B * n_kv, Gq, d_v).contiguous()
        gden = gden[:, :, :, 0].reshape(B * n_kv, Gq).contiguous()

    BH = B * n_kv
    out, state.count = decode_step(
        qh.reshape(BH, Gq, d),
        kh.reshape(BH, d),
        v_t.reshape(BH, d_v),
        phi_q.reshape(BH, Gq, m),
        phi_buf.reshape(BH, L, m),
        state.k_buf.view(BH, L, d),
        state.v_buf.view(BH, L, d_v),
        state.S.view(BH, m, d_v),
        state.Z.view(BH, m),
        c,
        chunk_size=L,
        gamma=cfg.gamma,
        gnum=gnum,
        gden=gden,
    )
    return out.reshape(B, H, d_v)
