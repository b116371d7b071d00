"""Linearized attention with incremental bounded state (paper Eqs. 5-10);
port of ``repro.core.linear_attention``.

All functions use the (B, H, T, D) layout.  Three equivalent formulations:

* :func:`recurrent_linear_attention`: the per-token stateful-ALU form,
  S_t = S_{t-1} + phi(k_t) v_t^T, Z_t = Z_{t-1} + phi(k_t) (Eqs. 9-10), read
  out as o_t = phi(q_t)^T S_t / (phi(q_t)^T Z_t + gamma) (Eq. 6): the
  paper-faithful baseline and the decode-time semantics.
* :func:`chunked_linear_attention`: the same math in Partition / Map /
  SumReduce tiles, exact intra-chunk causal attention in the phi-kernel
  space plus the carried (S, Z) state.
* :func:`linear_attention_readout`: the single-token decode readout.

gamma is the normalization floor of Thm A.2 (D_ii >= gamma > 0).  These are
the paper's baselines in plain tensor code: the JAX package has no kernel
for them (``jax.lax.scan`` becomes a Python loop).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

State = Tuple[torch.Tensor, torch.Tensor]  # S: (..., m, d_v), Z: (..., m)


def init_state(batch_shape: tuple, m: int, d_v: int, dtype=torch.float32,
               device="cpu") -> State:
    return (torch.zeros(tuple(batch_shape) + (m, d_v), dtype=dtype, device=device),
            torch.zeros(tuple(batch_shape) + (m,), dtype=dtype, device=device))


def recurrent_linear_attention(
    phi_q: torch.Tensor,  # (B, H, T, m)
    phi_k: torch.Tensor,  # (B, H, T, m)
    v: torch.Tensor,  # (B, H, T, d_v)
    state: Optional[State] = None,
    gamma: float = 1e-6,
) -> Tuple[torch.Tensor, State]:
    """The paper-faithful per-token streaming form (Eqs. 6, 9, 10)."""
    B, H, T, m = phi_q.shape
    if state is None:
        state = init_state((B, H), m, v.shape[-1], phi_q.dtype, phi_q.device)
    S, Z = state
    outs = []
    for t in range(T):
        pq, pk, vt = phi_q[:, :, t], phi_k[:, :, t], v[:, :, t]
        S = S + pk[..., :, None] * vt[..., None, :]
        Z = Z + pk
        num = torch.einsum("bhm,bhmd->bhd", pq, S)
        den = torch.einsum("bhm,bhm->bh", pq, Z)
        outs.append(num / (den[..., None] + gamma))
    out = torch.stack(outs, dim=2) if outs else v.new_zeros(v.shape)
    return out, (S, Z)


def chunked_linear_attention(
    phi_q: torch.Tensor,
    phi_k: torch.Tensor,
    v: torch.Tensor,
    chunk_size: int = 128,
    state: Optional[State] = None,
    gamma: float = 1e-6,
) -> Tuple[torch.Tensor, State]:
    """The chunk-parallel form: Partition over time, Map per chunk,
    SumReduce of the carried state.  The recurrent form's math up to float
    reassociation."""
    B, H, T, m = phi_q.shape
    d_v = v.shape[-1]
    if T % chunk_size != 0:
        raise ValueError(f"T={T} not divisible by chunk_size={chunk_size}")
    n_chunks = T // chunk_size
    if state is None:
        state = init_state((B, H), m, d_v, phi_q.dtype, phi_q.device)
    S, Z = state
    pq = phi_q.reshape(B, H, n_chunks, chunk_size, m)
    pk = phi_k.reshape(B, H, n_chunks, chunk_size, m)
    vc = v.reshape(B, H, n_chunks, chunk_size, d_v)
    causal = torch.tril(torch.ones((chunk_size, chunk_size), dtype=phi_q.dtype,
                                   device=phi_q.device))
    outs = []
    for c in range(n_chunks):
        q_c, k_c, v_c = pq[:, :, c], pk[:, :, c], vc[:, :, c]
        # intra-chunk: exact causal kernel attention (Map)
        scores = torch.einsum("bhim,bhjm->bhij", q_c, k_c) * causal
        num_intra = torch.einsum("bhij,bhjd->bhid", scores, v_c)
        den_intra = torch.sum(scores, dim=-1)
        # inter-chunk: readout against the carried state
        num_inter = torch.einsum("bhim,bhmd->bhid", q_c, S)
        den_inter = torch.einsum("bhim,bhm->bhi", q_c, Z)
        outs.append((num_intra + num_inter)
                    / (den_intra[..., None] + den_inter[..., None] + gamma))
        # SumReduce: fold this chunk into the carried state
        S = S + torch.einsum("bhjm,bhjd->bhmd", k_c, v_c)
        Z = Z + torch.sum(k_c, dim=2)
    out = torch.stack(outs, dim=2).reshape(B, H, T, d_v)
    return out, (S, Z)


def linear_attention_readout(
    phi_q: torch.Tensor,  # (B, H, m): one token
    state: State,
    gamma: float = 1e-6,
) -> torch.Tensor:
    """Decode-time readout o = phi(q)^T S / (phi(q)^T Z + gamma) (Eq. 6)."""
    S, Z = state
    num = torch.einsum("bhm,bhmd->bhd", phi_q, S)
    den = torch.einsum("bhm,bhm->bh", phi_q, Z)
    return num / (den[..., None] + gamma)


def state_update(
    phi_k: torch.Tensor,  # (B, H, m): one token
    v: torch.Tensor,  # (B, H, d_v)
    state: State,
) -> State:
    """One stateful-ALU increment (Eqs. 9-10), the decode fast path."""
    S, Z = state
    return (S + phi_k[..., :, None] * v[..., None, :], Z + phi_k)


def evicting_state_update(
    phi_k_new: torch.Tensor,
    v_new: torch.Tensor,
    phi_k_old: torch.Tensor,
    v_old: torch.Tensor,
    state: State,
) -> State:
    """The windowed variant: add the arriving token, subtract the token
    leaving the circular buffer (the paper's SRAM circular-overwrite
    semantics), so the state is a function of the last L tokens."""
    S, Z = state
    S = (S + phi_k_new[..., :, None] * v_new[..., None, :]
         - phi_k_old[..., :, None] * v_old[..., None, :])
    Z = Z + phi_k_new - phi_k_old
    return (S, Z)


def exact_kernel_attention(phi_q: torch.Tensor, phi_k: torch.Tensor, v: torch.Tensor,
                           gamma: float = 1e-6) -> torch.Tensor:
    """The O(T^2) oracle in kernel space: softmax-free normalization with the
    same phi scores, against which the chunked and recurrent forms are
    checked."""
    scores = torch.einsum("bhim,bhjm->bhij", phi_q, phi_k)
    T = scores.shape[-1]
    scores = scores * torch.tril(torch.ones((T, T), dtype=scores.dtype, device=scores.device))
    den = torch.sum(scores, dim=-1, keepdim=True)
    return torch.einsum("bhij,bhjd->bhid", scores, v) / (den + gamma)
