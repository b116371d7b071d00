"""Chunked Chimera attention partials: the CUDA kernel's wrapper, its plain
version and the autograd Function around them.

Replaces ``repro/kernels/chimera_attention/kernel.py::chimera_attention_pallas``
with ``csrc/chimera_attention.cu`` (training and prefill; chunks of 16 to
128 tokens) and ``csrc/chimera_attention_long.cu`` (chunks of 256, the model
zoo's default, as in Mixtral-8x7B's Chimera prefill).  Token i attends
exactly (exp kernel) to the tokens j <= i of its own chunk and through the
feature map, φ(q)ᵀφ(k), to every token of earlier chunks; the unnormalized
``(num, den)`` partials are returned so that the caller can add the
static-global term before dividing.

* :func:`chimera_attention_partials_plain` — the port of
  ``repro/kernels/chimera_attention/ref.py``, with dense (T, T) masks.
* :func:`chimera_attention_bh` — the kernel's wrapper on the flattened
  (batch × kv-head) layout: it launches the kernel for CUDA tensors and runs
  the plain version for CPU tensors; any other device raises.  ``launches``
  counts kernel launches (never plain calls).  Types: the kernels read and
  write float32; bfloat16 inputs (a model whose ``ArchConfig.dtype`` is
  bfloat16, as the JAX package runs Chimera in the input type) are cast to
  float32 explicitly before either route, and the partials are cast to the
  inputs' common type after it (bfloat16 where all five are; the float32
  features of a bfloat16 model make it float32, as in jnp).
* :func:`chimera_attention_partials` — the port of the JAX ``custom_vjp``
  (``repro/kernels/chimera_attention/ops.py``): the forward takes the
  wrapper's route, the backward recomputes the plain formulation and
  differentiates it, as ``_bwd`` does with ``jax.vjp`` of the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

launches = 0

# the launchers' contract (csrc/chimera_attention.cu for L up to 128,
# csrc/chimera_attention_long.cu for L 256)
L_TAKEN = (16, 32, 64, 128, 256)
L_LONG = 256
DV_TAKEN = (16, 32, 64, 128)
SMEM_LIMIT = 227 * 1024
TYPES = (torch.float32, torch.bfloat16)
_WARPS = 8


def phi_tile(L: int, m: int) -> int:
    """Columns of the kernel's phi tiles: 64 (32 at L 128) where m is a
    multiple of that, else 16."""
    fast = 32 if L == 128 else 64
    return fast if m % fast == 0 else 16


def _smem_bytes(d: int, dv: int, m: int, L: int, stages: int, vbufs: int) -> int:
    """The kernel's shared memory (its ``Layout``) at one staging plan, in bytes."""
    ks = _WARPS // (L // 16)
    ss, sq, sv, sf = dv + 8, d + 4, dv + 4, phi_tile(L, m) + 4
    ring = m * ss + m + 2 * L * sq + vbufs * L * sv
    return 4 * (ring + stages * L * sf + (ks - 1) * L * ss)


def _long_smem_bytes(d: int, dv: int, m: int) -> int:
    """The long-chunk kernels' shared memory, the larger of the two, in
    bytes: the chunk kernel's ``Layout`` (64 query rows and two 32-key
    buffers each of k and v, whose region the stream tiles, two buffers
    each of a 64-feature slice of 64 rows of φ_q and of the (m, dv + 8)
    state, reuse) and the fold's two 64-key buffers of v and of a
    128-feature slice of φ_k.  It grows with d, not with m."""
    mf = min(m, 64)
    local = 64 * (d + 4) * 2 + 64 * (dv + 4)
    stream = 2 * 64 * (mf + 4) + 2 * mf * (dv + 8)
    fold = 2 * 64 * (min(m, 128) + 8 + dv + 8)
    return 4 * max(local, stream, fold)


def long_state_shape(BH: int, T: int, dv: int, m: int) -> Tuple[int, int, int, int]:
    """The long-chunk kernel's scratch: for each row and chunk c the stream
    state before it, (m, dv + 8) with S_c in columns :dv, Z_c in column dv
    and the rest padding (16-byte rows, conflict-free fragment reads)."""
    return (BH, T // L_LONG, m, dv + 8)


def contract(*, d: int, dv: int, m: int, L: int) -> Optional[str]:
    """``None`` if the kernel takes these widths, else what it refuses: the
    launcher's checks on the widths, mirrored so that a shape outside them
    raises here rather than as a CUDA error code."""
    if L not in L_TAKEN:
        return f"chunk size L {L} not in {L_TAKEN}"
    if dv not in DV_TAKEN:
        return f"dv {dv} not in {DV_TAKEN}"
    if d <= 0 or d % 8:
        return f"d {d} is not a positive multiple of 8"
    if m <= 0 or m % 16:
        return f"m {m} is not a positive multiple of 16"
    if L == L_LONG:
        smem = _long_smem_bytes(d, dv, m)
    else:
        smem = _smem_bytes(d, dv, m, L, stages=2, vbufs=1)  # the shallowest plan
    if smem > SMEM_LIMIT:
        return f"{smem} B of shared memory at d {d}, dv {dv}, m {m}, L {L} > {SMEM_LIMIT}"
    return None


def chimera_attention_partials_plain(
    q: torch.Tensor,  # (B, Hkv, Gq, T, d) normalized queries
    k: torch.Tensor,  # (B, Hkv, T, d) normalized keys
    v: torch.Tensor,  # (B, Hkv, T, dv)
    phi_q: torch.Tensor,  # (B, Hkv, Gq, T, m)
    phi_k: torch.Tensor,  # (B, Hkv, T, m)
    chunk_size: int,
    use_local: bool = True,
    use_stream: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch partials: ``(num (B,Hkv,Gq,T,dv), den (B,Hkv,Gq,T))``."""
    B, Hkv, Gq, T, d = q.shape
    idx = torch.arange(T, device=q.device)
    same_chunk = (idx[:, None] // chunk_size) == (idx[None, :] // chunk_size)
    causal = idx[:, None] >= idx[None, :]
    num = q.new_zeros((B, Hkv, Gq, T, v.shape[-1]))
    den = q.new_zeros((B, Hkv, Gq, T))
    if use_local:
        mask = (same_chunk & causal).to(q.dtype)
        s = torch.exp(torch.einsum("bhgid,bhjd->bhgij", q, k) / math.sqrt(d)) * mask
        num = num + torch.einsum("bhgij,bhjd->bhgid", s, v)
        den = den + torch.sum(s, dim=-1)
    if use_stream:
        mask = ((~same_chunk) & causal).to(q.dtype)
        s = torch.einsum("bhgim,bhjm->bhgij", phi_q, phi_k) * mask
        num = num + torch.einsum("bhgij,bhjd->bhgid", s, v)
        den = den + torch.sum(s, dim=-1)
    return num, den


def _check(q, k, v, phi_q, phi_k, L):
    BH, Gq, T, d = q.shape
    dv, m = v.shape[-1], phi_q.shape[-1]
    want = {
        "q": (q, (BH, Gq, T, d)), "k": (k, (BH, T, d)), "v": (v, (BH, T, dv)),
        "phi_q": (phi_q, (BH, Gq, T, m)), "phi_k": (phi_k, (BH, T, m)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"chimera_attention: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype not in TYPES:
            raise TypeError(f"chimera_attention: {name} must be one of {TYPES}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"chimera_attention: {name} on {t.device}, q on {q.device}")
    if T % L:
        raise ValueError(f"chimera_attention: T={T} must be divisible by chunk_size={L}")
    return BH, Gq, T, d, dv, m


def chimera_attention_bh(
    q: torch.Tensor,  # (BH, Gq, T, d) normalized queries, BH = B * Hkv
    k: torch.Tensor,  # (BH, T, d)
    v: torch.Tensor,  # (BH, T, dv)
    phi_q: torch.Tensor,  # (BH, Gq, T, m)
    phi_k: torch.Tensor,  # (BH, T, m)
    *,
    chunk_size: int,
    use_local: bool = True,
    use_stream: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(num (BH,Gq,T,dv), den (BH,Gq,T))``."""
    global launches
    L = chunk_size
    BH, Gq, T, d, dv, m = _check(q, k, v, phi_q, phi_k, L)
    # the stated cast: bfloat16 inputs are computed in float32 on either route,
    # and the partials come back in the inputs' common type (jnp's promotion)
    dtype = q.dtype
    for t in (k, v, phi_q, phi_k):
        dtype = torch.promote_types(dtype, t.dtype)
    q, k, v, phi_q, phi_k = (t.float() for t in (q, k, v, phi_q, phi_k))
    if q.device.type == "cpu":
        num, den = chimera_attention_partials_plain(
            q[:, None], k[:, None], v[:, None], phi_q[:, None], phi_k[:, None],
            L, use_local, use_stream,
        )
        return num[:, 0].to(dtype), den[:, 0].to(dtype)
    if q.device.type != "cuda":
        raise RuntimeError(f"chimera_attention: no kernel for device {q.device}")
    refused = contract(d=d, dv=dv, m=m, L=L)
    if refused:
        raise ValueError(f"chimera_attention: outside the kernel's contract: {refused}")
    for t in (q, k, v, phi_q, phi_k):
        if not t.is_contiguous():
            raise ValueError("chimera_attention: the kernel takes contiguous tensors only")
    lib = _build.load_library()
    num = torch.empty((BH, Gq, T, dv), dtype=torch.float32, device=q.device)
    den = torch.empty((BH, Gq, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flags = (1.0 / math.sqrt(d), int(bool(use_local)), int(bool(use_stream)))
    if L == L_LONG:
        # the stream state before every chunk (scratch)
        state = None
        if use_stream and T > L:
            state = torch.empty(long_state_shape(BH, T, dv, m), dtype=torch.float32,
                                device=q.device)
        err = lib.chimera_attention_long_launch(
            *map(_build.ptr, (q, k, v, phi_q, phi_k, num, den, state)),
            BH, Gq, T, d, dv, m, L, *flags, stream,
        )
    else:
        err = lib.chimera_attention_launch(
            *map(_build.ptr, (q, k, v, phi_q, phi_k, num, den)),
            BH, Gq, T, d, dv, m, L, *flags, stream,
        )
    _build.check(err, "chimera_attention")
    launches += 1
    return num.to(dtype), den.to(dtype)


class _Partials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, phi_q, phi_k, chunk_size, use_local, use_stream):
        B, Hkv, Gq, T, d = q.shape
        BH = B * Hkv
        num, den = chimera_attention_bh(
            q.reshape(BH, Gq, T, d).contiguous(),
            k.reshape(BH, T, d).contiguous(),
            v.reshape(BH, T, v.shape[-1]).contiguous(),
            phi_q.reshape(BH, Gq, T, phi_q.shape[-1]).contiguous(),
            phi_k.reshape(BH, T, phi_k.shape[-1]).contiguous(),
            chunk_size=chunk_size, use_local=use_local, use_stream=use_stream,
        )
        ctx.save_for_backward(q, k, v, phi_q, phi_k)
        ctx.cfg = (chunk_size, use_local, use_stream)
        return num.reshape(B, Hkv, Gq, T, -1), den.reshape(B, Hkv, Gq, T)

    @staticmethod
    def backward(ctx, g_num, g_den):
        saved = ctx.saved_tensors
        need = [i for i in range(5) if ctx.needs_input_grad[i]]
        grads = [None] * 8
        if not need:
            return tuple(grads)
        with torch.enable_grad():
            # in float32, as the forward (autograd casts the grads back)
            xs = [x.detach().float().requires_grad_(i in need) for i, x in enumerate(saved)]
            num, den = chimera_attention_partials_plain(*xs, *ctx.cfg)
            got = torch.autograd.grad(
                (num, den), [xs[i] for i in need], (g_num, g_den), allow_unused=True
            )
        for i, g in zip(need, got):
            grads[i] = g
        return tuple(grads)


def chimera_attention_partials(
    q: torch.Tensor,  # (B, Hkv, Gq, T, d) normalized
    k: torch.Tensor,  # (B, Hkv, T, d) normalized
    v: torch.Tensor,  # (B, Hkv, T, dv)
    phi_q: torch.Tensor,  # (B, Hkv, Gq, T, m)
    phi_k: torch.Tensor,  # (B, Hkv, T, m)
    chunk_size: int = 128,
    use_local: bool = True,
    use_stream: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(num (B,Hkv,Gq,T,dv), den (B,Hkv,Gq,T))`` partials;
    differentiable through the plain formulation."""
    return _Partials.apply(q, k, v, phi_q, phi_k, chunk_size, use_local, use_stream)
