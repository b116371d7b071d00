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
* :func:`chimera_attention_bwd_plain` — the partials' gradients chunk by
  chunk (the local tier per chunk, the stream tier through the carried
  state and its reverse prefix), never a (T, T) tensor: the CPU route of the
  backward and the yardstick of its kernel.
* :func:`chimera_attention_bwd_bh` — the backward's wrapper on the
  flattened layout: it launches ``csrc/chimera_attention_bwd.cu`` (which
  replaces ``repro/kernels/chimera_attention/ops.py::_bwd``, ``jax.vjp`` of
  the dense reference) for CUDA tensors and runs the plain version for CPU
  tensors; any other device raises, and a failed build or launch raises.
  Two routes by the inputs' types (:func:`bwd_route`): q, k, v, the
  features and g_num all bfloat16, as a bfloat16 model's training step
  passes them, take the bf16 route (wgmma and TMA; those six read as they
  are, g_den widened to float32); any other mix is widened to float32 for
  the fp32 route.  ``bwd_launches`` counts the launches of both,
  ``bwd_launches_fp32`` and ``bwd_launches_bf16`` those of each
  (:func:`bwd_kernel_launches` a call).
* :func:`chimera_attention_partials` — the port of the JAX ``custom_vjp``
  (``repro/kernels/chimera_attention/ops.py``): the forward takes
  :func:`chimera_attention_bh`'s route, the backward
  :func:`chimera_attention_bwd_bh`'s.  Autograd of the dense plain version
  is left to the tests.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build

launches = 0  # forward kernel launches
bwd_launches = 0  # the backward's kernel launches (bwd_kernel_launches per call)
bwd_launches_fp32 = 0  # the same, of the fp32 route
bwd_launches_bf16 = 0  # and of the bf16 route (bwd_route)

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


def _exclusive_prefix(x: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    """Sum of the entries before each one along ``dim`` (after it where
    ``reverse``), summed directly rather than as a difference of cumsums."""
    if reverse:
        return _exclusive_prefix(x.flip(dim), dim).flip(dim)
    head = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([head, torch.cumsum(x.narrow(dim, 0, x.shape[dim] - 1), dim)], dim)


def chimera_attention_bwd_plain(
    q: torch.Tensor,  # (B, Hkv, Gq, T, d) normalized queries
    k: torch.Tensor,  # (B, Hkv, T, d) normalized keys
    v: torch.Tensor,  # (B, Hkv, T, dv)
    phi_q: torch.Tensor,  # (B, Hkv, Gq, T, m)
    phi_k: torch.Tensor,  # (B, Hkv, T, m)
    g_num: torch.Tensor,  # (B, Hkv, Gq, T, dv) the gradient of num
    g_den: torch.Tensor,  # (B, Hkv, Gq, T) the gradient of den
    chunk_size: int,
    use_local: bool = True,
    use_stream: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv, dphi_q, dphi_k)`` of :func:`chimera_attention_partials_plain`
    chunk by chunk, in the inputs' common type, without a (T, T) tensor.

    Local tier, per chunk (keys j <= i of query i's chunk): s_ij =
    exp(q_i.k_j / sqrt(d)), dP_ij = g_num_i.v_j + g_den_i, dS = s dP /
    sqrt(d); dq = dS k, dk = dS^T q, dv = s^T g_num (unnormalized: no lse,
    no rowsum term).  Stream tier: S_c, Z_c the state before chunk c (the
    exclusive prefix of phi_k^T [v | 1] over the chunks, as the forward
    carries it); dphi_q = S_c g_num + Z_c g_den; G_c = sum over chunk c's
    queries of phi_q [g_num | g_den]^T, R_c its exclusive prefix from the
    end; dphi_k_j = R_c [v_j | 1] and dv_j += R_c[:, :dv]^T phi_k_j."""
    B, H, Gq, T, d = q.shape
    dv, m, L = v.shape[-1], phi_q.shape[-1], chunk_size
    n = T // L
    qc = q.reshape(B, H, Gq, n, L, d)
    kc = k.reshape(B, H, n, L, d)
    vc = v.reshape(B, H, n, L, dv)
    pqc = phi_q.reshape(B, H, Gq, n, L, m)
    pkc = phi_k.reshape(B, H, n, L, m)
    gnc = g_num.reshape(B, H, Gq, n, L, dv)
    gdc = g_den.reshape(B, H, Gq, n, L)
    dq, dk, dvv = torch.zeros_like(qc), torch.zeros_like(kc), torch.zeros_like(vc)
    dpq, dpk = torch.zeros_like(pqc), torch.zeros_like(pkc)
    if use_local:
        scale = 1.0 / math.sqrt(d)
        causal = torch.tril(torch.ones((L, L), dtype=q.dtype, device=q.device))
        s = torch.exp(torch.einsum("bhgcid,bhcjd->bhgcij", qc, kc) * scale) * causal
        dp = torch.einsum("bhgcie,bhcje->bhgcij", gnc, vc) + gdc[..., None]
        ds = s * dp * scale
        dq = dq + torch.einsum("bhgcij,bhcjd->bhgcid", ds, kc)
        dk = dk + torch.einsum("bhgcij,bhgcid->bhcjd", ds, qc)
        dvv = dvv + torch.einsum("bhgcij,bhgcie->bhcje", s, gnc)
        del s, dp, ds
    if use_stream and n > 1:
        S = _exclusive_prefix(torch.einsum("bhcjm,bhcje->bhcme", pkc, vc), 2)
        Z = _exclusive_prefix(torch.sum(pkc, dim=3), 2)
        dpq = torch.einsum("bhgcie,bhcme->bhgcim", gnc, S) + gdc[..., None] * Z[:, :, None, :, None]
        R = _exclusive_prefix(torch.einsum("bhgcim,bhgcie->bhcme", pqc, gnc), 2, reverse=True)
        Rz = _exclusive_prefix(torch.einsum("bhgcim,bhgci->bhcm", pqc, gdc), 2, reverse=True)
        dpk = torch.einsum("bhcje,bhcme->bhcjm", vc, R) + Rz[:, :, :, None]
        dvv = dvv + torch.einsum("bhcjm,bhcme->bhcje", pkc, R)
    return (dq.reshape(q.shape), dk.reshape(k.shape), dvv.reshape(v.shape),
            dpq.reshape(phi_q.shape), dpk.reshape(phi_k.shape))


def bwd_kernel_launches(T: int, L: int, use_stream: bool = True, use_local: bool = True,
                        route: str = "fp32") -> int:
    """Kernel launches of one backward call (csrc/chimera_attention_bwd.cu).
    fp32: the dK/dV and dQ kernels, and where the stream tier carries state
    (use_stream, more than one chunk) the per-chunk fold, and the prefix
    over the chunks where there are more than two.  bf16: where a state is
    carried the fold and the prefix, the stream tier's kernel, and with the
    local tier the dK/dV and dQ kernels."""
    n = T // L
    carried = use_stream and n > 1
    if route == "fp32":
        return 2 + int(carried) + int(use_stream and n > 2)
    if route != "bf16":
        raise ValueError(f"chimera_attention backward: no route {route!r}")
    return 2 * int(carried) + 1 + 2 * int(use_local)


def bwd_route(*xs: torch.Tensor) -> str:
    """The backward's route for q, k, v, phi_q, phi_k and g_num: "bf16"
    where all six are bfloat16, else "fp32"."""
    return "bf16" if all(t.dtype == torch.bfloat16 for t in xs) else "fp32"


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


def chimera_attention_bwd_bh(
    q: torch.Tensor,  # (BH, Gq, T, d) normalized queries, BH = B * Hkv
    k: torch.Tensor,  # (BH, T, d)
    v: torch.Tensor,  # (BH, T, dv)
    phi_q: torch.Tensor,  # (BH, Gq, T, m)
    phi_k: torch.Tensor,  # (BH, T, m)
    g_num: torch.Tensor,  # (BH, Gq, T, dv)
    g_den: torch.Tensor,  # (BH, Gq, T)
    *,
    chunk_size: int,
    use_local: bool = True,
    use_stream: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv, dphi_q, dphi_k)`` in float32 on the flattened layout:
    csrc/chimera_attention_bwd.cu for CUDA tensors, by :func:`bwd_route`
    (the first six inputs in bf16 as they are, or every input widened to
    float32), the plain version for CPU tensors (bfloat16 inputs widened to
    float32); any other device raises."""
    global bwd_launches, bwd_launches_fp32, bwd_launches_bf16
    L = chunk_size
    BH, Gq, T, d, dv, m = _check(q, k, v, phi_q, phi_k, L)
    for name, t, shape in (("g_num", g_num, (BH, Gq, T, dv)), ("g_den", g_den, (BH, Gq, T))):
        if tuple(t.shape) != shape:
            raise ValueError(f"chimera_attention backward: {name} has shape {tuple(t.shape)}, "
                             f"want {shape}")
        if t.dtype not in TYPES or t.device != q.device:
            raise ValueError(f"chimera_attention backward: {name} must be one of {TYPES} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    route = bwd_route(q, k, v, phi_q, phi_k, g_num)
    if q.device.type == "cpu":
        xs = [t.float() for t in (q, k, v, phi_q, phi_k, g_num, g_den)]
        got = chimera_attention_bwd_plain(
            *(x[:, None] for x in xs), L, use_local, use_stream)
        return tuple(x[:, 0] for x in got)
    if q.device.type != "cuda":
        raise RuntimeError(f"chimera_attention backward: no kernel for device {q.device}")
    refused = contract(d=d, dv=dv, m=m, L=L)
    if refused:
        raise ValueError(f"chimera_attention backward: outside the kernel's contract: {refused}")
    # on the bf16 route q, k, v, phi_q, phi_k and g_num in bf16 as they are,
    # g_den in float32; on the fp32 route all in float32; contiguous, 16-byte
    # aligned rows (the kernels read their inputs by 16-byte copies)
    xs = [t if route == "bf16" and i < 6 else t.float()
          for i, t in enumerate((q, k, v, phi_q, phi_k, g_num, g_den))]
    xs = [x.contiguous() for x in xs]
    xs = [x if x.data_ptr() % 16 == 0 else x.clone() for x in xs]
    lib = _build.load_library()
    scale, tiers = 1.0 / math.sqrt(d), (int(bool(use_local)), int(bool(use_stream)))
    cuda_stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "bf16":
        # without the local tier the kernels leave dq and dk alone
        grads = [torch.zeros_like(x, dtype=torch.float32) if i < 2 and not use_local
                 else torch.empty_like(x, dtype=torch.float32) for i, x in enumerate(xs[:5])]
        nbytes = lib.chimera_attention_bwd_bf16_scratch(BH, T, dv, m, L, int(bool(use_stream)))
        scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=q.device)
        err = lib.chimera_attention_bwd_bf16_launch(
            *map(_build.ptr, (*xs, *grads, scratch)), BH, Gq, T, d, dv, m, L, scale, *tiers,
            cuda_stream)
    else:
        grads = [torch.empty_like(x) for x in xs[:5]]
        state = rstate = None
        if use_stream and T > L:  # the state before each chunk, and R after it (scratch)
            state = torch.empty((BH, T // L, m, dv + 8), dtype=torch.float32, device=q.device)
            rstate = torch.empty_like(state)
        err = lib.chimera_attention_bwd_launch(
            *map(_build.ptr, (*xs, *grads, state, rstate)), BH, Gq, T, d, dv, m, L, scale, *tiers,
            cuda_stream)
    _build.check(err, f"chimera_attention backward ({route} route)")
    count = bwd_kernel_launches(T, L, use_stream, use_local, route)
    bwd_launches += count
    if route == "bf16":
        bwd_launches_bf16 += count
    else:
        bwd_launches_fp32 += count
    return tuple(grads)


class _Partials(torch.autograd.Function):
    """The forward through :func:`chimera_attention_bh`, the backward through
    :func:`chimera_attention_bwd_bh` (the kernels on CUDA tensors)."""

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
    @once_differentiable
    def backward(ctx, g_num, g_den):
        saved = ctx.saved_tensors
        if not any(ctx.needs_input_grad[:5]):
            return (None,) * 8
        q = saved[0]
        B, Hkv, Gq, T, _ = q.shape
        BH = B * Hkv
        L, use_local, use_stream = ctx.cfg
        flat = [x.reshape((BH,) + tuple(x.shape[2:])) for x in saved]
        got = chimera_attention_bwd_bh(
            *flat, g_num.reshape(BH, Gq, T, -1), g_den.reshape(BH, Gq, T),
            chunk_size=L, use_local=use_local, use_stream=use_stream,
        )
        grads = [g.reshape(x.shape).to(x.dtype) if ctx.needs_input_grad[i] else None
                 for i, (g, x) in enumerate(zip(got, saved))]
        return (*grads, None, None, None)


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
    """Returns ``(num (B,Hkv,Gq,T,dv), den (B,Hkv,Gq,T))`` partials,
    differentiable: the backward runs csrc/chimera_attention_bwd.cu on CUDA
    tensors and :func:`chimera_attention_bwd_plain` on CPU tensors."""
    return _Partials.apply(q, k, v, phi_q, phi_k, chunk_size, use_local, use_stream)
