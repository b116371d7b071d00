"""Causal sliding-window softmax attention and its non-causal mode: the CUDA
kernels' wrappers, the autograd Function around them, and their plain
versions.

Replaces ``repro/kernels/window_attention/kernel.py::window_attention_pallas``
with ``csrc/window_attention.cu`` (the SWA prefill of Mixtral's softmax
variant, and at W = T the full-causal softmax prefill of
``models/attention.py``'s ``blockwise_softmax_attention``), and the backward
of the JAX op's ``custom_vjp`` (``repro/kernels/window_attention/ops.py``
``_bwd`` :37-40, autodiff of the jnp reference) with
``csrc/window_attention_bwd.cu``.  Row i attends to the keys j with
0 <= i - j < W, scale 1/sqrt(d); the output is in q's dtype.

* :func:`window_attention_plain` — the port of
  ``repro/kernels/window_attention/ref.py``, with dense (T, T) masks, on the
  flattened (batch × head) layout; :func:`window_attention_lse_plain` its
  rows' log-sum-exp and :func:`window_attention_bwd_plain` its backward on
  the same layout (the tests and the card's checks use them; no main path
  does).
* :func:`sliding_window_attention` — the wrapper on the (B, H, T, d) layout,
  like the JAX package's ``ops.sliding_window_attention``, differentiable.
  K and V keep their kv-heads (``Hkv`` dividing ``H``); the kernels read
  kv-head ``h // (H / Hkv)`` for query head h, where the reference repeats
  K and V to ``H`` heads first.  For CUDA tensors it launches the forward
  kernel; when an input needs a gradient, through :class:`_WindowAttention`,
  whose forward also writes each row's log-sum-exp and saves (q, k, v, o,
  lse), and whose backward launches the three kernels of
  :func:`window_attention_bwd` (D = rowsum(dO o); dK and dV a block per
  kv-head and key tile, the kv-head's query heads summed inside it; dQ;
  bf16 products on the tensor cores, fp32 ones on the CUDA cores).
  For CPU tensors it runs the plain version, which autograd differentiates;
  any other device raises.  :func:`window_attention_fwd` and
  :func:`window_attention_bwd`, the Function's two halves, take CUDA
  tensors only.  The kernels take any T and W and the head
  widths of :data:`DIMS_TAKEN`, in float32 or bfloat16 (fp32 accumulation,
  results in the inputs' type); :func:`contract` mirrors the launchers'
  checks for the forward and the backward alike, and the wrappers raise
  ``ValueError`` before any launch on a shape outside them.  No wrapper
  falls back to the plain version when a build or a launch fails.
* :func:`noncausal_attention` — the kernels' non-causal mode on the same
  layout, for ``blockwise_softmax_attention(causal=False)`` (the encoder of
  whisper-tiny, which JAX computes in jnp, and its softmax
  cross-attention): queries (B, H, Tq, d) against keys and values of their
  own length Tk, every key seen by every row; differentiable on both
  routes.  For CUDA tensors that need a gradient it runs
  :class:`_NonCausalAttention`: the forward kernel's non-causal mode with
  each row's lse, and the backward kernels' non-causal mode
  (:func:`window_attention_noncausal_bwd`, Tq and Tk apart); it never falls
  back to the plain version.  :func:`window_attention_noncausal_plain` is
  its plain version on the flattened layout,
  :func:`noncausal_attention_plain` on the wrapper's;
  :func:`window_attention_noncausal_lse_plain` and
  :func:`window_attention_noncausal_bwd_plain` are the plain lse and
  backward on the flattened layout.
* ``launches`` counts every kernel launch of the module, forward (both
  modes) and backward (never plain calls); ``bwd_launches`` the backward's
  alone, both modes (three per backward); ``noncausal_launches`` the
  non-causal forward's alone, ``noncausal_bwd_launches`` the non-causal
  backward's alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build

launches = 0  # forward and backward kernel launches
bwd_launches = 0  # the backward's kernel launches alone, both modes (three per backward)
noncausal_launches = 0  # the forward's non-causal mode alone
noncausal_bwd_launches = 0  # the backward's non-causal mode alone (three per backward)

# the launcher's contract (csrc/window_attention.cu): the (d, dv) pairs it
# is built for; (96, 64) and (24, 16) are MLA's heads at full and smoke width
DIMS_TAKEN = ((64, 64), (64, 128), (128, 64), (128, 128), (16, 16), (32, 32), (96, 64),
              (24, 16))


def contract(*, d: int, dv: int, H: int, Hkv: int, window: int = 0, causal: bool = True,
             n_q: int = 1, n_k: int = 1) -> Optional[str]:
    """``None`` if the kernels take these widths, else what they refuse: the
    forward and backward launchers' checks (the same for both, in each
    mode), mirrored so that a shape outside them raises here rather than as
    a CUDA error code.  ``causal`` (the banded mode) needs ``window`` >= 1;
    the non-causal mode needs ``n_q`` >= 1 query rows and ``n_k`` >= 1
    keys."""
    if (d, dv) not in DIMS_TAKEN:
        return f"(d, dv) = ({d}, {dv}) not in {DIMS_TAKEN}"
    if Hkv <= 0 or H % Hkv:
        return f"{H} query heads over {Hkv} kv-heads"
    if causal and window < 1:
        return f"window {window} < 1"
    if not causal and n_q < 1:
        return f"{n_q} query rows < 1"
    if not causal and n_k < 1:
        return f"{n_k} keys < 1"
    return None


def _band(T: int, window: int, device) -> torch.Tensor:
    idx = torch.arange(T, device=device)
    delta = idx[:, None] - idx[None, :]
    return (delta >= 0) & (delta < window)


def window_attention_plain(
    q: torch.Tensor,  # (BH, T, d)
    k: torch.Tensor,  # (BH, T, d)
    v: torch.Tensor,  # (BH, T, dv)
    window: int,
) -> torch.Tensor:
    T, d = q.shape[-2], q.shape[-1]
    scores = torch.einsum("bid,bjd->bij", q, k) / math.sqrt(d)
    scores = torch.where(_band(T, window, q.device)[None], scores, float("-inf"))
    w = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.einsum("bij,bjd->bid", w, v)


def sliding_window_attention_plain(q, k, v, window: int) -> torch.Tensor:
    """The plain version on the wrapper's layout: K and V repeated to the
    query heads (as ``models/attention.py:116-118`` does), then flattened."""
    B, H, T, d = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).reshape(B * H, T, d)
    v = v.repeat_interleave(G, dim=1).reshape(B * H, T, v.shape[-1])
    return window_attention_plain(q.reshape(B * H, T, d), k, v, window).reshape(B, H, T, -1)


def window_attention_noncausal_plain(
    q: torch.Tensor,  # (BH, Tq, d)
    k: torch.Tensor,  # (BH, Tk, d)
    v: torch.Tensor,  # (BH, Tk, dv)
) -> torch.Tensor:
    """The non-causal mode's function: every query row against all Tk keys,
    scale 1/sqrt(d), dense (Tq, Tk) scores."""
    d = q.shape[-1]
    scores = torch.einsum("bid,bjd->bij", q, k) / math.sqrt(d)
    w = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.einsum("bij,bjd->bid", w, v)


def noncausal_attention_plain(q, k, v) -> torch.Tensor:
    """The non-causal plain version on the wrapper's layout: K and V repeated
    to the query heads, then flattened."""
    B, H, Tq, d = q.shape
    G, Tk = H // k.shape[1], k.shape[2]
    k = k.repeat_interleave(G, dim=1).reshape(B * H, Tk, d)
    v = v.repeat_interleave(G, dim=1).reshape(B * H, Tk, v.shape[-1])
    return window_attention_noncausal_plain(q.reshape(B * H, Tq, d), k, v).reshape(B, H, Tq, -1)


def _lse_plain(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    ft = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bid,bjd->bij", q.to(ft), k.to(ft)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = torch.where(mask[None], scores, float("-inf"))
    return torch.logsumexp(scores, dim=-1)


def window_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, window: int) -> torch.Tensor:
    """Each row's log-sum-exp of its in-band scaled scores, log sum_j
    exp(q_i k_j / sqrt(d)): (BH, T) in float32 (float64 for float64 inputs),
    from q (BH, T, d) and k (BH, T, d)."""
    return _lse_plain(q, k, _band(q.shape[-2], window, q.device))


def window_attention_noncausal_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The non-causal mode's lse: each row's log-sum-exp over all Tk keys,
    (BH, Tq) in float32 (float64 for float64 inputs), from q (BH, Tq, d) and
    k (BH, Tk, d)."""
    return _lse_plain(q, k, None)


def _bwd_plain(q, k, v, o, lse, do, mask: Optional[torch.Tensor]):
    BH, Tq, d = q.shape
    BHkv, dv = k.shape[0], v.shape[-1]
    G = BH // BHkv
    ft = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(ft).reshape(BHkv, G, Tq, d)
    og = o.to(ft).reshape(BHkv, G, Tq, dv)
    dog = do.to(ft).reshape(BHkv, G, Tq, dv)
    kf, vf = k.to(ft), v.to(ft)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("kgid,kjd->kgij", qg, kf) * scale
    p = torch.exp(s - lse.to(ft).reshape(BHkv, G, Tq)[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("kgic,kjc->kgij", dog, vf)
    delta = torch.sum(dog * og, dim=-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("kgij,kjd->kgid", ds, kf) * scale
    dk = torch.einsum("kgij,kgid->kjd", ds, qg) * scale
    dvv = torch.einsum("kgij,kgic->kjc", p, dog)
    out = q.dtype
    return dq.reshape(BH, Tq, d).to(out), dk.to(out), dvv.to(out)


def window_attention_bwd_plain(
    q: torch.Tensor,  # (B*H, T, d)
    k: torch.Tensor,  # (B*Hkv, T, d)
    v: torch.Tensor,  # (B*Hkv, T, dv)
    o: torch.Tensor,  # (B*H, T, dv), the forward's output
    lse: torch.Tensor,  # (B*H, T), the forward's log-sum-exp
    do: torch.Tensor,  # (B*H, T, dv)
    window: int,
):
    """``(dq, dk, dv)`` of the banded softmax attention in plain tensor code,
    the kernels' function on their flattened layout: query head h of a batch
    row reads kv-head h // G (G = q rows / k rows; G 1 for K and V repeated
    to the query heads), and dk, dv sum over each kv-head's G query heads.
    P = exp(q k^T / sqrt(d) - lse) in the band, D = rowsum(do o),
    dS = P (do v^T - D), dq = dS k / sqrt(d), dk = dS^T q / sqrt(d),
    dv = P^T do; float32 arithmetic (float64 for float64 inputs), results
    in q's dtype.  Dense (T, T) intermediates: for tests and checks."""
    return _bwd_plain(q, k, v, o, lse, do, _band(q.shape[1], window, q.device))


def window_attention_noncausal_bwd_plain(
    q: torch.Tensor,  # (B*H, Tq, d)
    k: torch.Tensor,  # (B*Hkv, Tk, d)
    v: torch.Tensor,  # (B*Hkv, Tk, dv)
    o: torch.Tensor,  # (B*H, Tq, dv), the forward's output
    lse: torch.Tensor,  # (B*H, Tq), the forward's log-sum-exp
    do: torch.Tensor,  # (B*H, Tq, dv)
):
    """``(dq, dk, dv)`` of the non-causal mode in plain tensor code, the
    non-causal backward kernels' function on their flattened layout: as
    :func:`window_attention_bwd_plain` with every (row, key) pair in and Tq
    and Tk apart.  Dense (Tq, Tk) intermediates: for tests and checks."""
    return _bwd_plain(q, k, v, o, lse, do, None)


def _check(q, k, v, window, causal=True):
    """Shapes, types and devices of a call; causal calls take Tk == T and a
    window >= 1, non-causal ones any Tk >= 1 (``window`` unused)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("window_attention: q, k, v must be (B, heads, T, dim)")
    B, H, T, d = q.shape
    Hkv, Tk, dv = k.shape[1], k.shape[2], v.shape[-1]
    if (causal and Tk != T) or tuple(k.shape) != (B, Hkv, Tk, d) \
            or tuple(v.shape) != (B, Hkv, Tk, dv):
        keys = "T" if causal else "Tk"
        raise ValueError(f"window_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not fit (B, H, T, d) / (B, Hkv, {keys}, d | dv)")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"window_attention: {H} query heads over {Hkv} kv-heads")
    if causal and window < 1:
        raise ValueError(f"window_attention: window must be >= 1, got {window}")
    if not causal and Tk < 1:
        raise ValueError("window_attention: the non-causal mode needs at least one key")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"window_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"window_attention: {name} on {t.device}, q on {q.device}")
    return B, H, Hkv, T, d, dv


def _kernel_shapes(q, k, v, window, causal=True):
    """The checks every launch makes before it launches: device, dtype,
    contiguity and the launchers' contract."""
    B, H, Hkv, T, d, dv = _check(q, k, v, window, causal)
    if q.device.type != "cuda":
        raise RuntimeError(f"window_attention: no kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention: the kernel takes float32 or bfloat16, got {q.dtype}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("window_attention: the kernel takes contiguous tensors only")
    refused = contract(d=d, dv=dv, H=H, Hkv=Hkv, window=window, causal=causal,
                       n_q=T, n_k=k.shape[2])
    if refused:
        raise ValueError(f"window_attention: outside the kernel's contract: {refused}")
    return B, H, Hkv, T, d, dv


def _launch_forward(q, k, v, window: int, with_lse: bool):
    """The forward kernel: ``(o, lse)``, lse (B, H, T) float32 or None."""
    global launches
    B, H, Hkv, T, d, dv = _kernel_shapes(q, k, v, window)
    # the launcher checks alignment and the grid too, and returns
    # cudaErrorInvalidValue for what it does not take
    lib = _build.load_library()
    o = torch.empty((B, H, T, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if with_lse else None
    err = lib.window_attention_launch(
        *map(_build.ptr, (q, k, v, o, lse)), B * H, H, Hkv, T, d, dv, int(window),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "window_attention")
    launches += 1
    return o, lse


def _launch_noncausal(q, k, v, with_lse: bool):
    """The forward kernel's non-causal mode: ``(o (B, H, Tq, dv), lse (B, H,
    Tq) float32 or None)``."""
    global launches, noncausal_launches
    B, H, Hkv, T, d, dv = _kernel_shapes(q, k, v, 0, causal=False)
    lib = _build.load_library()
    o = torch.empty((B, H, T, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if with_lse else None
    err = lib.window_attention_noncausal_launch(
        *map(_build.ptr, (q, k, v, o, lse)), B * H, H, Hkv, T, k.shape[2], d, dv,
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "window_attention (non-causal)")
    launches += 1
    noncausal_launches += 1
    return o, lse


def window_attention_fwd(q, k, v, window: int):
    """``(o (B, H, T, dv), lse (B, H, T) float32)``: the forward kernel with
    each row's log-sum-exp, as the autograd Function runs it (CUDA tensors
    only; the plain counterpart is :func:`window_attention_lse_plain`)."""
    return _launch_forward(q, k, v, window, with_lse=True)


def window_attention_noncausal_fwd(q, k, v):
    """``(o (B, H, Tq, dv), lse (B, H, Tq) float32)``: the forward kernel's
    non-causal mode with each row's log-sum-exp, as
    :class:`_NonCausalAttention` runs it (CUDA tensors only; the plain
    counterpart is :func:`window_attention_noncausal_lse_plain`)."""
    return _launch_noncausal(q, k, v, with_lse=True)


def _launch_backward(q, k, v, o, lse, do, window: int, causal: bool):
    """The three backward kernels in either mode: ``(dq, dk, dv)``."""
    global launches, bwd_launches, noncausal_bwd_launches
    B, H, Hkv, T, d, dv = _check(q, k, v, window, causal)
    if tuple(o.shape) != (B, H, T, dv) or tuple(do.shape) != (B, H, T, dv) \
            or tuple(lse.shape) != (B, H, T):
        raise ValueError(f"window_attention backward: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} do not fit "
                         f"(B, H, T, dv) / (B, H, T)")
    _kernel_shapes(q, k, v, window, causal)
    for name, t in (("o", o), ("do", do)):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"window_attention backward: {name} must be contiguous "
                             f"{q.dtype} on {q.device}")
    if lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("window_attention backward: lse must be contiguous float32 on "
                         f"{q.device}")
    lib = _build.load_library()
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)  # D = rowsum(do o)
    ptrs = map(_build.ptr, (q, k, v, o, lse, do, dq, dk, dvv, delta))
    bf16, stream = int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream
    if causal:
        err = lib.window_attention_bwd_launch(*ptrs, B * H, H, Hkv, T, d, dv, int(window),
                                              1.0 / math.sqrt(d), bf16, stream)
    else:
        err = lib.window_attention_noncausal_bwd_launch(*ptrs, B * H, H, Hkv, T, k.shape[2], d,
                                                        dv, 1.0 / math.sqrt(d), bf16, stream)
    _build.check(err, "window_attention backward" + ("" if causal else " (non-causal)"))
    launches += 3
    bwd_launches += 3
    if not causal:
        noncausal_bwd_launches += 3
    return dq, dk, dvv


def window_attention_bwd(q, k, v, o, lse, do, window: int):
    """``(dq, dk, dv)`` on the wrapper's layout (dk, dv per kv-head) from the
    forward's o and lse and the output's gradient do: the three backward
    kernels (CUDA tensors only; the plain counterpart is
    :func:`window_attention_bwd_plain`)."""
    return _launch_backward(q, k, v, o, lse, do, window, causal=True)


def window_attention_noncausal_bwd(q, k, v, o, lse, do):
    """``(dq, dk, dv)`` of the non-causal mode on the wrapper's layout: q, o,
    do (B, H, Tq, ·), lse (B, H, Tq), k and v (B, Hkv, Tk, ·); the three
    backward kernels' non-causal mode (CUDA tensors only; the plain
    counterpart is :func:`window_attention_noncausal_bwd_plain`)."""
    return _launch_backward(q, k, v, o, lse, do, 0, causal=False)


class _WindowAttention(torch.autograd.Function):
    """The forward kernel with lse, and the backward kernels (CUDA only)."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = _launch_forward(q, k, v, window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = window_attention_bwd(q, k, v, o, lse, do.to(q.dtype).contiguous(),
                                          ctx.window)
        return dq, dk, dv, None


class _NonCausalAttention(torch.autograd.Function):
    """The forward kernel's non-causal mode with lse, and the backward
    kernels' non-causal mode (CUDA only)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _launch_noncausal(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return window_attention_noncausal_bwd(q, k, v, o, lse, do.to(q.dtype).contiguous())


def sliding_window_attention(
    q: torch.Tensor,  # (B, H, T, d)
    k: torch.Tensor,  # (B, Hkv, T, d)
    v: torch.Tensor,  # (B, Hkv, T, dv)
    window: int,
) -> torch.Tensor:
    """Returns (B, H, T, dv) in q's dtype; differentiable on both routes."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return sliding_window_attention_plain(q, k, v, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _WindowAttention.apply(q, k, v, window)
    return _launch_forward(q, k, v, window, with_lse=False)[0]


def noncausal_attention(
    q: torch.Tensor,  # (B, H, Tq, d)
    k: torch.Tensor,  # (B, Hkv, Tk, d)
    v: torch.Tensor,  # (B, Hkv, Tk, dv)
) -> torch.Tensor:
    """Returns (B, H, Tq, dv) in q's dtype: softmax attention of every query
    row over all Tk keys; differentiable on both routes.  CPU tensors run
    the plain version (which autograd differentiates); CUDA tensors the
    kernels' non-causal mode, through :class:`_NonCausalAttention` when an
    input needs a gradient."""
    _check(q, k, v, 0, causal=False)
    if q.device.type == "cpu":
        return noncausal_attention_plain(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _NonCausalAttention.apply(q, k, v)
    return _launch_noncausal(q, k, v, with_lse=False)[0]
