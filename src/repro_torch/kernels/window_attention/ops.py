"""Causal sliding-window softmax attention: the CUDA kernel's wrapper and its
plain version.

Replaces ``repro/kernels/window_attention/kernel.py::window_attention_pallas``
with ``csrc/window_attention.cu`` (the SWA prefill of Mixtral's softmax
variant, and at W = T the full-causal softmax prefill of
``models/attention.py``'s ``blockwise_softmax_attention``).  Row i attends to
the keys j with 0 <= i - j < W, scale 1/sqrt(d); the output is in q's dtype.

* :func:`window_attention_plain` — the port of
  ``repro/kernels/window_attention/ref.py``, with dense (T, T) masks, on the
  flattened (batch × head) layout.
* :func:`sliding_window_attention` — the wrapper on the (B, H, T, d) layout,
  like the JAX package's ``ops.sliding_window_attention``.  K and V keep
  their kv-heads (``Hkv`` dividing ``H``); the kernel reads kv-head
  ``h // (H / Hkv)`` for query head h, where the reference repeats K and V to
  ``H`` heads first.  It launches the kernel for CUDA tensors, for any T and
  W and the head widths of :data:`DIMS_TAKEN` (split fp32 on the tensor
  cores; :func:`contract` mirrors the launcher's checks, and the wrapper
  raises ``ValueError`` before any launch on a shape outside them), and
  runs the plain version for CPU tensors; any other device raises.
  ``launches`` counts kernel launches (never plain calls).

Forward only: the JAX ``custom_vjp`` backward (``ops.py:27-46``) comes with
Mixtral training.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0

# the launcher's contract (csrc/window_attention.cu): the (d, dv) pairs it
# is built for; (96, 64) and (24, 16) are MLA's heads at full and smoke width
DIMS_TAKEN = ((64, 64), (64, 128), (128, 64), (128, 128), (16, 16), (32, 32), (96, 64),
              (24, 16))


def contract(*, d: int, dv: int, H: int, Hkv: int, window: int) -> Optional[str]:
    """``None`` if the kernel takes these widths, else what it refuses: the
    launcher's checks, mirrored so that a shape outside them raises here
    rather than as a CUDA error code."""
    if (d, dv) not in DIMS_TAKEN:
        return f"(d, dv) = ({d}, {dv}) not in {DIMS_TAKEN}"
    if Hkv <= 0 or H % Hkv:
        return f"{H} query heads over {Hkv} kv-heads"
    if window < 1:
        return f"window {window} < 1"
    return None


def window_attention_plain(
    q: torch.Tensor,  # (BH, T, d)
    k: torch.Tensor,  # (BH, T, d)
    v: torch.Tensor,  # (BH, T, dv)
    window: int,
) -> torch.Tensor:
    T, d = q.shape[-2], q.shape[-1]
    scores = torch.einsum("bid,bjd->bij", q, k) / math.sqrt(d)
    idx = torch.arange(T, device=q.device)
    delta = idx[:, None] - idx[None, :]
    band = (delta >= 0) & (delta < window)
    scores = torch.where(band[None], scores, float("-inf"))
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


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("window_attention: q, k, v must be (B, heads, T, dim)")
    B, H, T, d = q.shape
    Hkv, dv = k.shape[1], v.shape[-1]
    if tuple(k.shape) != (B, Hkv, T, d) or tuple(v.shape) != (B, Hkv, T, dv):
        raise ValueError(f"window_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not fit (B, H, T, d) / (B, Hkv, T, d | dv)")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"window_attention: {H} query heads over {Hkv} kv-heads")
    if window < 1:
        raise ValueError(f"window_attention: window must be >= 1, got {window}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"window_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"window_attention: {name} on {t.device}, q on {q.device}")
    return B, H, Hkv, T, d, dv


def sliding_window_attention(
    q: torch.Tensor,  # (B, H, T, d)
    k: torch.Tensor,  # (B, Hkv, T, d)
    v: torch.Tensor,  # (B, Hkv, T, dv)
    window: int,
) -> torch.Tensor:
    """Returns (B, H, T, dv) in q's dtype."""
    global launches
    B, H, Hkv, T, d, dv = _check(q, k, v, window)
    if q.device.type == "cpu":
        return sliding_window_attention_plain(q, k, v, window)
    if q.device.type != "cuda":
        raise RuntimeError(f"window_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("window_attention: the kernel is forward only; its backward "
                                  "comes with Mixtral training (ROADMAP Queue 2)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention: the kernel takes float32 or bfloat16, got {q.dtype}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("window_attention: the kernel takes contiguous tensors only")
    refused = contract(d=d, dv=dv, H=H, Hkv=Hkv, window=window)
    if refused:
        raise ValueError(f"window_attention: outside the kernel's contract: {refused}")
    # the launcher checks alignment and the grid too, and returns
    # cudaErrorInvalidValue for what it does not take
    lib = _build.load_library()
    o = torch.empty((B, H, T, dv), dtype=q.dtype, device=q.device)
    err = lib.window_attention_launch(
        *map(_build.ptr, (q, k, v, o)), B * H, H, Hkv, T, d, dv, int(window),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "window_attention")
    launches += 1
    return o
