"""Fused streaming decode step: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/decode_step/kernel.py::decode_step_pallas`` with
``csrc/decode_step.cu``.  One call per decode token and layer: ring write →
exact local readout → φ-stream readout → (+ static-global partials) → merge
→ fold-on-full, with the state updated in place.

:func:`decode_step` launches the kernel for CUDA tensors and runs
:func:`decode_step_plain` for CPU tensors; any other device raises.
``launches`` counts kernel launches (never plain calls).

Types.  The state (ring, S, Z) is float32 and is updated in place: the
kernel reads and writes float32 only.  The token's inputs (q, k_t, v_t, the
features and the static-global partials) may also be bfloat16, the
activations of a model whose ``ArchConfig.dtype`` is bfloat16: the wrapper
casts them to float32 explicitly before either route, and the output is
float32, as the JAX package's promotion of bfloat16 activations against a
float32 state makes it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

launches = 0

# the launcher's contract (csrc/decode_step.cu): value widths it is built
# for, the shared memory a block may use, and the ring rows a tile of the
# tiled layout stages
DV_TAKEN = (16, 32, 64, 128)
SMEM_LIMIT = 227 * 1024
TILE_ROWS = 64
_THREADS = 256
STATE = ("k_buf", "v_buf", "S", "Z")  # updated in place, float32
STATE_TYPES = (torch.float32,)
INPUT_TYPES = (torch.float32, torch.bfloat16)  # cast to float32 before the launch


def _layout_floats(Gq: int, d: int, dv: int, m: int, L: int, tiled: bool) -> int:
    """Floats of shared memory of the kernel's ``Layout``: the whole ring, or
    ``TILE_ROWS`` rows of it at a time."""
    half = _THREADS // 2
    rgh = half // (dv // 4)
    fw = min(4 * (_THREADS // (dv // 4)), m)
    kt = TILE_ROWS if tiled and L > TILE_ROWS else L
    red_s = kt * dv + kt * (d + 4) + Gq * d + ((Gq * kt + 3) & ~3)
    end = red_s + 2 * Gq * rgh * dv + 2 * Gq * rgh
    fend = 2 * kt * (fw + dv) if tiled else kt * dv + 2 * kt * fw
    return max(end, fend)


def layout(Gq: int, d: int, dv: int, m: int, L: int) -> Tuple[str, int]:
    """``(name, bytes)`` of the layout the launcher takes: ``"whole"`` (the
    ring staged whole) where it fits, else ``"tiled"``."""
    whole = 4 * _layout_floats(Gq, d, dv, m, L, tiled=False)
    if whole <= SMEM_LIMIT:
        return "whole", whole
    return "tiled", 4 * _layout_floats(Gq, d, dv, m, L, tiled=True)


def _smem_bytes(Gq: int, d: int, dv: int, m: int, L: int) -> int:
    """The kernel's shared memory per block (its ``Layout``), in bytes."""
    return layout(Gq, d, dv, m, L)[1]


def contract(*, Gq: int, d: int, dv: int, m: int, L: int) -> Optional[str]:
    """``None`` if the kernel takes these widths, else what it refuses: the
    launcher's checks on the widths, mirrored so that a shape outside them
    raises here rather than as a CUDA error code."""
    if dv not in DV_TAKEN:
        return f"dv {dv} not in {DV_TAKEN}"
    if min(Gq, d, m, L) <= 0 or d % 4 or m % 4:
        return f"Gq {Gq}, d {d}, m {m}, L {L}: all positive, d and m multiples of 4"
    smem = _smem_bytes(Gq, d, dv, m, L)
    if smem > SMEM_LIMIT:
        return (f"{smem} B of shared memory at Gq {Gq}, d {d}, dv {dv}, m {m}, L {L} > "
                f"{SMEM_LIMIT}, with the ring tiled {TILE_ROWS} rows at a time")
    return None


def decode_step_plain(
    q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count, *,
    chunk_size: int, gamma: float = 1e-6, gnum=None, gden=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with the kernel's contract (see :func:`decode_step`)."""
    BH, Gq, d = q.shape
    L = chunk_size
    c = count.reshape(-1).to(torch.long)
    cb = c.repeat_interleave(BH // c.numel())  # (BH,) per-row fill level
    ar = torch.arange(L, device=q.device)
    slot = (ar[None, :] == cb[:, None])[..., None]  # (BH, L, 1)
    kb = torch.where(slot, k_t[:, None, :], k_buf)
    vb = torch.where(slot, v_t[:, None, :], v_buf)
    valid = (ar[None, :] <= cb[:, None]).to(q.dtype)  # (BH, L)
    s_loc = torch.exp(torch.einsum("bgd,bjd->bgj", q, kb) / math.sqrt(d))
    s_loc = s_loc * valid[:, None, :]
    num = torch.einsum("bgj,bjd->bgd", s_loc, vb)
    den = torch.sum(s_loc, dim=-1)
    num = num + torch.einsum("bgm,bmd->bgd", phi_q, S)
    den = den + torch.einsum("bgm,bm->bg", phi_q, Z)
    if gnum is not None:
        num = num + gnum
        den = den + gden
    out = num / (den[..., None] + gamma)
    full = cb + 1 >= L  # (BH,)
    S_fold = S + torch.einsum("bjm,bjd->bmd", phi_buf, vb)
    Z_fold = Z + torch.sum(phi_buf, dim=1)
    S.copy_(torch.where(full[:, None, None], S_fold, S))
    Z.copy_(torch.where(full[:, None], Z_fold, Z))
    k_buf.copy_(torch.where(full[:, None, None], torch.zeros_like(kb), kb))
    v_buf.copy_(torch.where(full[:, None, None], torch.zeros_like(vb), vb))
    new_count = torch.where(count + 1 >= L, 0, count + 1).to(torch.int32)
    return out, new_count


def _check(q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count, L, gnum, gden):
    BH, Gq, d = q.shape
    dv, m = v_t.shape[-1], phi_q.shape[-1]
    shapes = {
        "k_t": (k_t, (BH, d)), "v_t": (v_t, (BH, dv)), "phi_q": (phi_q, (BH, Gq, m)),
        "phi_buf": (phi_buf, (BH, L, m)), "k_buf": (k_buf, (BH, L, d)),
        "v_buf": (v_buf, (BH, L, dv)), "S": (S, (BH, m, dv)), "Z": (Z, (BH, m)),
    }
    if gnum is not None or gden is not None:
        if gnum is None or gden is None:
            raise ValueError("decode_step: pass both gnum and gden, or neither")
        shapes["gnum"] = (gnum, (BH, Gq, dv))
        shapes["gden"] = (gden, (BH, Gq))
    for name, (t, shape) in [("q", (q, (BH, Gq, d)))] + list(shapes.items()):
        if tuple(t.shape) != shape:
            raise ValueError(f"decode_step: {name} has shape {tuple(t.shape)}, want {shape}")
        want = STATE_TYPES if name in STATE else INPUT_TYPES
        if t.dtype not in want:
            raise TypeError(f"decode_step: {name} must be one of {want}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"decode_step: {name} on {t.device}, q on {q.device}")
    if count.dtype != torch.int32 or count.device != q.device:
        raise TypeError("decode_step: count must be int32 on q's device")
    if count.numel() == 0 or BH % count.numel():
        raise ValueError(f"decode_step: {count.numel()} fill levels for {BH} rows")
    return BH, Gq, d, dv, m


def decode_step(
    q: torch.Tensor,  # (BH, Gq, d) normalized query
    k_t: torch.Tensor,  # (BH, d) normalized key
    v_t: torch.Tensor,  # (BH, dv)
    phi_q: torch.Tensor,  # (BH, Gq, m)
    phi_buf: torch.Tensor,  # (BH, L, m) φ of the ring incl. the new token
    k_buf: torch.Tensor,  # (BH, L, d) ring, updated in place
    v_buf: torch.Tensor,  # (BH, L, dv) updated in place
    S: torch.Tensor,  # (BH, m, dv) updated in place
    Z: torch.Tensor,  # (BH, m) updated in place
    count: torch.Tensor,  # () or (BH / heads,) int32 fill levels, shared by a flow's heads
    *,
    chunk_size: int,
    gamma: float = 1e-6,
    gnum: Optional[torch.Tensor] = None,  # (BH, Gq, dv) static-global partials
    gden: Optional[torch.Tensor] = None,  # (BH, Gq)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out (BH, Gq, dv), new_count)``; S, Z and the ring change in place."""
    global launches
    L = chunk_size
    BH, Gq, d, dv, m = _check(
        q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count, L, gnum, gden
    )
    # the stated cast: bfloat16 token inputs become float32 on either route
    q, k_t, v_t, phi_q, phi_buf, gnum, gden = (
        None if t is None else t.float() for t in (q, k_t, v_t, phi_q, phi_buf, gnum, gden))
    if q.device.type == "cpu":
        return decode_step_plain(
            q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count,
            chunk_size=L, gamma=gamma, gnum=gnum, gden=gden,
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_step: no kernel for device {q.device}")
    refused = contract(Gq=Gq, d=d, dv=dv, m=m, L=L)
    if refused:
        raise ValueError(f"decode_step: outside the kernel's contract: {refused}")
    ins = [q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count]
    ins += [t for t in (gnum, gden) if t is not None]
    for t in ins:
        if not t.is_contiguous():
            raise ValueError("decode_step: the kernel takes contiguous tensors only")
    lib = _build.load_library()
    out = torch.empty((BH, Gq, dv), dtype=torch.float32, device=q.device)
    new_count = torch.empty_like(count)
    err = lib.decode_step_launch(
        *map(_build.ptr, (q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z,
                          count, new_count, gnum, gden, out)),
        BH, BH // count.numel(), Gq, d, dv, m, L, float(gamma),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_step")
    launches += 1
    return out, new_count
