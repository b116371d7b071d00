"""Fixed-point quantization with overflow accounting (paper §3.3.1, Thm A.3).

Port of ``repro.core.quantization`` lines 25-113: ``FixedPointSpec``,
``quantize``, ``dequantize``, ``quantization_error_bound``,
``overflow_safe_horizon``, ``check_overflow``, and ``QuantizedTensor`` with
``quantize_per_channel`` (the codebook feature map's fixed-point tables).

The dataplane stores the incremental accumulators S_t ∈ R^{m×d_v} and
Z_t ∈ R^m in b-bit fixed point (Eq. 7).  Theorem A.3 bounds the
accumulated quantization error after T updates by
``T·B_φ·R_v + T·η_q·m·d_v`` and gives the no-overflow condition Eq. 39:
``T·B_φ·R_v + T·η_q·m·d_v ≤ 2^{b-1} − 1`` (in quantized units).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class FixedPointSpec:
    """Signed symmetric fixed-point format with ``bits`` total bits."""

    bits: int = 16
    scale: float = 1.0  # real value represented by one LSB

    @property
    def max_int(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def min_int(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def dtype(self) -> torch.dtype:
        return {8: torch.int8, 16: torch.int16, 32: torch.int32}[self.bits]

    @property
    def eta_q(self) -> float:
        """Max per-scalar additive quantization error (round-to-nearest)."""
        return 0.5 * self.scale


def quantize(
    x: torch.Tensor, spec: FixedPointSpec, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Quantize to fixed point, rounding half to even; with a ``generator``,
    stochastic rounding (its noise is not ``jax.random``'s)."""
    scaled = x.float() / spec.scale
    if generator is not None:
        noise = torch.rand(scaled.shape, generator=generator).to(scaled.device) - 0.5
        q = torch.floor(scaled + 0.5 + noise)
    else:
        q = torch.round(scaled)
    return to_int(q, spec.min_int, spec.max_int, spec.dtype)


def to_int(q: torch.Tensor, lo: int, hi: int, dtype: torch.dtype) -> torch.Tensor:
    """Integral float32 values clipped to ``[lo, hi]``, as ``dtype``.  The
    clip goes through int64: in float32 a 32-bit bound rounds up to 2^31,
    which XLA's conversion saturates and torch's would wrap."""
    q = torch.clamp(q, lo, hi).to(torch.int64)
    return torch.clamp(q, lo, hi).to(dtype)


def dequantize(q: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    return q.float() * spec.scale


def quantization_error_bound(
    T: int, B_phi: float, R_v: float, spec: FixedPointSpec, m: int, d_v: int
) -> float:
    """Frobenius-norm bound of Thm A.3 / Eq. 38 for the accumulator S_T."""
    return T * B_phi * R_v + T * spec.eta_q * m * d_v


def overflow_safe_horizon(B_phi: float, R_v: float, spec: FixedPointSpec) -> int:
    """Largest per-flow horizon T satisfying the overflow condition (Eq. 39):
    the accumulator after T steps is at most ``T·(B_φ·R_v/scale + 0.5)``
    in quantized units."""
    per_step = B_phi * R_v / spec.scale + 0.5
    return int(math.floor(spec.max_int / per_step))


def check_overflow(T: int, B_phi: float, R_v: float, spec: FixedPointSpec) -> bool:
    """True if T updates provably cannot overflow the accumulator (Eq. 39)."""
    return T <= overflow_safe_horizon(B_phi, R_v, spec)


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """An int tensor with a (possibly per-channel) fp32 scale."""

    values: torch.Tensor  # int8/int16/int32
    scale: torch.Tensor  # fp32, broadcastable to ``values``

    def dequantize(self) -> torch.Tensor:
        return self.values.float() * self.scale


def quantize_per_channel(x: torch.Tensor, bits: int, axis: Optional[int] = -1) -> QuantizedTensor:
    """Symmetric per-channel quantization (state caches and codebook
    tables); ``axis=None`` takes one scale over the whole tensor, kept with
    ``x``'s number of dimensions, as ``jnp.max(..., keepdims=True)`` does.
    Rounds half to even, as ``jnp.round``."""
    max_int = 2 ** (bits - 1) - 1
    x = x.float()
    if axis is None:
        absmax = torch.amax(torch.abs(x)).reshape((1,) * x.ndim)
    else:
        absmax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / max_int
    dtype = {8: torch.int8, 16: torch.int16, 32: torch.int32}[bits]
    q = to_int(torch.round(x / scale), -max_int - 1, max_int, dtype)
    return QuantizedTensor(values=q, scale=scale)
