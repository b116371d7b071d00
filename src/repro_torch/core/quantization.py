"""Fixed-point quantization with overflow accounting (paper §3.3.1, Thm A.3).

Port of ``repro.core.quantization`` lines 25-89: ``FixedPointSpec``,
``quantize``, ``dequantize``, ``quantization_error_bound``,
``overflow_safe_horizon`` and ``check_overflow``.  ``QuantizedTensor`` and
``quantize_per_channel`` serve the codebook feature map, which is not
ported, and are left out with it.

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
