"""Quantized Chimera decode state (paper §4.12, Table 4; port of
``repro.core.state_quant``, the whole file).

The paper's deployment stores the per-flow accumulators in fixed point with
**asymmetric precision — more bits for the S accumulator than for the
normalization mass Z**.  This module provides that storage format for the
serving state cache: S in int16, Z in int8 (configurable), per-(batch,
head) absmax scales, with the ring buffers kept bfloat16 (they are
exact-readout operands).

Against fp32 state a flow's S takes half the bytes and its Z a quarter.
:func:`quant_decode_step` dequantizes, runs
:func:`repro_torch.core.chimera_attention.chimera_decode_step` (the
``decode_step`` kernel on a CUDA tensor, its plain version on a CPU tensor)
and requantizes.  The dequantize and requantize are plain tensor code, as
the JAX package's are jnp outside its Pallas kernel.  ``torch.round``
rounds half to even, as ``jnp.round`` does, and the float-to-int
conversion clips through int64 (:func:`repro_torch.core.quantization
.to_int`), so the ints and scales are bit-identical to the JAX package's
on the same float32 state.

The JAX package's step returns a new state; the port's updates its state
in place, so :func:`quant_decode_step` works on the dequantized copy and
returns ``(out, new_qs)`` as the JAX function does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.chimera_attention import ChimeraState, chimera_decode_step
from repro_torch.core.quantization import to_int


@dataclasses.dataclass(frozen=True)
class StateQuantConfig:
    s_bits: int = 16  # accumulator S (higher precision — §4.12)
    z_bits: int = 8  # normalization mass Z
    buf_dtype: str = "bfloat16"  # ring buffers (exact local readout)


@dataclasses.dataclass
class QuantChimeraState:
    """Fixed-point at-rest form of :class:`ChimeraState`."""

    S_q: torch.Tensor  # int16 (B, H, m, d_v)
    S_scale: torch.Tensor  # float32 (B, H, 1, 1)
    Z_q: torch.Tensor  # int8 (B, H, m)
    Z_scale: torch.Tensor  # float32 (B, H, 1)
    k_buf: torch.Tensor
    v_buf: torch.Tensor
    count: torch.Tensor

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        """The JAX package's flatten order."""
        return (self.S_q, self.S_scale, self.Z_q, self.Z_scale, self.k_buf, self.v_buf,
                self.count)


_INT_DTYPES = {8: torch.int8, 16: torch.int16, 32: torch.int32}
_BUF_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _int_dtype(bits: int) -> torch.dtype:
    try:
        return _INT_DTYPES[bits]
    except KeyError:
        raise ValueError(f"unsupported state width {bits}; expected 8, 16 or 32") from None


def _quant(x: torch.Tensor, bits: int, dims: Tuple[int, ...]):
    max_int = 2 ** (bits - 1) - 1
    absmax = torch.amax(torch.abs(x), dim=dims, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / max_int
    q = to_int(torch.round(x / scale), -max_int - 1, max_int, _int_dtype(bits))
    return q, scale.to(torch.float32)


def quantize_state(state: ChimeraState, cfg: StateQuantConfig = StateQuantConfig()
                   ) -> QuantChimeraState:
    S_q, S_scale = _quant(state.S.float(), cfg.s_bits, (-2, -1))
    Z_q, Z_scale = _quant(state.Z.float(), cfg.z_bits, (-1,))
    dt = _BUF_DTYPES[cfg.buf_dtype]
    return QuantChimeraState(
        S_q=S_q, S_scale=S_scale, Z_q=Z_q, Z_scale=Z_scale,
        k_buf=state.k_buf.to(dt), v_buf=state.v_buf.to(dt), count=state.count,
    )


def dequantize_state(qs: QuantChimeraState, dtype=torch.float32) -> ChimeraState:
    """A new :class:`ChimeraState` (fresh tensors: the step may update it in place)."""
    return ChimeraState(
        S=(qs.S_q.float() * qs.S_scale).to(dtype),
        Z=(qs.Z_q.float() * qs.Z_scale).to(dtype),
        k_buf=qs.k_buf.to(dtype, copy=True),
        v_buf=qs.v_buf.to(dtype, copy=True),
        count=qs.count.clone(),
    )


def quant_decode_step(cfg_attn, params, q_t, k_t, v_t, qs: QuantChimeraState,
                      qcfg: StateQuantConfig = StateQuantConfig()):
    """Decode with fixed-point at-rest state: dequantize, one exact step
    (the ``decode_step`` kernel on the card), requantize.  Returns
    ``(out, new_qs)``; ``qs`` is left as it was."""
    state = dequantize_state(qs)
    out = chimera_decode_step(cfg_attn, params, q_t, k_t, v_t, state)
    return out, quantize_state(state, qcfg)


def state_bytes(state) -> int:
    """Bytes of every tensor of a :class:`ChimeraState` or
    :class:`QuantChimeraState`."""
    return sum(t.numel() * t.element_size() for t in state.leaves())
