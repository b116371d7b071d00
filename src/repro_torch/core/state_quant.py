"""Bit widths of the quantized Chimera decode state (paper §4.12, Table 4).

Port of ``repro.core.state_quant.StateQuantConfig`` (:31) alone: a compiled
program carries it, and the compiler's state-quantization and ledger passes
read it.  The quantized state cache itself is not ported.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StateQuantConfig:
    s_bits: int = 16  # accumulator S (higher precision — §4.12)
    z_bits: int = 8  # normalization mass Z
    buf_dtype: str = "bfloat16"  # ring buffers (exact local readout)
