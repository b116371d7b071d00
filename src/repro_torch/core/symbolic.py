"""Symbolic execution path: ternary rules over packed signatures (paper §3.5).

Port of ``repro.core.symbolic`` lines 32-108 (the match, and the ternary set
algebra the TCAM lint reads) and 154-184 (the Eq. 19 SRAM image of the
soft-rule weights).  A hard TCAM hit is
(sig & mask) == (value & mask) on every word.

Packed signatures are **int32 bit patterns** here, where the JAX package
uses uint32: torch on the CPU implements neither ``uint32 << k`` nor a
uint32 sum.  The bits are the same; ``tensor.numpy().view(np.uint32)``
gives the JAX words back.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.quantization import FixedPointSpec, dequantize, quantize


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """M ternary rules over W-word packed signatures."""

    values: torch.Tensor  # (M, W) int32 bit patterns — target bits
    masks: torch.Tensor  # (M, W) int32 bit patterns — 1 = care bit
    weights: torch.Tensor  # (M,) float32 — soft-symbolic weights (HL-MRF W_q)
    hard: torch.Tensor  # (M,) bool — hard-veto rules (TCAM tier)

    @property
    def n_rules(self) -> int:
        return self.values.shape[0]

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """``(values, masks, weights, hard)``: the JAX package's flatten order."""
        return (self.values, self.masks, self.weights, self.hard)

    def to(self, device) -> "RuleSet":
        return RuleSet(*(t.to(device) for t in self.tensors()))


def words_to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2³²) -> the same 32 bits as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def uint32_to_int32(a) -> torch.Tensor:
    """numpy uint32 words (as the JAX package keeps them) -> int32 tensor."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., n_bits in {0,1}) -> (..., ceil(n_bits/32)) packed int32 words."""
    n = bits.shape[-1]
    pad = (-n) % 32
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))], dim=-1)
    words = bits.reshape(bits.shape[:-1] + ((n + pad) // 32, 32)).long()
    shifts = torch.arange(32, device=bits.device)
    return words_to_int32(torch.sum(words << shifts, dim=-1))


def ternary_match(sig: torch.Tensor, rules: RuleSet) -> torch.Tensor:
    """TCAM lookup: (..., W) signature vs (M, W) rules -> (..., M) bool hits."""
    masked_sig = sig[..., None, :] & rules.masks  # (..., M, W)
    masked_val = rules.values & rules.masks
    return torch.all(masked_sig == masked_val, dim=-1)


def hard_hit(hits: torch.Tensor, rules: RuleSet) -> torch.Tensor:
    """𝕀_sym: any hard rule fired.  (..., M) -> (...)."""
    return torch.any(hits & rules.hard, dim=-1)


def soft_score(hits: torch.Tensor, rules: RuleSet) -> torch.Tensor:
    """s_sym = Σ_q W_q · hit_q — the compiled-table gather at line rate."""
    return torch.sum(hits.to(torch.float32) * rules.weights, dim=-1)


# --------------------------------------------------------------------------
# Ternary set algebra — control-plane helpers for the TCAM lint
# --------------------------------------------------------------------------

def words_u32(a) -> np.ndarray:
    """Signature words (int32 bit patterns, a tensor or an array; or uint32
    words) as numpy uint32: the unsigned reading the set algebra needs, so
    that a set sign bit is bit 31, not a negative number."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a
    return (a.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


def rule_covers(value_i, mask_i, value_j, mask_j) -> bool:
    """Does rule *i*'s match set contain rule *j*'s (match(j) ⊆ match(i))?

    Exactly when every care bit of i is also a care bit of j and the two
    values agree on i's care bits.  Word-wise, control-plane only."""
    vi, mi, vj, mj = map(words_u32, (value_i, mask_i, value_j, mask_j))
    return bool(np.all(mi & ~mj == 0) and np.all((vi ^ vj) & mi == 0))


def rules_intersect(value_i, mask_i, value_j, mask_j) -> bool:
    """Can some signature hit both rules?  Exactly when the values agree on
    the shared care bits."""
    vi, mi, vj, mj = map(words_u32, (value_i, mask_i, value_j, mask_j))
    return bool(np.all((vi ^ vj) & mi & mj == 0))


def compile_weights_to_table(
    weights: torch.Tensor, spec: FixedPointSpec, budget_bits: int
) -> Tuple[torch.Tensor, FixedPointSpec]:
    """Compile learned W_q into the fixed-point SRAM table (Eq. 19 check)."""
    n = int(weights.shape[0])
    if n * spec.bits > budget_bits:
        raise ValueError(
            f"rule table needs {n * spec.bits} bits > budget {budget_bits} (Eq. 19)"
        )
    wmax = float(torch.max(torch.abs(weights.float())))
    scale = max(wmax, 1e-9) / spec.max_int
    qspec = FixedPointSpec(bits=spec.bits, scale=scale)
    return quantize(weights, qspec), qspec


def decompile_table(table: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    return dequantize(table, spec)

