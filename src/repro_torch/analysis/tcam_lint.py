"""Ternary rule-table lint (port of ``repro.analysis.tcam_lint``, the whole
file).

A :class:`~repro_torch.core.symbolic.RuleSet` is the compiled TCAM tier of
the symbolic path: M ternary ``(value, mask)`` entries over packed 32-bit
signature words.  Silicon TCAMs are priority-encoded — entry order is the
tiebreak — and rule tables rot in ways no runtime test catches (the bad
entry simply never fires).  This lint checks the table as a set system,
with the ternary algebra of :func:`repro_torch.core.symbolic.rule_covers` /
:func:`~repro_torch.core.symbolic.rules_intersect`:

* **shadowed** — an earlier (higher-priority) rule's match set contains a
  later rule's: the later rule never fires on its own.  An error when a
  hard veto is shadowed by a soft rule, a warning otherwise.
* **ambiguous-overlap** — a hard and a soft rule intersect with neither
  covering the other: whether a signature in the intersection vetoes
  depends on entry order.
* **unreachable** — a rule demands a care bit set to 1 where the signature
  extractor never sets one (``packet_signature`` sets one bit per marker
  token, so bits >= ``vocab_size - marker_base`` stay 0).  A dead hard veto
  is an error.
* **always-fires** — a hard rule with no care bits vetoes every packet.

The port's words are int32 bit patterns where the JAX package's are uint32:
every comparison reads them as unsigned 32-bit words
(:func:`repro_torch.core.symbolic.words_u32`), so a set bit 31 is a bit, not
a sign.  Pure control plane, O(M²·W).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.symbolic import RuleSet, rule_covers, rules_intersect, words_u32

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class TcamFinding:
    kind: str  # shadowed | ambiguous-overlap | unreachable | always-fires
    severity: str  # error | warning
    rule: int  # index of the offending rule
    other: Optional[int]  # the counterpart rule for pairwise findings
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.kind}: {self.message}"


def _tier(hard: bool) -> str:
    return "hard" if hard else "soft"


def lint_ruleset(rules: RuleSet, *, achievable_bits: Optional[int] = None) -> List[TcamFinding]:
    """Lint one compiled rule table.

    ``achievable_bits``: number of low signature bits the extractor can set
    (``vocab_size - marker_base``).  ``None`` skips reachability.
    """
    values, masks = words_u32(rules.values), words_u32(rules.masks)
    hard = torch.as_tensor(rules.hard).cpu().numpy().astype(bool)
    m, w = values.shape
    findings: List[TcamFinding] = []

    for i in range(m):
        if hard[i] and not masks[i].any():
            findings.append(TcamFinding(
                "always-fires", ERROR, i, None,
                f"hard rule {i} has no care bits — it vetoes every packet",
            ))
        if achievable_bits is not None:
            demand = values[i] & masks[i]  # care bits demanding 1
            reach = np.zeros(w, dtype=np.uint32)
            full, rem = divmod(max(achievable_bits, 0), 32)
            reach[:min(full, w)] = 0xFFFFFFFF
            if full < w and rem:
                reach[full] = (1 << rem) - 1
            dead = demand & ~reach
            if dead.any():
                bits = [32 * wi + b for wi in range(w) for b in range(32)
                        if (int(dead[wi]) >> b) & 1]
                findings.append(TcamFinding(
                    "unreachable", ERROR if hard[i] else WARNING, i, None,
                    f"{_tier(hard[i])} rule {i} demands signature bit(s) "
                    f"{bits} the extractor never sets (achievable bits: "
                    f"{achievable_bits}) — the rule can never fire",
                ))

    for i in range(m):
        for j in range(i + 1, m):
            if rule_covers(values[i], masks[i], values[j], masks[j]):
                findings.append(TcamFinding(
                    "shadowed", ERROR if hard[j] and not hard[i] else WARNING, j, i,
                    f"{_tier(hard[j])} rule {j} is shadowed by earlier "
                    f"{_tier(hard[i])} rule {i} (its match set is contained"
                    f" in rule {i}'s) — it never fires first",
                ))
            elif (not rule_covers(values[j], masks[j], values[i], masks[i])
                  and hard[i] != hard[j]
                  and rules_intersect(values[i], masks[i], values[j], masks[j])):
                findings.append(TcamFinding(
                    "ambiguous-overlap", WARNING, j, i,
                    f"hard/soft rules {i} and {j} partially overlap "
                    f"with neither covering the other — veto behavior "
                    f"in the intersection depends on entry order",
                ))
    return findings


def errors(findings: List[TcamFinding]) -> List[TcamFinding]:
    return [f for f in findings if f.severity == ERROR]
