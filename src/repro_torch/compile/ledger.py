"""Per-stage resource ledger for the dataplane compiler (port of
``repro.compile.ledger``, the whole file).

Every compiler pass records what it consumed of the :class:`DataplaneSpec`
budget as :class:`StageEntry` rows; the assembled :class:`ResourceLedger`
ships inside every :class:`~repro_torch.compile.program.DataplaneProgram`.
A stage over its budget raises :class:`BudgetError`, naming the stage,
unless the caller waived that stage; waivers are recorded, never dropped.
The ledger serializes with ``as_dict`` / ``from_dict`` in the JAX
package's layout, so a saved program's audit trail reads in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hardware_model import ResourceReport


class BudgetError(ValueError):
    """A compiler stage exceeded the DataplaneSpec budget (and was not
    waived).  Carries the full ledger so callers can render the audit."""

    def __init__(self, message: str, ledger: Optional["ResourceLedger"] = None):
        super().__init__(message)
        self.ledger = ledger


@dataclasses.dataclass(frozen=True)
class StageEntry:
    """One budget line: ``stage`` consumed ``used`` of ``budget`` units of
    ``resource``.  ``waived`` marks an over-budget line the caller accepted."""

    stage: str  # compiler pass, e.g. "state-quantization"
    resource: str  # budget axis, e.g. "per-flow-sram-bits"
    used: float
    budget: float
    detail: str = ""  # human context: the equation, the shapes involved
    waived: bool = False

    @property
    def ok(self) -> bool:
        return self.used <= self.budget

    @property
    def fraction(self) -> float:
        return self.used / self.budget if self.budget else float("inf")

    def as_dict(self) -> Dict:
        return {
            "stage": self.stage,
            "resource": self.resource,
            "used": self.used,
            "budget": self.budget,
            "fraction": self.fraction,
            "ok": self.ok,
            "waived": self.waived,
            "detail": self.detail,
        }


@dataclasses.dataclass
class ResourceLedger:
    """The compile-time audit: per-stage entries + the aggregate Table 2 row."""

    entries: List[StageEntry] = dataclasses.field(default_factory=list)
    report: Optional[ResourceReport] = None

    def add(self, stage: str, resource: str, used: float, budget: float,
            detail: str = "") -> StageEntry:
        e = StageEntry(stage=stage, resource=resource, used=float(used),
                       budget=float(budget), detail=detail)
        self.entries.append(e)
        return e

    def extend(self, entries: List[StageEntry]) -> None:
        self.entries.extend(entries)

    def stages(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for e in self.entries:
            if e.stage not in seen:
                seen.append(e.stage)
        return tuple(seen)

    def violations(self) -> List[StageEntry]:
        return [e for e in self.entries if not e.ok and not e.waived]

    def waived(self) -> List[StageEntry]:
        return [e for e in self.entries if e.waived]

    def fits(self) -> bool:
        """True when no unwaived entry exceeds its budget."""
        return not self.violations()

    def apply_waivers(self, waivers: Tuple[str, ...]) -> "ResourceLedger":
        """Mark over-budget entries of the named stages as waived."""
        unknown = set(waivers) - set(e.stage for e in self.entries)
        if unknown:
            raise ValueError(
                f"waiver(s) {sorted(unknown)} name no compiler stage; "
                f"stages are {list(self.stages())}"
            )
        self.entries = [
            dataclasses.replace(e, waived=True)
            if (e.stage in waivers and not e.ok)
            else e
            for e in self.entries
        ]
        return self

    def raise_if_over(self) -> None:
        bad = self.violations()
        if not bad:
            return
        lines = "; ".join(
            f"stage '{e.stage}' exceeds {e.resource}: "
            f"{e.used:g} > {e.budget:g} ({e.detail})"
            for e in bad
        )
        raise BudgetError(
            f"DataplaneSpec budget violated — {lines}. "
            f"Pass waivers=({', '.join(repr(e.stage) for e in bad)},) to "
            f"record-and-accept instead.",
            ledger=self,
        )

    def diff(self, other: "ResourceLedger") -> Dict[str, Dict[str, float]]:
        """Per-``stage/resource`` budget-usage delta from ``self`` (the
        baseline, e.g. the installed program's ledger) to ``other`` (e.g. a
        freshly compiled :class:`~repro_torch.compile.program.ProgramDelta`'s
        ledger).  Lines present on only one side report the other side's
        usage as 0.0, so a delta that adds or drops a stage is visible in
        the audit rather than silently ignored."""
        def last_used(ledger: "ResourceLedger") -> Dict[str, float]:
            out: Dict[str, float] = {}
            for e in ledger.entries:
                out[f"{e.stage}/{e.resource}"] = e.used
            return out

        a, b = last_used(self), last_used(other)
        return {
            key: {
                "before": a.get(key, 0.0),
                "after": b.get(key, 0.0),
                "delta": b.get(key, 0.0) - a.get(key, 0.0),
            }
            for key in sorted(set(a) | set(b))
        }

    # ------------------------------------------------------------------
    # serialization (the machine-readable audit trail)
    # ------------------------------------------------------------------
    def as_dict(self) -> Dict:
        return {
            "entries": [e.as_dict() for e in self.entries],
            "report": self.report.as_dict() if self.report else None,
            "fits": self.fits(),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ResourceLedger":
        entries = [
            StageEntry(
                stage=e["stage"], resource=e["resource"], used=e["used"],
                budget=e["budget"], detail=e.get("detail", ""),
                waived=e.get("waived", False),
            )
            for e in d.get("entries", [])
        ]
        rep = d.get("report")
        report = ResourceReport(**rep) if rep else None
        return cls(entries=entries, report=report)

    def as_table(self) -> str:
        """Fixed-width text rendering for launchers and the gate."""
        rows = [f"{'stage':22} {'resource':24} {'used':>12} {'budget':>12} "
                f"{'frac':>7}  status"]
        for e in self.entries:
            status = "ok" if e.ok else ("WAIVED" if e.waived else "OVER")
            rows.append(
                f"{e.stage:22} {e.resource:24} {e.used:12g} {e.budget:12g} "
                f"{e.fraction:7.4f}  {status}"
            )
        return "\n".join(rows)
