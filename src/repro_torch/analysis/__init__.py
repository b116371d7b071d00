"""Static dataplane-program verification (port of ``repro.analysis``).

What can be proven about a compiled :class:`~repro_torch.compile.program
.DataplaneProgram` before a packet flows.  Every analysis runs over traced
aten graphs (fake tensors: nothing executes), compiled rule tables or the
engines' capture keys, and lands its findings as ``static-verification``
rows of the program's :class:`~repro_torch.compile.ledger.ResourceLedger`.

* :mod:`repro_torch.analysis.graph_lint` — pluggable visitor over traced
  graphs (float ops in int-lowered paths, host syncs in the hot path,
  dtype-promotion hazards, donation safety); the counterpart of
  ``jaxpr_lint``.
* :mod:`repro_torch.analysis.intervals` — integer interval abstract
  interpretation over the lowered score graph: proves no int32 overflow at
  the declared Eq. 39 horizon and cross-checks the ledger's hand-derived
  widths.
* :mod:`repro_torch.analysis.tcam_lint` — ternary rule-table analysis:
  shadowed and redundant rules, ambiguous overlaps, hard-veto reachability.
* :mod:`repro_torch.analysis.retrace_sentry` — capture-count auditor over
  the serving engines' entry points (CUDA graphs of the fused flow step).

``python -m repro_torch.analysis.gate`` runs the battery and writes a JSON
verdict; :func:`repro_torch.analysis.verify.verify_program` is what the
compiler's pass 6 calls.
"""

from repro_torch.analysis.graph_lint import (  # noqa: F401
    Finding,
    GraphLinter,
    default_linter,
    donation_safety,
    float_ops_in_graph,
    host_syncs_in_graph,
    lint_graph,
    promotion_hazards,
    trace_graph,
    walk_graph,
)
from repro_torch.analysis.intervals import (  # noqa: F401
    AnalysisError,
    Interval,
    IntervalReport,
    SumBound,
    analyze_intervals,
    prove_no_overflow,
    score_input_ranges,
)
from repro_torch.analysis.retrace_sentry import RetraceError, RetraceSentry  # noqa: F401
from repro_torch.analysis.tcam_lint import TcamFinding, lint_ruleset  # noqa: F401
from repro_torch.analysis.verify import STAGE, verify_program  # noqa: F401
