"""The compiler's static-verification pass (port of ``repro.analysis.verify``).

:func:`verify_program` is the library entry point: given an assembled
:class:`~repro_torch.compile.program.DataplaneProgram` it runs every
applicable static analysis and returns the findings as
``static-verification`` :class:`~repro_torch.compile.ledger.StageEntry`
rows — the audit currency of every other compiler pass, so verification
results ship inside the program and survive save/load.

What runs where:

* **every backend** — TCAM lint over the packed rule table (shadowing,
  ambiguous hard/soft overlaps, reachability against the marker-signature
  layout); graph lint of the deployed streaming-score path,
  :func:`repro_torch.train.classifier.streaming_scores` traced on fake CPU
  tensors (the plain version of ``csrc/flow_score.cu``), for host syncs
  (the rows keep the JAX package's name, ``hot-path-host-callbacks``) and
  dtype-promotion hazards (``hot-path-weak-types``).
* **int-emulation** — also: the float-op lint over the lowered integer
  score graph, and the interval overflow proof
  (:func:`repro_torch.analysis.intervals.prove_no_overflow`) at the
  program's Eq. 39 horizon, cross-checked against the hand-derived
  ``int-lowering`` ledger widths.

Severity model: warnings become always-ok rows (recorded, never fatal);
errors become over-budget rows (``budget=0``).  With ``strict`` an error
also raises :class:`~repro_torch.analysis.intervals.AnalysisError`;
``strict=False`` records everything and lets the caller decide.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.analysis import tcam_lint as T
from repro_torch.analysis.graph_lint import (
    DATA_DEPENDENT,
    float_ops_in_graph,
    host_syncs_in_graph,
    promotion_hazards,
    trace_failure,
    trace_graph,
)
from repro_torch.analysis.intervals import AnalysisError, prove_no_overflow
from repro_torch.compile.ledger import StageEntry
from repro_torch.core import symbolic

STAGE = "static-verification"


def _entry(resource: str, used: float, budget: float, detail: str) -> StageEntry:
    return StageEntry(stage=STAGE, resource=resource, used=float(used),
                      budget=float(budget), detail=detail)


def _clip(msgs: List[str], n: int = 3) -> str:
    shown = "; ".join(str(m) for m in msgs[:n])
    more = len(msgs) - n
    return shown + (f"; (+{more} more)" if more > 0 else "")


def _score_path_graph(ccfg, params, rules, batch: int) -> torch.fx.GraphModule:
    """Trace the deployed float streaming-score path on fake CPU tensors
    (nothing executes): the heads, the fusion weights and the rules, with
    ``(pooled, sig, sticky)`` of ``batch`` lanes."""
    from repro_torch.train.classifier import streaming_scores

    heads = {k: {n: t.detach().cpu() for n, t in params[k].items()}
             for k in ("cls", "anom", "fusion")}
    flat_rules = [t.detach().cpu() for t in rules.tensors()]
    d, w = ccfg.arch.d_model, ccfg.sig_words

    def score(heads, rule_tensors, pooled, sig, sticky):
        return streaming_scores(ccfg, heads, symbolic.RuleSet(*rule_tensors), pooled, sig, sticky)

    return trace_graph(score, heads, flat_rules, torch.zeros((batch, d)),
                       torch.zeros((batch, w), dtype=torch.int32),
                       torch.zeros((batch,), dtype=torch.bool))


def verify_program(program, *, int_cfg=None, batch: int = 4, strict: bool = True
                   ) -> List[StageEntry]:
    """Run the static battery over a compiled program; return ledger rows.

    With ``strict`` any error-severity finding raises :class:`AnalysisError`
    naming the analysis, with the rows as its ``report``."""
    entries: List[StageEntry] = []
    fatal: List[str] = []

    # -- TCAM rule-table lint (all backends) ---------------------------
    achievable = max(program.ccfg.arch.vocab_size - program.ccfg.marker_base, 0)
    findings = T.lint_ruleset(program.rules, achievable_bits=achievable)
    errs = T.errors(findings)
    warns = [f for f in findings if f.severity == T.WARNING]
    entries.append(_entry(
        "tcam-lint-errors", len(errs), 0,
        _clip([f.message for f in errs]) if errs
        else f"{program.rules.n_rules} rules, no shadowing/reachability errors",
    ))
    entries.append(_entry("tcam-lint-warnings", len(warns), len(warns),
                          _clip([f.message for f in warns]) if warns else "none"))
    if errs:
        fatal.append(f"tcam_lint: {_clip([f.message for f in errs])}")

    # -- hot-path graph lint (all backends) ----------------------------
    # (the port's compile_program always has params: the JAX package's
    # params=None budget-audit mode has no counterpart)
    try:
        gm = _score_path_graph(program.ccfg, program.params, program.rules, batch)
        syncs, weak = host_syncs_in_graph(gm), promotion_hazards(gm)
    except DATA_DEPENDENT as e:
        syncs, weak = [trace_failure(e)], []
    entries.append(_entry(
        "hot-path-host-callbacks", len(syncs), 0,
        _clip([str(f) for f in syncs]) if syncs else "score path has no host sync",
    ))
    if syncs:
        fatal.append(f"host syncs in score path: {_clip([str(f) for f in syncs])}")
    entries.append(_entry("hot-path-weak-types", len(weak), len(weak),
                          _clip([str(f) for f in weak]) if weak else "none"))

    # -- integer path: float lint + interval overflow proof ------------
    if program.backend == "int-emulation":
        from repro_torch.compile.int_lowering import (
            ALU_BITS,
            IntLoweringConfig,
            lower_scores,
            score_graph,
        )

        cfg = int_cfg if int_cfg is not None else IntLoweringConfig()
        plan, tables, _ = lower_scores(program.ccfg, program.params, program.rules,
                                       cfg=cfg, horizon=program.horizon)
        d = program.ccfg.arch.d_model
        float_ops = float_ops_in_graph(score_graph(plan, tables, program.rules, batch, d))
        entries.append(_entry(
            "int-path-float-ops", len(float_ops), 0,
            _clip(float_ops) if float_ops else "lowered score graph is integer-only",
        ))
        if float_ops:
            fatal.append(f"float ops in int-lowered path: {_clip(float_ops)}")

        hand = [e for e in program.ledger.entries
                if e.stage == "int-lowering" and e.resource.endswith("-bits")
                and e.resource != "feature-frac-bits"]
        hand_max = max((int(e.used) for e in hand), default=0)
        try:
            report = prove_no_overflow(plan, tables, program.rules, horizon=program.horizon,
                                       batch=batch, d_model=d,
                                       ledger_entries=program.ledger.entries)
            entries.append(_entry(
                "int32-overflow-proof", report.max_signed_bits, ALU_BITS,
                f"interval proof over {len(report.bounds)} nodes at horizon "
                f"{program.horizon}: max {report.max_signed_bits}-bit signed"
                f"; hand-derived ledger max {hand_max}-bit",
            ))
        except AnalysisError as e:
            need = e.report.max_signed_bits if e.report is not None else ALU_BITS + 1
            entries.append(_entry("int32-overflow-proof", need, ALU_BITS, str(e)))
            fatal.append(str(e))

    if strict and fatal:
        raise AnalysisError("static verification failed: " + " | ".join(fatal), report=entries)
    return entries


def verify_ruleset(rules, ccfg=None) -> List[StageEntry]:
    """Standalone TCAM lint -> ledger rows (delta audits, the gate)."""
    achievable: Optional[int] = None
    if ccfg is not None:
        achievable = max(ccfg.arch.vocab_size - ccfg.marker_base, 0)
    findings = T.lint_ruleset(rules, achievable_bits=achievable)
    errs = T.errors(findings)
    warns = [f for f in findings if f.severity == T.WARNING]
    return [
        _entry("tcam-lint-errors", len(errs), 0,
               _clip([f.message for f in errs]) if errs else "clean"),
        _entry("tcam-lint-warnings", len(warns), len(warns),
               _clip([f.message for f in warns]) if warns else "none"),
    ]
