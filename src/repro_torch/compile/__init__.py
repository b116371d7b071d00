"""The dataplane compiler (port of ``repro.compile``)::

    from repro_torch.compile import compile_program

    program = compile_program(ccfg, params, rules=lambda c: default_rules(c, sig, device=...))
    engine = program.deploy(DeploySpec(flow=FlowEngineConfig(capacity=2048)))
"""

from repro_torch.compile.int_lowering import (
    IntLoweringConfig,
    IntScorePlan,
    divergence_bound,
    lower_scores,
)
from repro_torch.compile.ledger import BudgetError, ResourceLedger, StageEntry
from repro_torch.compile.passes import required_sig_words
from repro_torch.compile.program import (
    DataplaneProgram,
    ProgramDelta,
    compile_delta,
    compile_program,
)

__all__ = [
    "BudgetError",
    "DataplaneProgram",
    "IntLoweringConfig",
    "IntScorePlan",
    "ProgramDelta",
    "ResourceLedger",
    "StageEntry",
    "compile_delta",
    "compile_program",
    "divergence_bound",
    "lower_scores",
    "required_sig_words",
]
