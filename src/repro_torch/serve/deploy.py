"""One front door onto the serving runtimes (port of ``repro.serve.deploy``:
``DeploySpec`` :88, ``Engine`` :128, ``_site_fcfg`` :154,
``_reset_deploy_stages`` :164, ``build_flow_engine`` :170,
``build_serve_engine`` :238, ``deploy_program`` :254)::

    from repro_torch.serve.deploy import DeploySpec

    engine = program.deploy(DeploySpec())                      # FlowEngine on the card
    engine = program.deploy(DeploySpec(device="cpu"))          # ... on the CPU
    lm = program.deploy(DeploySpec(engine="lm", batch_slots=8))

The ``"sharded"`` and ``"elastic"`` kinds wait for the sharding item of
ROADMAP Queue 1 and raise.  The JAX package's positional ``deploy(fcfg,
mesh=..., num_shards=...)`` form is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, runtime_checkable

from repro_torch.serve.flow_engine import FlowEngineConfig

ENGINE_KINDS = ("flow", "sharded", "elastic", "lm")

#: deploy-scoped ledger stages refreshed (never duplicated) on re-deploys,
#: so the program's audit trail always describes the active deployment
DEPLOY_STAGES = ("flow-table-sharding", "int-lowering", "admission-control")

SHARDING_NOT_PORTED = (
    "engine={kind!r}: the sharded and elastic engines are not ported yet "
    "(ROADMAP Queue 1, the item 'Sharding on one H100'); deploy engine='flow'"
)


@dataclasses.dataclass(frozen=True)
class DeploySpec:
    """Declarative deployment request for :meth:`repro_torch.compile
    .DataplaneProgram.deploy`.

    ``flow`` carries the flow-table knobs (capacity, lanes, fused, t_cp).
    ``backend`` overrides both ``flow.backend`` and the program's backend.
    ``batch_slots`` / ``max_len`` / ``temperature`` / ``seed`` apply to the
    ``"lm"`` slot engine only.  ``device`` is where the engine runs:
    ``None`` means ``"cuda"``, and without a GPU the deploy raises.
    """

    engine: str = "flow"  # "flow" | "lm" ("sharded" | "elastic" are not ported)
    flow: FlowEngineConfig = FlowEngineConfig()
    num_shards: Optional[int] = None
    backend: Optional[str] = None
    # LM slot-engine knobs (engine="lm")
    batch_slots: int = 8
    max_len: int = 4096
    temperature: float = 0.0
    seed: int = 0
    device: Any = None

    def __post_init__(self):
        if self.engine not in ENGINE_KINDS:
            raise ValueError(
                f"unknown engine kind {self.engine!r}; expected one of {ENGINE_KINDS}"
            )
        if self.engine in ("flow", "lm") and self.num_shards is not None:
            raise ValueError(
                f"engine={self.engine!r} is single-placement; num_shards "
                f"requires engine='sharded' or engine='elastic'"
            )


@runtime_checkable
class Engine(Protocol):
    """The structural contract of every deployed serving runtime.
    ``ingest`` / ``flow_scores`` / ``swap_tables`` may raise
    ``NotImplementedError`` where the modality has no flow table (the LM
    slot engine).  The JAX package's ``jit_entry_points`` (for its retrace
    sentry) has no counterpart yet: the port's is the fused engine's
    captured graphs, which the analysis port will audit."""

    stats: Any

    def ingest(self, flow_ids, tokens) -> Dict[str, Any]: ...

    def flow_scores(self, fid: int) -> Dict[str, float]: ...

    def swap_tables(self, ruleset=None, weights=None, weight_spec=None, delta=None): ...


def _site_fcfg(program, fcfg: FlowEngineConfig, backend: Optional[str]) -> FlowEngineConfig:
    """Resolve the deployment-site flow config against the program: backend
    precedence is spec override > fcfg.backend > the program's; the Eq. 39
    horizon always comes from the program."""
    eff = backend if backend is not None else fcfg.backend
    eff = eff if eff is not None else program.backend
    return dataclasses.replace(fcfg, backend=eff, horizon=program.horizon)


def _reset_deploy_stages(program) -> None:
    program.ledger.entries = [e for e in program.ledger.entries if e.stage not in DEPLOY_STAGES]


def build_flow_engine(program, fcfg: FlowEngineConfig = FlowEngineConfig(), *,
                      backend: Optional[str] = None, device=None):
    """Deploy ``program`` on a :class:`~repro_torch.serve.flow_engine
    .FlowEngine` on ``device``.  Drops stale deploy-scoped ledger rows and
    records this deploy's own int lowering, so the ledger describes the
    active deployment."""
    from repro_torch.serve.flow_engine import FlowEngine, _engine_kwargs_from_program

    kw = _engine_kwargs_from_program(program)
    eng = FlowEngine(kw["ccfg"], kw["params"], kw["rules"], _site_fcfg(program, fcfg, backend),
                     device=device)
    eng.program = program
    _reset_deploy_stages(program)
    program.ledger.entries.extend(eng._int_entries)
    return eng


def build_serve_engine(program, *, batch_slots: int = 8, max_len: int = 4096,
                       temperature: float = 0.0, seed: int = 0, device=None):
    """Deploy ``program``'s backbone as the LM slot engine
    (:class:`~repro_torch.serve.engine.ServeEngine`) on ``device``."""
    from repro_torch import resolve_device
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.serve.engine import ServeEngine

    device = resolve_device(device, "build_serve_engine")
    return ServeEngine(
        program.ccfg.arch, tree_map(lambda t: t.to(device), program.params["backbone"]),
        batch_slots=batch_slots, max_len=max_len, temperature=temperature, seed=seed,
        device=device,
    )


def deploy_program(program, spec: DeploySpec = DeploySpec()):
    """Dispatch a :class:`DeploySpec` onto the matching ``build_*`` function — the
    implementation behind :meth:`repro_torch.compile.DataplaneProgram.deploy`."""
    if not isinstance(spec, DeploySpec):
        raise TypeError(f"deploy_program expects a DeploySpec, got {type(spec).__name__}")
    if spec.engine == "flow":
        return build_flow_engine(program, spec.flow, backend=spec.backend, device=spec.device)
    if spec.engine in ("sharded", "elastic"):
        raise NotImplementedError(SHARDING_NOT_PORTED.format(kind=spec.engine))
    return build_serve_engine(
        program, batch_slots=spec.batch_slots, max_len=spec.max_len,
        temperature=spec.temperature, seed=spec.seed, device=spec.device,
    )
