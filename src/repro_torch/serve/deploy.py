"""One front door onto the serving runtimes (port of ``repro.serve.deploy``:
``TenantSpec`` :55, ``ElasticConfig`` :71, ``DeploySpec`` :88, ``Engine``
:128, ``_site_fcfg`` :154, ``_reset_deploy_stages`` :164,
``build_flow_engine`` :170, ``build_sharded_engine`` :189,
``record_sharding_entry`` :220, ``build_serve_engine`` :238,
``deploy_program`` :254)::

    from repro_torch.serve.deploy import DeploySpec, ElasticConfig

    engine = program.deploy(DeploySpec())                      # FlowEngine on the card
    engine = program.deploy(DeploySpec(device="cpu"))          # ... on the CPU
    engine = program.deploy(DeploySpec(engine="sharded",
                                       num_shards=4))          # 4 shards, one card
    service = program.deploy(DeploySpec(engine="elastic", num_shards=2,
                                        elastic=ElasticConfig(checkpoint_dir="ck")))
    lm = program.deploy(DeploySpec(engine="lm", batch_slots=8))

Sharded and elastic deploys place every shard on the one device the spec
names: the JAX package's ``mesh=`` and its positional ``deploy(fcfg,
mesh=..., num_shards=...)`` form have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.serve.flow_engine import FlowEngineConfig

ENGINE_KINDS = ("flow", "sharded", "elastic", "lm")

#: deploy-scoped ledger stages refreshed (never duplicated) on re-deploys,
#: so the program's audit trail always describes the active deployment
DEPLOY_STAGES = ("flow-table-sharding", "int-lowering", "admission-control")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Admission-control identity: a traffic class holding a bounded share
    of the aggregate flow table.  Under pressure, new flows of
    lower-priority tenants are shed first."""

    name: str
    priority: int = 0  # higher priority survives longer under pressure
    share: float = 1.0  # fraction of aggregate flow capacity this tenant may hold

    def __post_init__(self):
        if not (0.0 < self.share <= 1.0):
            raise ValueError(f"tenant {self.name!r}: share must be in (0, 1], "
                             f"got {self.share}")


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Knobs of :class:`~repro_torch.serve.elastic.ElasticFlowService`."""

    checkpoint_dir: Optional[str] = None  # flow-state checkpoints (None = in-memory)
    checkpoint_every: int = 0  # ticks between automatic checkpoints (0 = manual)
    replay_window: int = 64  # ingest batches buffered for post-recovery replay
    heartbeat_timeout_s: float = 60.0  # shard liveness horizon (HeartbeatMonitor)
    keep_topologies: bool = True  # keep an engine per shard count: reshard-back reuses it
    tenants: Tuple[TenantSpec, ...] = ()
    default_tenant: str = "default"


@dataclasses.dataclass(frozen=True)
class DeploySpec:
    """Declarative deployment request for :meth:`repro_torch.compile
    .DataplaneProgram.deploy`.

    ``flow`` carries the flow-table knobs (capacity, lanes, fused, t_cp);
    for sharded and elastic deploys ``capacity`` is per shard, and
    ``num_shards`` (``None``: 1) counts logical shards on the one device.
    ``backend`` overrides both ``flow.backend`` and the program's backend.
    ``batch_slots`` / ``max_len`` / ``temperature`` / ``seed`` apply to the
    ``"lm"`` slot engine only.  ``device`` is where the engine runs:
    ``None`` means ``"cuda"``, and without a GPU the deploy raises.
    """

    engine: str = "flow"  # "flow" | "sharded" | "elastic" | "lm"
    flow: FlowEngineConfig = FlowEngineConfig()
    num_shards: Optional[int] = None
    backend: Optional[str] = None
    elastic: ElasticConfig = ElasticConfig()
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
    slot engine).  ``capture_entry_points`` is the counterpart of the JAX
    package's ``jit_entry_points``: the named entry points the graph-capture
    sentry (:mod:`repro_torch.analysis.retrace_sentry`) counts; the LM slot
    engine's is empty (its decode tick captures no graph)."""

    stats: Any

    def ingest(self, flow_ids, tokens) -> Dict[str, Any]: ...

    def flow_scores(self, fid: int) -> Dict[str, float]: ...

    def swap_tables(self, ruleset=None, weights=None, weight_spec=None, delta=None): ...

    def capture_entry_points(self) -> Dict[str, Any]: ...


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


def build_sharded_engine(program, fcfg: FlowEngineConfig = FlowEngineConfig(), *,
                         num_shards: Optional[int] = None, backend: Optional[str] = None,
                         record: bool = True, device=None):
    """Deploy ``program`` on a :class:`~repro_torch.serve.sharded_flow_engine
    .ShardedFlowEngine` of ``num_shards`` logical shards on ``device``.

    The per-shard Eq. 11 budget check runs at construction; with ``record``
    (the default) the per-shard usage and the shards x budget aggregate are
    refreshed in the program's ledger.  The elastic service passes
    ``record=False`` when it builds a provisional reshard target and
    refreshes the ledger itself on commit.
    """
    from repro_torch.serve.flow_engine import _engine_kwargs_from_program
    from repro_torch.serve.sharded_flow_engine import ShardedFlowEngine

    kw = _engine_kwargs_from_program(program)
    eng = ShardedFlowEngine(kw["ccfg"], kw["params"], kw["rules"],
                            _site_fcfg(program, fcfg, backend),
                            num_shards=1 if num_shards is None else num_shards, device=device)
    eng.program = program
    if record:
        _reset_deploy_stages(program)
        program.ledger.entries.extend(eng._int_entries)
        record_sharding_entry(program, eng)
        program.ledger.raise_if_over()
    return eng


def record_sharding_entry(program, eng, note: str = "") -> None:
    """Refresh the ``flow-table-sharding`` StageEntry to describe ``eng``
    (the active sharded placement).  Reshards call this on commit."""
    program.ledger.entries = [
        e for e in program.ledger.entries if e.stage != "flow-table-sharding"
    ]
    program.ledger.add(
        "flow-table-sharding", "per-shard-table-bytes",
        used=eng.shard_state_bytes(), budget=eng.state_budget_bytes,
        detail=(
            f"{eng.num_shards} shard(s) x {eng.fcfg.capacity} flows/shard; "
            f"aggregate capacity {eng.aggregate_capacity} flows, "
            f"aggregate budget {eng.aggregate_state_budget_bytes} B"
            + (f"; {note}" if note else "")
        ),
    )


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
    if spec.engine == "sharded":
        return build_sharded_engine(program, spec.flow, num_shards=spec.num_shards,
                                    backend=spec.backend, device=spec.device)
    if spec.engine == "elastic":
        from repro_torch.serve.elastic import ElasticFlowService

        return ElasticFlowService(program, spec.flow, spec.elastic, num_shards=spec.num_shards,
                                  backend=spec.backend, device=spec.device)
    return build_serve_engine(
        program, batch_slots=spec.batch_slots, max_len=spec.max_len,
        temperature=spec.temperature, seed=spec.seed, device=spec.device,
    )
