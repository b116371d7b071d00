"""Sharded flow serving on one card (port of ``repro.serve.sharded_flow_engine``).

The flow-keyed Chimera state is partitioned into ``num_shards`` logical
shards, all resident on one device:

* **Routing** is deterministic and batch-independent —
  ``flow_shard(fid) % num_shards`` (a fixed splitmix64 mix), so a flow's
  packets always land on the same shard and its state never migrates.
* **Per-shard tables**: each shard owns a :class:`~repro_torch.serve
  .flow_engine.FlowTableDirectory` (LRU + idle eviction, bounded capacity)
  and ``capacity + 1`` rows of every table tensor (one scratch row per
  shard).  ``positions``, ``sig``, ``hidden_sum`` and ``vetoed`` carry a
  leading shard axis ``(S, capacity + 1, ...)``; the decode caches keep the
  model's stacked layer axis in front, ``(groups, S * (capacity + 1), ...)``,
  whose shard view is ``(groups, S, capacity + 1, ...)``.  Sticky TCAM veto
  bits live in the rows of the shard that owns the flow.
* **One launch per arrival round**: ``ingest`` (the per-round ingest of
  :class:`~repro_torch.serve.flow_engine.TableEngine`, whose single engine
  is the case of one shard) runs the flow step of
  :func:`~repro_torch.serve.flow_engine.make_flow_step` once per round
  over the flat ``S * (capacity + 1)`` rows, ``lanes`` lanes per shard
  (width ``S * lanes``): shard ``s``'s lane indices are offset by
  ``s * (capacity + 1)`` and its unused lanes point at its own scratch row.
  That is the counterpart of the JAX package's one ``shard_map``-ped
  ``(num_shards, lanes)`` call per round.  One device-to-host copy per round
  brings back every shard's outputs.  The JAX package's sharded replay is
  bit-identical to its single-device replay because each device runs the
  step at width ``lanes``; here one launch of width ``S * lanes`` hands the
  matrix products another row count, so decisions are identical and float
  scores agree within the tolerance the tests state.
* **Shared control plane**: parameters and rule tables are one copy on the
  card; :meth:`ShardedFlowEngine.swap_tables` installs on every shard in one
  measured install (the Eq. 18 ``t_cp`` accounting).
* **Per-shard budgets**: the Eq. 11 flow-table byte budget holds per shard
  at construction; aggregate capacity is ``num_shards x capacity``.

The JAX package's ``mesh=`` has no counterpart on one card.  The
counterpart of ``jit_entry_points`` is the per-round step's
``capture_entry_points`` (:class:`~repro_torch.serve.flow_engine
.TableEngine`), keyed by its launch shape ``(num_shards * lanes, pkt_len)``.
"""

from __future__ import annotations

from typing import List

from repro_torch.core import hardware_model
from repro_torch.core import symbolic
from repro_torch.serve.flow_engine import FlowEngineConfig, TableEngine
from repro_torch.train import classifier as C

FUSED_NOT_SHARDED = (
    "FlowEngineConfig(fused=True) has no sharded implementation (the JAX "
    "package's ShardedFlowEngine refuses it too). Deploy with "
    "DeploySpec(engine='flow', flow=fcfg) for fused ingest, or drop "
    "fused=True to shard the per-round path."
)


class ShardedFlowEngine(TableEngine):
    """Flow-table streaming inference over ``num_shards`` logical shards on
    one device.

    Same ``ingest`` / ``flow_scores`` / ``swap_tables`` / stats surface as
    :class:`~repro_torch.serve.flow_engine.FlowEngine`.  ``fcfg.capacity``
    and ``fcfg.state_budget_bytes`` are per shard; aggregate capacity is
    ``num_shards * fcfg.capacity``.  ``device=None`` means ``"cuda"``;
    without a GPU the constructor raises.
    """

    def __init__(
        self,
        ccfg: C.ClassifierConfig,
        params,
        rules: symbolic.RuleSet,
        fcfg: FlowEngineConfig = FlowEngineConfig(),
        *,
        num_shards: int = 1,
        device=None,
    ):
        if fcfg.fused:
            raise NotImplementedError(FUSED_NOT_SHARDED)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        # the control plane is one copy that every shard reads (as every JAX
        # device reads its replica); the budget check is per shard, before
        # anything is allocated
        super().__init__(ccfg, params, rules, fcfg, device, "ShardedFlowEngine",
                         shard_axis=(int(num_shards),))

    @classmethod
    def from_program(cls, program, fcfg: FlowEngineConfig = FlowEngineConfig(), *,
                     num_shards: int = 1, device=None) -> "ShardedFlowEngine":
        """Deploy ``program`` (``program.deploy(DeploySpec(engine="sharded",
        flow=fcfg, num_shards=...))``)."""
        from repro_torch.serve.deploy import build_sharded_engine

        return build_sharded_engine(program, fcfg, num_shards=num_shards, device=device)

    # ------------------------------------------------------------------
    # state accounting
    # ------------------------------------------------------------------
    def shard_state_bytes(self) -> int:
        """Allocated table bytes of one shard (what the per-shard Eq. 11
        budget check is held against)."""
        return hardware_model.flow_table_bytes(self._n_slots, self.per_flow_state_bytes())

    def resident_state_bytes(self) -> int:
        """Aggregate allocated table bytes across all shards."""
        return self.num_shards * self.shard_state_bytes()

    @property
    def aggregate_capacity(self) -> int:
        return self.num_shards * self.fcfg.capacity

    @property
    def aggregate_state_budget_bytes(self) -> int:
        return self.num_shards * self.state_budget_bytes

    def resident_flows_per_shard(self) -> List[int]:
        return [t.resident for t in self.tables]
