"""Elastic multi-shard flow serving on one card (port of ``repro.serve.elastic``:
``ReshardRecord`` :76, the snapshot functions :103-247,
``ElasticFlowService`` :262).

:class:`ElasticFlowService` wraps the sharded flow engine
(:mod:`repro_torch.serve.sharded_flow_engine`, N logical shards on one
device) with three capabilities:

* **Live resharding** — ``reshard(new_num_shards)`` quiesces ingest,
  snapshots every resident flow row on the host (and through the
  :class:`~repro_torch.checkpoint.Checkpointer` when a checkpoint directory
  is configured), re-routes each flow with :func:`~repro_torch.data.pipeline
  .flow_shard` under the new shard count, and installs the rows into the
  target topology inside one measured ``measure_install_time`` window,
  which synchronizes the card before the clock stops.  A reshard is an
  Eq. 18-budgeted install: past ``fcfg.t_cp_s`` it is rolled back (the old
  topology keeps serving, untouched).  On commit the program ledger's
  ``flow-table-sharding`` entry is refreshed and a :class:`ReshardRecord`
  is appended to ``reshard_history``.
* **Shard fault tolerance** — flow-state checkpoints (every
  ``ElasticConfig.checkpoint_every`` ticks) in the JAX package's on-disk
  layout, so a checkpoint written by either package restores in the other;
  a per-shard :class:`~repro_torch.runtime.fault_tolerance.HeartbeatMonitor`;
  and kill-a-shard recovery (:meth:`ElasticFlowService.recover`): the
  survivors' live rows move to the shrunk topology, the failed shards'
  flows come back from the last checkpoint, and the bounded
  ``ElasticConfig.replay_window`` of buffered post-checkpoint batches is
  replayed for exactly the lost key ranges, so recovered flows (sticky
  veto bits included) match a never-killed replay.
* **Admission control** — per-tenant flow budgets from the ledger's
  sharding entry (``share x aggregate capacity``, bounded by the Eq. 11
  byte budget), with new flows of the lowest-priority tenants shed first.
  Shed packets come back marked ``admitted=False``.

An install writes the target engine's table tensors in place on the
device: it zeroes them and scatters the snapshot's rows in, where the JAX
package builds the whole ``(S, capacity + 1, ...)`` table on the host and
uploads it (gigabytes per install at the paper's width).  Snapshots are
numpy trees; their decode-cache rows are :class:`~repro_torch.core
.chimera_attention.ChimeraState` nodes of arrays ``(flows, groups, ...)``,
flattened by position as the JAX package's are.

Topology cache: one engine per shard count is kept (``keep_topologies``),
so resharding back to a count seen before reuses its engine.
:meth:`ElasticFlowService.capture_entry_points` names every cached
topology's entry points ``shards<N>.<name>``, so the graph-capture sentry
sees a reshard that brings a new step key into steady-state ingest.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.compile import int_lowering as il
from repro_torch.core import hardware_model
from repro_torch.core.chimera_attention import ChimeraState
from repro_torch.core.two_timescale import atomic_swap, measure_install_time
from repro_torch.data.pipeline import flow_shard, reshard_moves
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, plan_shard_recovery
from repro_torch.serve.deploy import (
    ElasticConfig,
    TenantSpec,
    _reset_deploy_stages,
    build_sharded_engine,
    record_sharding_entry,
)
from repro_torch.serve.flow_engine import FlowEngineConfig
from repro_torch.serve.sharded_flow_engine import ShardedFlowEngine


@dataclasses.dataclass
class ReshardRecord:
    """One elastic topology change: what moved, how long the install took,
    and its Eq. 18 verdict."""

    tick: int
    old_shards: int
    new_shards: int
    reason: str  # "scale" | "recovery"
    migrated_flows: int  # resident rows carried to the new topology
    moved_flows: int  # subset whose owner shard changed (quiesced ranges)
    install_s: float  # measured wall-clock install (device-ready)
    t_cp_s: float  # the control-plane epoch the install was held to
    churn_ok: bool  # Eq. 18: install completed within the epoch
    rolled_back: bool = False
    failed_shards: Tuple[int, ...] = ()
    restored_flows: int = 0  # recovery: flows restored from checkpoint
    replayed_packets: int = 0  # recovery: bounded-window packets re-ingested
    error: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------
# flow-state snapshots (host numpy trees in the Checkpointer's layout)
# --------------------------------------------------------------------------

_ROW_KEYS = ("fids", "last_seen", "positions", "sig", "hidden_sum", "vetoed")


def _map_caches(fn, *caches):
    return {name: ChimeraState(*(fn(*xs) for xs in zip(*(c[name].leaves() for c in caches))))
            for name in caches[0]}


def snapshot_flow_state(eng: ShardedFlowEngine) -> Dict[str, Any]:
    """Host snapshot of every resident flow's table row, in sorted fid
    order: decode-cache rows, positions, packed signature (uint32 words),
    pooled-feature accumulator, sticky veto bit and LRU stamp.  Rows are
    keyed by flow ID, so they install onto any shard count
    (:func:`install_flow_state`)."""
    entries = sorted(
        (int(fid), s * eng._n_slots + int(slot), int(t.last_seen[slot]))
        for s, t in enumerate(eng.tables) for fid, slot in t.slot_of.items()
    )
    fids = np.array([e[0] for e in entries], np.int64)
    idx = torch.tensor([e[1] for e in entries], dtype=torch.long, device=eng.device)
    caches, positions, sig, hidden_sum, vetoed = eng.flat_tables()

    def rows(t):
        return t[idx].cpu().numpy()

    return {
        "fids": fids,
        "last_seen": np.array([e[2] for e in entries], np.int64),
        "positions": rows(positions),
        "sig": rows(sig).view(np.uint32),
        "hidden_sum": rows(hidden_sum),
        "vetoed": rows(vetoed),
        # (groups, N, ...) leaves -> (flows, groups, ...) rows, as the JAX package's
        "caches": _map_caches(lambda t: t[:, idx].movedim(1, 0).cpu().numpy(), eng.caches),
    }


def snapshot_template(eng: ShardedFlowEngine) -> Dict[str, Any]:
    """Structure-only snapshot (zero flows): the dtypes and row shapes a
    snapshot of ``eng`` has.  :func:`snapshot_from_tree` holds a restored
    checkpoint to it."""
    caches, positions, sig, hidden_sum, vetoed = eng.flat_tables()

    def empty(t):
        return torch.empty((0,) + tuple(t.shape[1:]), dtype=t.dtype).numpy()

    return {
        "fids": np.zeros((0,), np.int64),
        "last_seen": np.zeros((0,), np.int64),
        "positions": empty(positions),
        "sig": empty(sig).view(np.uint32),
        "hidden_sum": empty(hidden_sum),
        "vetoed": empty(vetoed),
        "caches": _map_caches(lambda t: empty(t.movedim(1, 0)), eng.caches),
    }


def snapshot_from_tree(tree: Dict[str, Any], template: Dict[str, Any]) -> Dict[str, Any]:
    """A snapshot from :meth:`Checkpointer.restore`'s nested dicts (a decode
    state's rows under the keys 0..4), held to ``template``'s structure,
    dtypes and row shapes."""

    def like(arr, want, name):
        arr = np.asarray(arr)
        if arr.dtype != want.dtype or arr.shape[1:] != want.shape[1:]:
            raise ValueError(f"flow-state checkpoint leaf {name}: {arr.shape}/{arr.dtype}, "
                             f"this engine's rows are {want.shape[1:]}/{want.dtype}")
        return arr

    snap = {k: like(tree[k], template[k], k) for k in _ROW_KEYS}
    snap["caches"] = {
        name: ChimeraState(*(like(tree["caches"][name][i], want, f"caches/{name}/{i}")
                             for i, want in enumerate(st.leaves())))
        for name, st in template["caches"].items()
    }
    return snap


def select_rows(snap: Dict[str, Any], mask: np.ndarray) -> Dict[str, Any]:
    """Row-filter a snapshot."""
    out = {k: np.asarray(snap[k])[mask] for k in _ROW_KEYS}
    out["caches"] = _map_caches(lambda a: np.asarray(a)[mask], snap["caches"])
    return out


def concat_snapshots(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Merge two disjoint snapshots (recovery: live survivors + restored
    failed-shard rows)."""

    def cat(x, y):
        return np.concatenate([np.asarray(x), np.asarray(y)], axis=0)

    out = {k: cat(a[k], b[k]) for k in _ROW_KEYS}
    out["caches"] = _map_caches(cat, a["caches"], b["caches"])
    if len(np.unique(out["fids"])) != len(out["fids"]):
        raise ValueError("concat_snapshots: overlapping flow IDs")
    return out


def install_flow_state(eng: ShardedFlowEngine, snap: Dict[str, Any], tick: int) -> None:
    """Write a snapshot's rows into ``eng``'s table state (everything else
    zeroed), re-routing each flow to ``flow_shard(fid, eng.num_shards)``.

    The write happens on the engine's device, in place: every table tensor
    is zeroed and the snapshot's rows are scattered in.  The caller's
    ``measure_install_time`` window covers it (it synchronizes the card).
    Raises if any shard would exceed its capacity: a reshard is a
    no-eviction install, and dropping rows would break replay equivalence.
    """
    S, n_slots = eng.num_shards, eng._n_slots
    fids = np.asarray(snap["fids"], np.int64)
    owners = flow_shard(fids, S) if len(fids) else np.zeros((0,), np.int64)
    counts = np.bincount(owners, minlength=S)
    if (counts > eng.fcfg.capacity).any():
        worst = int(np.argmax(counts))
        raise ValueError(
            f"reshard to {S} shard(s) would put {int(counts[worst])} flows "
            f"on shard {worst} (> per-shard capacity {eng.fcfg.capacity}, "
            f"Eq. 11); raise capacity or evict before resharding"
        )
    eng.reset()
    flat = np.empty((len(fids),), np.int64)
    for i, (fid, own) in enumerate(zip(fids.tolist(), owners.tolist())):
        slot, fresh, evicted = eng.tables[own].slot_for(fid, tick)
        assert fresh and not evicted, (fid, own, slot)
        eng.tables[own].last_seen[slot] = int(snap["last_seen"][i])
        flat[i] = own * n_slots + slot
    idx = torch.from_numpy(flat).to(eng.device)

    def put(dst, rows, lead=0):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
        if rows.dtype != dst.dtype:
            if rows.dtype == torch.uint32 and dst.dtype == torch.int32:
                rows = rows.view(torch.int32)  # signature words as the engine keeps them
            else:
                raise ValueError(f"install_flow_state: {rows.dtype} rows into a {dst.dtype} "
                                 f"table")
        dst.zero_()
        rows = rows.to(eng.device)
        if lead:
            dst[:, idx] = rows.movedim(0, 1)
        else:
            dst[idx] = rows

    caches, positions, sig, hidden_sum, vetoed = eng.flat_tables()
    for name, st in caches.items():
        for dst, rows in zip(st.leaves(), snap["caches"][name].leaves()):
            put(dst, rows, lead=1)
    for dst, key in ((positions, "positions"), (sig, "sig"), (hidden_sum, "hidden_sum"),
                     (vetoed, "vetoed")):
        put(dst, snap[key])
    eng._tick = tick


# --------------------------------------------------------------------------
# the service
# --------------------------------------------------------------------------

class ElasticFlowService:
    """Sharded flow serving with live resharding, shard fault tolerance and
    per-tenant admission control.  Satisfies the :class:`repro_torch.serve
    .deploy.Engine` protocol: control-plane code written against the sharded
    engine works unchanged against the service."""

    def __init__(
        self,
        program,
        fcfg: FlowEngineConfig = FlowEngineConfig(),
        ecfg: ElasticConfig = ElasticConfig(),
        *,
        num_shards: Optional[int] = None,
        backend: Optional[str] = None,
        device=None,
    ):
        self.program = program
        self.ecfg = ecfg
        eng = build_sharded_engine(program, fcfg, num_shards=num_shards, backend=backend,
                                   record=False, device=device)
        self.fcfg = eng.fcfg  # site config with the resolved backend and horizon
        self._engines: Dict[int, ShardedFlowEngine] = {eng.num_shards: eng}
        self.engine = eng
        self.reshard_history: List[ReshardRecord] = []
        self._resharding = False

        # fault tolerance
        self._ckpt = Checkpointer(ecfg.checkpoint_dir, keep=3) if ecfg.checkpoint_dir else None
        self._ckpt_seq = 0
        self._last_ckpt: Optional[Tuple[Dict, Dict]] = None  # (snap, meta)
        self._replay: Deque[Tuple[int, np.ndarray, np.ndarray]] = collections.deque(
            maxlen=max(1, ecfg.replay_window))
        self.monitor = HeartbeatMonitor(timeout_s=ecfg.heartbeat_timeout_s)
        self._failed: set = set()

        # admission control
        self.tenants: Dict[str, TenantSpec] = {t.name: t for t in ecfg.tenants}
        self.tenants.setdefault(ecfg.default_tenant, TenantSpec(ecfg.default_tenant))
        self._tenant_of: Dict[int, str] = {}
        self._tenant_count: Dict[str, int] = {}
        self.shed_packets: Dict[str, int] = {}
        self.shed_flows: Dict[str, int] = {}

        _reset_deploy_stages(program)
        program.ledger.entries.extend(eng._int_entries)
        record_sharding_entry(program, eng, note="elastic")
        self._record_admission_entries()
        program.ledger.raise_if_over()

    # ------------------------------------------------------------------
    # Engine-protocol passthroughs (the active topology's engine)
    # ------------------------------------------------------------------
    def __getattr__(self, name):
        # the rest of the read-only engine surface (backend, ccfg, params,
        # device, resident_state_bytes, ...) is the active topology's
        if name.startswith("_") or name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)

    @property
    def stats(self):
        return self.engine.stats

    def capture_entry_points(self) -> Dict[str, Any]:
        """Every cached topology's capture entry points, namespaced
        ``shards<N>.<name>``."""
        return {f"shards{S}.{name}": ep
                for S in sorted(self._engines)
                for name, ep in self._engines[S].capture_entry_points().items()}

    @property
    def num_shards(self) -> int:
        return self.engine.num_shards

    @property
    def rules(self):
        return self.engine.rules

    @property
    def swap_history(self):
        return self.engine.swap_history

    @property
    def aggregate_capacity(self) -> int:
        return self.engine.aggregate_capacity

    @property
    def resident_flows(self) -> int:
        return self.engine.resident_flows

    def flow_ids(self) -> List[int]:
        return self.engine.flow_ids()

    def flow_scores(self, fid: int) -> Dict[str, float]:
        return self.engine.flow_scores(fid)

    def swap_tables(self, ruleset=None, weights=None, weight_spec=None, delta=None):
        """Install new tables on the active topology (measured, Eq. 18).
        Cached standby topologies get the current tables inside the next
        reshard's measured install."""
        return self.engine.swap_tables(ruleset=ruleset, weights=weights,
                                       weight_spec=weight_spec, delta=delta)

    # ------------------------------------------------------------------
    # ingest (admission control + replay buffer + heartbeats)
    # ------------------------------------------------------------------
    def ingest(self, flow_ids, tokens, tenant=None) -> Dict[str, np.ndarray]:
        """Same contract as :meth:`ShardedFlowEngine.ingest`, plus an
        ``admitted`` mask: packets of shed (not admitted) new flows keep
        their output rows (trust 0, pred -1) but never reach the table.
        ``tenant`` is a name or a per-packet sequence of names; ``None``
        bills the default tenant."""
        if self._resharding:
            raise RuntimeError(
                "ingest during reshard quiesce — the migrating key ranges "
                "are frozen until the install commits or rolls back"
            )
        flow_ids = np.asarray(flow_ids)
        tokens = np.asarray(tokens, np.int32)
        admit = self._admit_mask(flow_ids, tenant)
        eng = self.engine
        if admit.all():
            out = eng.ingest(flow_ids, tokens)
        else:
            n = len(flow_ids)
            out = {
                "flow_ids": flow_ids,
                "trust": np.zeros((n,), np.float32),
                "vetoed": np.zeros((n,), bool),
                "pred": np.full((n,), -1, np.int32),
                "s_nn": np.zeros((n,), np.float32),
                "s_sym": np.zeros((n,), np.float32),
                "sig": np.zeros((n, eng.ccfg.sig_words), np.uint32),
            }
            if admit.any():
                sub = eng.ingest(flow_ids[admit], tokens[admit])
                for k in ("trust", "vetoed", "pred", "s_nn", "s_sym", "sig"):
                    out[k][admit] = sub[k]
            else:
                eng._tick += 1  # a shed-only batch still advances time
        out["admitted"] = admit
        if admit.any():
            self._replay.append((eng._tick, flow_ids[admit].copy(), tokens[admit].copy()))
        for s in range(eng.num_shards):
            if s not in self._failed:
                self.monitor.beat(s, eng._tick)
        if self.ecfg.checkpoint_every and eng._tick % self.ecfg.checkpoint_every == 0:
            self.checkpoint()
        return out

    # ------------------------------------------------------------------
    # live resharding (Eq. 18-budgeted, rollback-capable)
    # ------------------------------------------------------------------
    def reshard(self, num_shards: int, *, reason: str = "scale") -> ReshardRecord:
        """Scale the flow table to ``num_shards`` shards without dropping a
        packet: quiesce → snapshot → re-route → measured install → commit
        (or roll back on an Eq. 18 ``t_cp`` violation)."""
        eng = self.engine
        old_S = eng.num_shards
        t_cp = self.fcfg.t_cp_s
        if num_shards == old_S:
            rec = ReshardRecord(
                tick=eng._tick, old_shards=old_S, new_shards=num_shards,
                reason=f"{reason} (no-op)", migrated_flows=0, moved_flows=0,
                install_s=0.0, t_cp_s=t_cp, churn_ok=True,
            )
            self.reshard_history.append(rec)
            return rec
        self._resharding = True  # quiesce: no ingest during the install
        try:
            fids = np.array(sorted(self.engine.flow_ids()), np.int64)
            moved = int(reshard_moves(fids, old_S, num_shards).sum())
            snap = snapshot_flow_state(eng)
            if self._ckpt is not None:
                # reshard snapshots ride the same checkpoint stream (the
                # freshest restore point a recovery could want)
                self._persist_snapshot(snap, kind=f"reshard->{num_shards}")
            target = self._engine_for(num_shards)
            dt = measure_install_time(self._install, eng, target, snap)
            ok = hardware_model.install_time_ok(dt, t_cp) if t_cp else True
            rec = ReshardRecord(
                tick=eng._tick, old_shards=old_S, new_shards=num_shards,
                reason=reason, migrated_flows=int(len(fids)),
                moved_flows=moved, install_s=dt, t_cp_s=t_cp, churn_ok=ok,
            )
            if ok:
                self._commit(target)
            else:
                rec.rolled_back = True
                rec.error = (
                    f"reshard install {dt:.6f}s exceeded t_cp {t_cp:.6f}s "
                    f"(Eq. 18); rolled back — old topology keeps serving"
                )
                target.reset()  # discard the provisional rows
        finally:
            self._resharding = False
        self.reshard_history.append(rec)
        return rec

    def _install(self, src: ShardedFlowEngine, dst: ShardedFlowEngine, snap: Dict):
        """The measured part of a reshard or a recovery: bring ``dst`` up to
        ``src``'s tables and write the snapshot's rows into it.  Returns a
        tensor of ``dst``, which ``measure_install_time`` synchronizes on."""
        self._carry_tables(src, dst)
        install_flow_state(dst, snap, tick=src._tick)
        return dst.positions

    def _commit(self, target: ShardedFlowEngine) -> None:
        old = self.engine
        target._tick = old._tick
        target.stats = old.stats  # service-lifetime counters carry over
        self.engine = target
        record_sharding_entry(self.program, target, note="elastic")
        self._record_admission_entries()

    def _engine_for(self, num_shards: int) -> ShardedFlowEngine:
        eng = self._engines.get(num_shards)
        if eng is None:
            eng = build_sharded_engine(self.program, self.fcfg, num_shards=num_shards,
                                       record=False, device=self.engine.device)
            if self.ecfg.keep_topologies:
                self._engines[num_shards] = eng
        return eng

    @staticmethod
    def _carry_tables(src: ShardedFlowEngine, dst: ShardedFlowEngine) -> None:
        """Bring a (possibly stale) standby topology up to the active tables:
        copy the current RuleSet in place and re-lower the int-emulation
        weight column.  Runs inside the measured install window."""
        atomic_swap(dst.rules, src.rules)
        if dst._int_plan is not None:
            atomic_swap(dst._int_tables["rule_w"],
                        il.requantize_rule_weights(dst._int_plan, dst.rules.weights))

    # ------------------------------------------------------------------
    # checkpoints + kill-a-shard recovery
    # ------------------------------------------------------------------
    def checkpoint(self) -> int:
        """Snapshot every resident flow's state (host + Checkpointer when a
        directory is configured).  Returns the checkpoint step id."""
        return self._persist_snapshot(snapshot_flow_state(self.engine), kind="periodic")

    def _persist_snapshot(self, snap: Dict, kind: str) -> int:
        meta = {
            "tick": int(self.engine._tick),
            "num_shards": int(self.engine.num_shards),
            "kind": kind,
            "tenant_of": {str(k): v for k, v in self._tenant_of.items()},
        }
        self._last_ckpt = (snap, meta)
        step = self._ckpt_seq
        if self._ckpt is not None:
            self._ckpt.save(step, snap, extra={"elastic": meta}, blocking=True)
        self._ckpt_seq += 1
        return step

    def _restore(self, step: Optional[int]) -> Tuple[Dict, Dict, int]:
        tree, extra, step = self._ckpt.restore(step=step)
        return snapshot_from_tree(tree, snapshot_template(self.engine)), extra["elastic"], step

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Load flow state from the checkpoint directory into the active
        topology (a bit-exact round trip; composes with later
        ``swap_tables``: rules are live state, not checkpoint state)."""
        if self._ckpt is None:
            raise RuntimeError(
                "no checkpoint directory configured (ElasticConfig.checkpoint_dir)"
            )
        snap, meta, step = self._restore(step)
        install_flow_state(self.engine, snap, tick=int(meta["tick"]))
        self._tenant_of = {int(k): v for k, v in meta.get("tenant_of", {}).items()}
        self._rebuild_tenant_counts()
        return step

    def kill_shard(self, shard: int) -> List[int]:
        """Chaos hook: simulate losing shard ``shard`` — its directory (and
        with it every resident flow it owned) is dropped and its heartbeat
        stops.  Returns the lost flow IDs."""
        eng = self.engine
        if not 0 <= shard < eng.num_shards:
            raise ValueError(f"no shard {shard} in a {eng.num_shards}-shard topology")
        lost = sorted(eng.tables[shard].slot_of)
        eng.tables[shard].reset()
        self._failed.add(shard)
        return lost

    def dead_shards(self, now: Optional[float] = None) -> List[int]:
        """Shards whose heartbeat lapsed (HeartbeatMonitor view) merged with
        explicitly killed shards."""
        return sorted(set(self.monitor.dead_workers(now)) | self._failed)

    def recover(self, failed: Optional[Sequence[int]] = None, *,
                allow_partial: bool = False) -> ReshardRecord:
        """Kill-a-shard recovery: move the survivors' live rows to the shrunk
        topology, restore failed-shard flows from the last checkpoint, then
        replay the buffered post-checkpoint batches for exactly the lost key
        ranges (bounded by ``ElasticConfig.replay_window``).

        Raises unless the replay window reaches back to the checkpoint (data
        loss — pass ``allow_partial=True`` to accept the gap).  The install
        is measured like any reshard but commits even on an Eq. 18
        violation: a slow recovery beats serving with a dead shard, and the
        verdict is recorded for the operator.
        """
        eng = self.engine
        old_S = eng.num_shards
        failed_set = set(self._failed if failed is None else
                         (int(f) for f in np.atleast_1d(failed)))
        if not failed_set:
            raise ValueError("recover(): no failed shards")
        if self._last_ckpt is None and self._ckpt is None:
            raise RuntimeError(
                "recover(): no checkpoint to restore from — call "
                "checkpoint() (or set ElasticConfig.checkpoint_every)"
            )
        ck_snap, ck_meta = self._recovery_checkpoint()
        ck_tick = int(ck_meta["tick"])
        plan = plan_shard_recovery(old_S, sorted(failed_set), ck_tick)
        assert plan.valid, plan

        live = snapshot_flow_state(eng)  # killed directories are empty
        lost_keys = np.asarray(sorted(failed_set))
        owners = flow_shard(ck_snap["fids"], old_S) if len(ck_snap["fids"]) \
            else np.zeros((0,), np.int64)
        lost_mask = np.isin(owners, lost_keys)
        restored = select_rows(ck_snap, lost_mask)
        merged = concat_snapshots(live, restored)

        # bounded-window coverage check BEFORE committing anything
        replayable = [b for b in self._replay if b[0] > ck_tick]
        window_start = min((b[0] for b in replayable), default=ck_tick + 1)
        gap = window_start > ck_tick + 1 and eng._tick > ck_tick
        if gap and len(self._replay) == self._replay.maxlen and not allow_partial:
            raise RuntimeError(
                f"recovery replay window ({self._replay.maxlen} batches) "
                f"does not reach back to checkpoint tick {ck_tick} "
                f"(earliest buffered tick {window_start}); lost flows would "
                f"come back stale — raise ElasticConfig.replay_window, "
                f"checkpoint more often, or pass allow_partial=True"
            )

        target = self._engine_for(plan.new_num_shards)
        dt = measure_install_time(self._install, eng, target, merged)
        t_cp = self.fcfg.t_cp_s
        ok = hardware_model.install_time_ok(dt, t_cp) if t_cp else True
        rec = ReshardRecord(
            tick=eng._tick, old_shards=old_S, new_shards=plan.new_num_shards,
            reason="recovery", migrated_flows=int(len(merged["fids"])),
            moved_flows=int(reshard_moves(merged["fids"], old_S, plan.new_num_shards).sum()),
            install_s=dt, t_cp_s=t_cp, churn_ok=ok,
            failed_shards=plan.failed,
            restored_flows=int(lost_mask.sum()),
        )
        if not ok:
            rec.error = (
                f"recovery install {dt:.6f}s exceeded t_cp {t_cp:.6f}s "
                f"(Eq. 18); committed anyway — a dead shard is worse"
            )
        self._commit(target)
        self._failed.clear()
        # restore tenant billing for flows that only exist in the checkpoint
        ck_tenants = {int(k): v for k, v in ck_meta.get("tenant_of", {}).items()}
        for fid in restored["fids"].tolist():
            self._tenant_of.setdefault(fid, ck_tenants.get(fid, self.ecfg.default_tenant))
        self._rebuild_tenant_counts()

        # bounded replay: re-ingest post-checkpoint packets of lost keys only
        # (survivors' rows are already current) through the new topology,
        # in the original batch order
        replayed = 0
        for _, fids, toks in replayable:
            mask = np.isin(flow_shard(fids, old_S), lost_keys)
            if mask.any():
                target.ingest(fids[mask], toks[mask])
                replayed += int(mask.sum())
        rec.replayed_packets = replayed
        self.reshard_history.append(rec)
        return rec

    def _recovery_checkpoint(self) -> Tuple[Dict, Dict]:
        if self._last_ckpt is not None:
            return self._last_ckpt
        snap, meta, _ = self._restore(None)
        return snap, meta

    # ------------------------------------------------------------------
    # admission control (per-tenant budgets from the ResourceLedger)
    # ------------------------------------------------------------------
    def register_tenant(self, spec: TenantSpec) -> None:
        self.tenants[spec.name] = spec
        self._record_admission_entries()

    def tenant_budget_flows(self, name: str) -> int:
        """Tenant flow budget from the ledger's sharding entry: ``share x
        aggregate capacity``, bounded by the share of the aggregate Eq. 11
        byte budget."""
        t = self.tenants[name]
        eng = self.engine
        entry = next((e for e in self.program.ledger.entries
                      if e.stage == "flow-table-sharding"), None)
        budget_bytes = (entry.budget * eng.num_shards if entry is not None
                        else eng.aggregate_state_budget_bytes)
        by_flows = int(t.share * eng.aggregate_capacity)
        by_bytes = int(t.share * budget_bytes // eng.per_flow_state_bytes())
        return max(1, min(by_flows, by_bytes))

    def tenant_resident(self, name: str) -> int:
        return self._tenant_count.get(name, 0)

    def _record_admission_entries(self) -> None:
        ledger = self.program.ledger
        ledger.entries = [e for e in ledger.entries if e.stage != "admission-control"]
        for t in sorted(self.tenants.values(), key=lambda t: (-t.priority, t.name)):
            ledger.add(
                "admission-control", f"tenant[{t.name}]-flows",
                used=self.tenant_resident(t.name),
                budget=self.tenant_budget_flows(t.name),
                detail=(
                    f"priority {t.priority}, share {t.share:g} of "
                    f"{self.engine.aggregate_capacity}-flow aggregate; "
                    f"shed {self.shed_flows.get(t.name, 0)} flow(s) / "
                    f"{self.shed_packets.get(t.name, 0)} packet(s)"
                ),
            )

    def _rebuild_tenant_counts(self) -> None:
        resident = set(self.engine.flow_ids())
        self._tenant_of = {f: t for f, t in self._tenant_of.items() if f in resident}
        counts: Dict[str, int] = {}
        for t in self._tenant_of.values():
            counts[t] = counts.get(t, 0) + 1
        self._tenant_count = counts

    def _shed_victim(self, below_priority: int) -> Optional[int]:
        """Evict one resident flow of the lowest-priority tenant strictly
        below ``below_priority`` (deterministic: smallest fid).  Returns the
        evicted fid, or None when no lower-priority tenant has flows."""
        candidates = sorted(
            (t.priority, t.name) for t in self.tenants.values()
            if t.priority < below_priority and self._tenant_count.get(t.name, 0)
        )
        if not candidates:
            return None
        _, victim_tenant = candidates[0]
        fid = min(f for f, t in self._tenant_of.items() if t == victim_tenant)
        self.engine.evict(fid)
        del self._tenant_of[fid]
        self._tenant_count[victim_tenant] -= 1
        self.shed_flows[victim_tenant] = self.shed_flows.get(victim_tenant, 0) + 1
        return fid

    def _admit_mask(self, flow_ids: np.ndarray, tenant) -> np.ndarray:
        n = len(flow_ids)
        if tenant is None:
            names = [self.ecfg.default_tenant] * n
        elif isinstance(tenant, str):
            names = [tenant] * n
        else:
            names = [str(t) for t in tenant]
            if len(names) != n:
                raise ValueError(
                    f"per-packet tenant list has {len(names)} entries for {n} packets"
                )
        unknown = sorted(set(names) - set(self.tenants))
        if unknown:
            raise KeyError(
                f"unknown tenant(s) {unknown}; register a TenantSpec "
                f"(registered: {sorted(self.tenants)})"
            )
        self._rebuild_tenant_counts()
        eng = self.engine
        headroom = eng.aggregate_capacity - eng.resident_flows
        budgets = {nm: self.tenant_budget_flows(nm) for nm in set(names)}
        counts = dict(self._tenant_count)

        # one decision per NEW flow, highest-priority tenants first so the
        # lowest-priority tenants are the ones shed under pressure
        order = []
        seen = set()
        for i, (fid, nm) in enumerate(zip(flow_ids.tolist(), names)):
            if fid in self._tenant_of or fid in seen:
                continue
            seen.add(fid)
            order.append((-self.tenants[nm].priority, i, fid, nm))
        decided: Dict[int, bool] = {}
        for _, _, fid, nm in sorted(order):
            ok = counts.get(nm, 0) < budgets[nm] and headroom > 0
            if not ok and headroom <= 0 and counts.get(nm, 0) < budgets[nm]:
                # global pressure: shed a strictly lower-priority tenant's
                # flow to make room for this one
                if self._shed_victim(self.tenants[nm].priority) is not None:
                    headroom += 1
                    ok = True
            decided[fid] = ok
            if ok:
                counts[nm] = counts.get(nm, 0) + 1
                headroom -= 1
                self._tenant_of[fid] = nm
                self._tenant_count[nm] = self._tenant_count.get(nm, 0) + 1
            else:
                # a shed NEW flow may retry next batch — count the shed
                # attempt now, packets below
                self.shed_flows[nm] = self.shed_flows.get(nm, 0) + 1
        admit = np.ones((n,), bool)
        for i, (fid, nm) in enumerate(zip(flow_ids.tolist(), names)):
            if not decided.get(fid, True):
                admit[i] = False
                self.shed_packets[nm] = self.shed_packets.get(nm, 0) + 1
        return admit
