"""Liveness, stragglers and recovery planning (port of
``repro.runtime.fault_tolerance``: ``HeartbeatMonitor`` :32,
``StragglerDetector`` :53, ``ElasticPlan`` :91, ``ElasticPlanner`` :106,
``ShardRecoveryPlan`` :156, ``plan_shard_recovery`` :177).

Pure host logic (``time``, dataclasses):

* :class:`HeartbeatMonitor` — per-worker liveness with a timeout; the
  trainer beats once per step, the elastic flow service once per live
  shard and ingest tick.
* :class:`StragglerDetector` — per-worker step-time EWMA against the fleet
  median; flags workers slower than ``threshold`` x median for
  ``patience`` consecutive checks, with the mitigations ranked.
* :class:`ElasticPlanner` — after worker failures, the largest (pod, data,
  model) mesh that keeps the model (TP) axis, as an :class:`ElasticPlan`.
* :func:`plan_shard_recovery` — after losing flow-table shard(s): which
  shards survive, the shrunk shard count to reshard onto, and the tick the
  bounded packet-replay window must reach back to.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 60.0
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)
    _step: Dict[int, int] = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, step: int, t: Optional[float] = None) -> None:
        self._last[worker] = time.monotonic() if t is None else t
        self._step[worker] = step

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(w for w, t in self._last.items() if now - t > self.timeout_s)

    def laggards(self, slack_steps: int = 2) -> List[int]:
        if not self._step:
            return []
        lead = max(self._step.values())
        return sorted(w for w, s in self._step.items() if lead - s > slack_steps)


@dataclasses.dataclass
class StragglerDetector:
    threshold: float = 1.5  # × fleet median
    patience: int = 3
    ewma: float = 0.5
    _t: Dict[int, float] = dataclasses.field(default_factory=dict)
    _strikes: Dict[int, int] = dataclasses.field(default_factory=dict)

    def record(self, worker: int, step_seconds: float) -> None:
        prev = self._t.get(worker, step_seconds)
        self._t[worker] = self.ewma * step_seconds + (1 - self.ewma) * prev

    def _median(self) -> float:
        xs = sorted(self._t.values())
        return xs[len(xs) // 2] if xs else 0.0

    def stragglers(self) -> List[int]:
        med = self._median()
        out = []
        for w, t in self._t.items():
            if med > 0 and t > self.threshold * med:
                self._strikes[w] = self._strikes.get(w, 0) + 1
            else:
                self._strikes[w] = 0
            if self._strikes.get(w, 0) >= self.patience:
                out.append(w)
        return sorted(out)

    def mitigation(self, worker: int) -> str:
        """Ranked mitigation policy (documented order for operators)."""
        strikes = self._strikes.get(worker, 0)
        if strikes < self.patience:
            return "monitor"
        if strikes < 2 * self.patience:
            return "reshard-away"  # move its FSDP shard to a hot spare
        return "evict-and-shrink"  # trigger ElasticPlanner


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    n_devices: int
    dropped_workers: Tuple[int, ...]
    note: str

    @property
    def valid(self) -> bool:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n == self.n_devices


class ElasticPlanner:
    """Shrink/regrow the mesh preserving the model (TP) axis."""

    def __init__(self, model_parallel: int = 16, pods: int = 2, data: int = 16):
        self.model = model_parallel
        self.pods = pods
        self.data = data

    def plan_after_failures(self, failed_workers: Sequence[int],
                            devices_per_worker: int = 4) -> ElasticPlan:
        dropped = tuple(sorted(set(failed_workers)))
        avail = self.pods * self.data * self.model - len(dropped) * devices_per_worker
        # keep `model` intact; shrink data to the largest power of two that
        # fits, so that it divides the global batch
        new_data = avail // self.pods // self.model
        if new_data < 1:
            return ElasticPlan((), (), 0, dropped, "insufficient capacity")
        p = 1
        while p * 2 <= new_data:
            p *= 2
        new_data = p
        return ElasticPlan(
            mesh_shape=(self.pods, new_data, self.model),
            mesh_axes=("pod", "data", "model"),
            n_devices=self.pods * new_data * self.model,
            dropped_workers=dropped,
            note=(
                f"TP axis preserved ({self.model}); data {self.data}->{new_data}; "
                "restore via Checkpointer.restore with re-derived shardings; "
                "global batch kept via grad accumulation x"
                f"{max(1, self.data // new_data)}"
            ),
        )

    def regrow(self, plan: ElasticPlan, recovered: int) -> ElasticPlan:
        return self.plan_after_failures(
            plan.dropped_workers[: max(0, len(plan.dropped_workers) - recovered)]
        )


@dataclasses.dataclass(frozen=True)
class ShardRecoveryPlan:
    """Recovery recipe after losing flow-table shard(s): which shards
    survive, the shrunk shard count to reshard onto, and the tick the
    bounded packet-replay window must reach back to (the last checkpoint —
    lost flows are restored at that tick and replayed forward)."""

    failed: Tuple[int, ...]
    surviving: Tuple[int, ...]
    new_num_shards: int
    replay_from_tick: int
    note: str = ""

    @property
    def valid(self) -> bool:
        return (
            self.new_num_shards >= 1
            and self.new_num_shards == len(self.surviving)
            and not set(self.failed) & set(self.surviving)
        )


def plan_shard_recovery(
    num_shards: int, failed: Sequence[int], checkpoint_tick: int
) -> ShardRecoveryPlan:
    """Plan kill-a-shard recovery for an elastic flow service.

    Survivors keep their live rows (current state, nothing to replay);
    flows owned by failed shards are restored from the ``checkpoint_tick``
    snapshot and brought current by replaying the buffered post-checkpoint
    batches routed to the failed shards under the old topology.
    """
    bad = sorted(set(int(f) for f in failed))
    for f in bad:
        if not 0 <= f < num_shards:
            raise ValueError(f"failed shard {f} outside [0, {num_shards})")
    surviving = tuple(s for s in range(num_shards) if s not in bad)
    return ShardRecoveryPlan(
        failed=tuple(bad),
        surviving=surviving,
        new_num_shards=len(surviving),
        replay_from_tick=int(checkpoint_tick),
        note=(
            f"reshard {num_shards}->{len(surviving)}; restore failed-shard "
            f"flows at tick {checkpoint_tick}, replay buffered batches "
            f"with tick > {checkpoint_tick} for failed-shard keys"
        ),
    )
