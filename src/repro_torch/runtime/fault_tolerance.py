"""Serving-shard liveness and recovery planning (port of the serving side of
``repro.runtime.fault_tolerance``: ``HeartbeatMonitor`` :32,
``ShardRecoveryPlan`` :156, ``plan_shard_recovery`` :177).

Pure host logic (``time``, dataclasses):

* :class:`HeartbeatMonitor` — per-worker liveness with a timeout; the
  elastic flow service beats every live shard once per ingest tick.
* :func:`plan_shard_recovery` — after losing flow-table shard(s): which
  shards survive, the shrunk shard count to reshard onto, and the tick the
  bounded packet-replay window must reach back to.

The trainer's side of the JAX module (``StragglerDetector``,
``ElasticPlan``, ``ElasticPlanner``) waits for the trainer port.
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
