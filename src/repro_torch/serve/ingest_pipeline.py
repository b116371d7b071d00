"""Async host-side ingest pipeline over a fused FlowEngine (port of
``repro.serve.ingest_pipeline``).

The fused path splits an ingest call into two halves with different owners:

  host   — directory lookup, LRU/idle eviction, packing the arrival rounds
           into pinned staging buffers (``FlowEngine._dispatch_fused``),
  device — the host-to-device copies, one graph replay per chunk and the
           copy of the batch's results back, all enqueued on one stream.

Run synchronously, the two halves serialize.  This pipeline overlaps them
with a ring of ``depth`` staging slots: ``submit`` packs batch k + 1 into
slot (k + 1) % depth and enqueues its work while the card still runs batch
k.  Each ring slot owns its pinned staging pool, and each dispatched batch
carries a CUDA event recorded after its launches and its result copy.

Ordering and state are untouched: slot resolution happens in ``submit`` in
arrival order (the flow directory is host state, mutated synchronously),
and the launches are enqueued in order on one stream, so the results are
those of synchronous ingest.  The ring only bounds how far the host runs
ahead: before ``submit`` reuses a slot's pool it finalizes the batch that
last used it, which waits for that batch's event.

    pipe = AsyncIngestPipeline(engine)         # engine built with fused=True
    for batch in scenario:
        pipe.submit(batch["flow_ids"], batch["tokens"])
    results = pipe.drain()                     # per-batch output dicts

``ingest(...)`` is a synchronous drop-in (submit + finalize) for call sites
that need each batch's outputs at once but still want the staging ring.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class AsyncIngestPipeline:
    """Ring-buffered ingest: the host packs ahead, the card drains."""

    def __init__(self, engine, depth: Optional[int] = None):
        if not engine.fcfg.fused:
            raise ValueError(
                "AsyncIngestPipeline requires a fused engine "
                "(FlowEngineConfig(fused=True))"
            )
        self.engine = engine
        self.depth = depth or engine.fcfg.ring_slots
        if self.depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {self.depth}")
        # one private pinned staging pool per ring slot, filled lazily by
        # _dispatch_fused and reused across batches
        self._pools: List[Dict] = [{} for _ in range(self.depth)]
        self._pending: List[Optional[object]] = [None] * self.depth
        self._seq = 0  # batches submitted
        self._results: List[Dict[str, np.ndarray]] = []

    @property
    def in_flight(self) -> int:
        return sum(p is not None for p in self._pending)

    def submit(self, flow_ids, tokens) -> None:
        """Pack and dispatch one batch; returns without waiting for the card
        (beyond the ring's backpressure)."""
        eng = self.engine
        flow_ids = np.asarray(flow_ids)
        tokens = np.asarray(tokens, np.int32)
        P, _ = tokens.shape
        assert flow_ids.shape == (P,), (flow_ids.shape, P)

        slot = self._seq % self.depth
        prev = self._pending[slot]
        if prev is not None:
            # the slot's pool is still the source of an earlier batch's
            # copies: harvest that batch (its event) before reusing it
            self._results.append(prev.finalize())
            self._pending[slot] = None

        slots, fresh = eng._resolve_slots(flow_ids)
        self._pending[slot] = eng._dispatch_fused(
            flow_ids, tokens, slots, fresh, staging=self._pools[slot]
        )
        self._seq += 1

    def poll(self) -> List[Dict[str, np.ndarray]]:
        """Harvest every result accumulated so far, in submit order."""
        out, self._results = self._results, []
        return out

    def drain(self) -> List[Dict[str, np.ndarray]]:
        """Finalize all in-flight batches; returns results in submit order."""
        for k in range(max(self._seq - self.depth, 0), self._seq):
            slot = k % self.depth
            p = self._pending[slot]
            if p is not None:
                self._results.append(p.finalize())
                self._pending[slot] = None
        return self.poll()

    def ingest(self, flow_ids, tokens) -> Dict[str, np.ndarray]:
        """Synchronous drop-in for ``engine.ingest`` through the ring path."""
        self.submit(flow_ids, tokens)
        slot = (self._seq - 1) % self.depth
        res = self._pending[slot].finalize()
        self._pending[slot] = None
        return res
