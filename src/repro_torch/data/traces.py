"""Real-trace replay front-end (port of ``repro.data.traces``, numpy only):
timestamped packet records -> FlowEngine arrival batches.

A compact anonymized trace schema (``chimera-trace-v1``) holds timestamped
records ``(ts_us, flow_id, label, anomalous, tokens[pkt_len])``;
:class:`TraceReplayScenario` turns them into exactly the arrival-round
batch dicts :class:`~repro_torch.data.pipeline.FlowScenario` emits
(``flow_ids/tokens/labels/anomalous/first_packet``, same dtypes and
shapes), so a trace drops into ``FlowEngine`` and ``AdaptiveLoop``
unchanged.

Schema notes (what a pcap/NetFlow converter must produce):

* ``flow_id`` is an opaque uint64: :func:`anonymize_flow_ids` maps raw
  5-tuple hashes through a salted splitmix64, so a committed trace never
  carries addresses or ports.  Re-keying preserves per-flow order.
* ``tokens`` are the classifier alphabet: 0..255 byte values, 256.. field
  markers (the packetization the synthetic streams use).
* ``ts_us`` is monotone non-decreasing; batching never reorders records,
  so same-flow packets stay sequential.
* ``meta.anomaly_signature`` records the 4-token rule-violating signature
  labeled in the trace, so ``compile_program`` can build the matching hard
  rules as it does for generated scenarios.

The port keeps its own copy of the JAX package's committed sample
(``repro_torch/data/fixtures/sample_trace.json``, byte-identical): a
synthesized mixed-kind population with Poisson arrival jitter, then
anonymized.  Regenerate with ``python -m repro_torch.data.traces
--regen-sample``; it comes out byte-identical.

Sharding commutes with batching: every shard replays the full record
stream and keeps only the packets whose
:func:`~repro_torch.data.pipeline.flow_shard` owner matches.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.pipeline import FlowScenario, arrival_rounds, flow_shard

TRACE_SCHEMA = "chimera-trace-v1"

SAMPLE_TRACE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures",
    "sample_trace.json",
)

_META_FIELDS = ("n_classes", "vocab_size", "pkt_len")


def anonymize_flow_ids(fids, salt: int = 0) -> np.ndarray:
    """Salted splitmix64 re-keying of raw flow identifiers (5-tuple hashes,
    NetFlow keys, ...) into opaque uint64 ids.  Deterministic per salt and
    collision-free in practice (64-bit mix of distinct inputs), so per-flow
    record order — hence replay — is preserved while the published trace
    carries no addressing information."""
    z = np.atleast_1d(np.asarray(fids)).astype(np.uint64)
    z = z + np.uint64((salt * 0xD6E8FEB86659FD93) & 0xFFFFFFFFFFFFFFFF)
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    # keep ids inside 48 bits: positive as int64, and disjoint from the
    # per-cycle `c << 48` offset TraceReplayScenario applies when looping
    return z & np.uint64((1 << 48) - 1)


@dataclasses.dataclass(frozen=True)
class TraceMeta:
    """Trace-wide invariants a replay needs before touching any record."""

    n_classes: int
    vocab_size: int
    pkt_len: int
    anomaly_signature: Tuple[int, ...]  # the labeled rule-violating tokens
    source: str = "synthetic"  # provenance note (never raw capture data)
    anonymized: bool = True


@dataclasses.dataclass
class Trace:
    """Columnar timestamped packet records, arrival-ordered.

    ``ts_us`` uint64 (monotone non-decreasing), ``flow_ids`` int64 opaque
    ids, ``tokens`` int32 ``(P, pkt_len)``, ``labels`` int32 in
    ``[0, n_classes)``, ``anomalous`` bool (ground-truth flow label,
    repeated on each of the flow's packets)."""

    meta: TraceMeta
    ts_us: np.ndarray
    flow_ids: np.ndarray
    tokens: np.ndarray
    labels: np.ndarray
    anomalous: np.ndarray

    def __post_init__(self):
        self.ts_us = np.asarray(self.ts_us, np.uint64)
        self.flow_ids = np.asarray(self.flow_ids, np.int64)
        self.tokens = np.asarray(self.tokens, np.int32)
        self.labels = np.asarray(self.labels, np.int32)
        self.anomalous = np.asarray(self.anomalous, bool)
        P = self.ts_us.shape[0]
        if self.tokens.shape != (P, self.meta.pkt_len):
            raise ValueError(
                f"tokens shape {self.tokens.shape} != "
                f"({P}, {self.meta.pkt_len})"
            )
        for name in ("flow_ids", "labels", "anomalous"):
            if getattr(self, name).shape != (P,):
                raise ValueError(f"{name} must have shape ({P},)")
        if P and (np.diff(self.ts_us.astype(np.int64)) < 0).any():
            raise ValueError("ts_us must be monotone non-decreasing")
        if P and (
            self.tokens.min() < 0 or self.tokens.max() >= self.meta.vocab_size
        ):
            raise ValueError(
                f"tokens outside [0, {self.meta.vocab_size}) alphabet"
            )
        if P and (
            self.labels.min() < 0 or self.labels.max() >= self.meta.n_classes
        ):
            raise ValueError(f"labels outside [0, {self.meta.n_classes})")
        if len(self.meta.anomaly_signature) != 4:
            raise ValueError("anomaly_signature must be 4 tokens")

    # ------------------------------------------------------------------
    @property
    def n_packets(self) -> int:
        return int(self.ts_us.shape[0])

    @property
    def n_flows(self) -> int:
        return int(np.unique(self.flow_ids).size)

    @property
    def duration_us(self) -> int:
        if not self.n_packets:
            return 0
        return int(self.ts_us[-1] - self.ts_us[0])

    def save(self, path: str) -> None:
        payload = {
            "schema": TRACE_SCHEMA,
            "meta": dataclasses.asdict(self.meta),
            "records": {
                "ts_us": self.ts_us.astype(np.uint64).tolist(),
                "flow_id": self.flow_ids.tolist(),
                "label": self.labels.tolist(),
                "anomalous": np.asarray(self.anomalous, np.int64).tolist(),
                "tokens": self.tokens.tolist(),
            },
        }
        payload["meta"]["anomaly_signature"] = list(
            self.meta.anomaly_signature
        )
        with open(path, "w") as f:
            json.dump(payload, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")


def load_trace(path: str = SAMPLE_TRACE) -> Trace:
    """Load and validate a ``chimera-trace-v1`` JSON trace."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("schema") != TRACE_SCHEMA:
        raise ValueError(
            f"{path}: schema {payload.get('schema')!r} != {TRACE_SCHEMA!r}"
        )
    m = payload["meta"]
    missing = [k for k in _META_FIELDS if k not in m]
    if missing:
        raise ValueError(f"{path}: meta missing {missing}")
    meta = TraceMeta(
        n_classes=int(m["n_classes"]),
        vocab_size=int(m["vocab_size"]),
        pkt_len=int(m["pkt_len"]),
        anomaly_signature=tuple(int(t) for t in m["anomaly_signature"]),
        source=str(m.get("source", "unknown")),
        anonymized=bool(m.get("anonymized", False)),
    )
    r = payload["records"]
    return Trace(
        meta=meta,
        ts_us=np.asarray(r["ts_us"], np.uint64),
        flow_ids=np.asarray(r["flow_id"], np.int64),
        tokens=np.asarray(r["tokens"], np.int32),
        labels=np.asarray(r["label"], np.int32),
        anomalous=np.asarray(r["anomalous"], bool),
    )


def make_sample_trace(
    seed: int = 23,
    batches: int = 24,
    packets_per_batch: int = 64,
    pkt_len: int = 8,
    mean_rate_pps: float = 25_000.0,
) -> Trace:
    """Synthesize the committed sample: a mixed-kind flow population
    (including rule-violating flows) emitted through FlowScenario, with
    exponential inter-arrival jitter stamping realistic microsecond
    timestamps, then anonymized.  Deterministic in ``seed`` — the committed
    fixture regenerates byte-identically."""
    sc = FlowScenario(kind="mix", pkt_len=pkt_len,
                      packets_per_batch=packets_per_batch, seed=seed,
                      anomaly_rate=0.25)
    cols: Dict[str, list] = {k: [] for k in
                             ("flow_ids", "tokens", "labels", "anomalous")}
    for _ in range(batches):
        b = sc.next_batch()
        for k in cols:
            cols[k].append(b[k])
    flow_ids = np.concatenate(cols["flow_ids"])
    anon = anonymize_flow_ids(flow_ids, salt=seed).astype(np.int64)
    if np.unique(anon).size != np.unique(flow_ids).size:
        raise RuntimeError("anonymization collided; pick another salt")
    g = np.random.default_rng(np.array([seed, 0x7ACE], dtype=np.uint64))
    gaps = g.exponential(1e6 / mean_rate_pps, size=flow_ids.shape[0])
    ts_us = np.cumsum(np.maximum(gaps, 1.0)).astype(np.uint64)
    return Trace(
        meta=TraceMeta(
            n_classes=sc.n_classes,
            vocab_size=sc.vocab_size,
            pkt_len=pkt_len,
            anomaly_signature=tuple(int(t) for t in sc.anomaly_signature),
            source="synthetic-mixed-kinds (real captures are not "
                   "redistributable; schema matches a pcap converter's "
                   "output)",
            anonymized=True,
        ),
        ts_us=ts_us,
        flow_ids=anon,
        tokens=np.concatenate(cols["tokens"]),
        labels=np.concatenate(cols["labels"]),
        anomalous=np.concatenate(cols["anomalous"]),
    )


# --------------------------------------------------------------------------
# Replay: records -> FlowScenario-shaped arrival batches
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TraceReplayScenario:
    """Replay a :class:`Trace` as FlowScenario-compatible arrival batches.

    Two batching modes, both order-preserving (same-flow packets stay
    sequential, so the engine's arrival-round contract holds):

    * ``window_us == 0`` (default): fixed-size slices of
      ``packets_per_batch`` records in timestamp order.
    * ``window_us > 0``: one batch per wall-clock window — batch ``i``
      holds the records with ``ts in [t0 + i*W, t0 + (i+1)*W)``.  Batch
      sizes then vary with the recorded arrival process (bursts arrive as
      bursts), which is the point of replaying a trace.

    Sharded replay filters each *unsharded* batch by
    :func:`~repro_torch.data.pipeline.flow_shard` owner AFTER slicing, so
    sharding commutes with batching (union of shards == unsharded stream,
    batch for batch) and the batch boundaries never depend on the shard.

    The trace is finite.  ``next_batch`` past :attr:`batches_per_cycle`
    raises :class:`TraceExhausted` unless ``loop=True``, in which case
    cycle ``c`` replays the same records with flow ids offset into a
    disjoint ``c << 48`` id space (fresh flows, like DriftScenario's
    per-instance ``fid_base``) and timestamps shifted by ``c`` trace
    durations.
    """

    trace: Trace
    packets_per_batch: int = 256
    window_us: int = 0
    shard_id: int = 0
    num_shards: int = 1
    loop: bool = False
    step: int = 0

    def __post_init__(self):
        if not 0 <= self.shard_id < self.num_shards:
            raise ValueError(
                f"shard_id {self.shard_id} outside [0, {self.num_shards})"
            )
        if self.packets_per_batch < 1:
            raise ValueError("packets_per_batch must be >= 1")
        if self.window_us < 0:
            raise ValueError("window_us must be >= 0")
        t = self.trace
        # the i-th record is its flow's first packet iff no earlier record
        # carries the same id (pure function of the trace, precomputed once)
        seen: Dict[int, int] = {}
        first = np.zeros((t.n_packets,), bool)
        for i, fid in enumerate(t.flow_ids.tolist()):
            if fid not in seen:
                seen[fid] = i
                first[i] = True
        self._first = first
        if self.window_us:
            if t.n_packets:
                rel = (t.ts_us - t.ts_us[0]).astype(np.int64)
                self._bounds = np.searchsorted(
                    rel,
                    np.arange(1, rel[-1] // self.window_us + 2)
                    * self.window_us,
                )
            else:
                self._bounds = np.zeros((0,), np.int64)
        else:
            n = -(-t.n_packets // self.packets_per_batch)
            self._bounds = (
                np.arange(1, n + 1, dtype=np.int64) * self.packets_per_batch
            ).clip(max=t.n_packets)

    # ------------------------------------------------------------------
    @property
    def batches_per_cycle(self) -> int:
        return int(self._bounds.shape[0])

    @property
    def anomaly_signature(self) -> np.ndarray:
        """The labeled rule-violating signature (FlowScenario API), for
        ``compile_program(rules=...)`` at deploy time."""
        return np.asarray(self.trace.meta.anomaly_signature, np.int64)

    @property
    def exhausted(self) -> bool:
        return not self.loop and self.step >= self.batches_per_cycle

    def next_batch(self) -> Dict[str, np.ndarray]:
        if self.batches_per_cycle == 0:
            raise TraceExhausted("trace holds no records")
        cycle, within = divmod(self.step, self.batches_per_cycle)
        if cycle and not self.loop:
            raise TraceExhausted(
                f"trace exhausted after {self.batches_per_cycle} batches "
                f"(pass loop=True to cycle with fresh flow ids)"
            )
        lo = int(self._bounds[within - 1]) if within else 0
        hi = int(self._bounds[within])
        t = self.trace
        sl = slice(lo, hi)
        batch = {
            "flow_ids": t.flow_ids[sl] + (np.int64(cycle) << np.int64(48)),
            "tokens": t.tokens[sl].copy(),
            "labels": t.labels[sl].copy(),
            "anomalous": t.anomalous[sl].copy(),
            "first_packet": self._first[sl].copy(),
        }
        if self.num_shards > 1:
            keep = flow_shard(batch["flow_ids"], self.num_shards) == self.shard_id
            batch = {k: v[keep] for k, v in batch.items()}
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while not self.exhausted:
            yield self.next_batch()


class TraceExhausted(RuntimeError):
    """A finite trace was replayed past its last batch without loop=True."""


def replay_rounds(batch: Dict[str, np.ndarray]) -> "list[list[int]]":
    """The engine-side arrival rounds a batch will be split into (exposed
    for tests auditing the per-flow sequencing contract)."""
    return arrival_rounds(batch["flow_ids"].tolist())


def _main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="chimera-trace-v1 sample trace tool")
    ap.add_argument("--regen-sample", action="store_true",
                    help="regenerate the committed sample trace fixture")
    ap.add_argument("--out", default=SAMPLE_TRACE)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--info", default=None, metavar="PATH",
                    help="print a summary of a trace file and exit")
    args = ap.parse_args(argv)
    if args.info:
        t = load_trace(args.info)
        print(
            f"{args.info}: {t.n_packets} packets / {t.n_flows} flows over "
            f"{t.duration_us/1e6:.3f}s ({t.n_packets/max(t.duration_us, 1)*1e6:.0f} pps), "
            f"pkt_len={t.meta.pkt_len} classes={t.meta.n_classes} "
            f"anomalous={int(t.anomalous.sum())} "
            f"source={t.meta.source!r} anonymized={t.meta.anonymized}"
        )
        return
    if args.regen_sample:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        make_sample_trace(seed=args.seed).save(args.out)
        print(f"sample trace written to {args.out}")
        return
    ap.error("nothing to do: pass --regen-sample or --info PATH")


if __name__ == "__main__":
    _main()
