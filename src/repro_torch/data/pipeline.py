"""Traffic and token streams (numpy only).

A copy of the parts of ``repro.data.pipeline`` that the port needs
(``_rng``, ``_traffic_tables``, ``flow_shard``, ``reshard_moves``,
``arrival_rounds``, ``TokenStream``, ``PacketStream``, ``SCENARIO_KINDS``,
``FlowScenario`` and the drift schedules ``DriftPhase``, ``label_ramp``,
``parse_phases`` and ``DriftScenario``), so the port runs where JAX is not installed.  Same
seeds, same draw order: both packages emit the same batches, which the
port's tests check.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.array([seed, *stream], dtype=np.uint64))


def _traffic_tables(
    seed: int, n_classes: int, vocab_size: int, hard_mode: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Class-conditional token tables shared by PacketStream and FlowScenario:
    (handshake (C,8), kernel (C,64,8), signature (C,4), anomaly_sig (4,)).
    Draw order is load-bearing — it fixes the seeded streams."""
    g = _rng(seed, 0xF10)
    C = n_classes
    handshake = g.integers(256, vocab_size, size=(C, 8))
    kernel = g.integers(0, 256, size=(C, 64, 8))
    signature = g.integers(256, vocab_size, size=(C, 4))
    if hard_mode:
        # shared handshake: the class is not readable from the prefix
        handshake = np.broadcast_to(handshake[:1], (C, 8)).copy()
    anomaly_sig = g.integers(256, vocab_size, size=(4,))
    return handshake, kernel, signature, anomaly_sig


def flow_shard(fids, num_shards: int) -> np.ndarray:
    """Deterministic flow → shard owner: ``splitmix64(fid) % num_shards``.

    A fixed 64-bit mix rather than Python ``hash`` so routing is stable
    across processes, batch sizes and batch resizes — a flow's owner
    depends only on its ID and the shard count, never on arrival order.
    The JAX package's sharded engine routes with it, and
    :class:`FlowScenario` sharded generation filters with it, so both
    agree on ownership.  Returns an int64 array of shard
    indices in ``[0, num_shards)``."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    z = np.atleast_1d(np.asarray(fids)).astype(np.uint64)
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(num_shards)).astype(np.int64)


def reshard_moves(fids, old_shards: int, new_shards: int) -> np.ndarray:
    """Boolean mask of flows whose owner changes between two shard counts —
    the migrating key ranges a live reshard must quiesce (flows whose owner
    is unchanged could keep serving through the install).  Pure function of
    :func:`flow_shard`, so the service and the traffic generators agree on
    exactly which keys move."""
    f = np.atleast_1d(np.asarray(fids))
    if f.size == 0:
        return np.zeros((0,), bool)
    return flow_shard(f, old_shards) != flow_shard(f, new_shards)


def arrival_rounds(keys) -> "list[list[int]]":
    """Partition arrival-ordered items into rounds where every key appears at
    most once, preserving per-key order (round r holds each key's r-th
    occurrence).  Used by FlowScenario generation and the FlowEngine ingest
    path so same-flow packets are always processed sequentially."""
    rounds: list = []
    seen: Dict = {}
    for i, k in enumerate(keys):
        r = seen.get(k, 0)
        seen[k] = r + 1
        if r == len(rounds):
            rounds.append([])
        rounds[r].append(i)
    return rounds


# --------------------------------------------------------------------------
# Training streams
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    batch_size: int  # per-shard batch
    seq_len: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    step: int = 0  # resumable state

    def __post_init__(self):
        g = _rng(self.seed, 0xBEEF)
        k = min(64, self.vocab_size)
        # sparse Markov structure over a k-token "active set" per context hash
        self._active = g.integers(0, self.vocab_size, size=(256, k))

    def state(self) -> Dict[str, int]:
        return {"step": self.step, "shard_id": self.shard_id, "num_shards": self.num_shards}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])

    def next_batch(self) -> Dict[str, np.ndarray]:
        g = _rng(self.seed, self.shard_id, self.step)
        B, T = self.batch_size, self.seq_len
        k = self._active.shape[1]
        ctx = g.integers(0, 256, size=(B,))
        toks = np.empty((B, T), np.int32)
        choices = g.integers(0, k, size=(B, T))
        noise = g.random((B, T)) < 0.05
        rand_tok = g.integers(0, self.vocab_size, size=(B, T))
        for t in range(T):
            row = self._active[ctx, choices[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], row)
            ctx = (ctx * 31 + toks[:, t]) % 256
        self.step += 1
        return {
            "tokens": toks[:, :-1].copy(),
            "labels": toks[:, 1:].copy(),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


@dataclasses.dataclass
class PacketStream:
    """Class-conditional packet-token flows (paper §4 traffic proxy).

    Tokens 0..255 are byte-values; 256..511 are field markers.  Each class
    has a handshake prefix, a characteristic transition kernel and periodic
    signature tokens.  ``anomaly_rate`` flows carry rule-violating signature
    bursts (used for the AE detection study and hard-veto tests).
    """

    n_classes: int = 8
    vocab_size: int = 512
    batch_size: int = 32
    seq_len: int = 128
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    anomaly_rate: float = 0.0
    drift: float = 0.0  # distribution drift per 1000 steps (Table 5 study)
    # hard mode: handshake and signature markers shared across classes and
    # per-class transition structure built as permutations of one base chain
    # (identical token marginals — a bag-of-tokens model is at chance; only
    # sequence structure separates classes) + body noise.  Keeps the
    # benchmark classification task from saturating so ablation deltas show.
    hard_mode: bool = False
    noise: float = 0.0
    marker_noise: float = 0.0  # random marker tokens (blurs novelty signals)
    step: int = 0

    def __post_init__(self):
        # hard mode keeps per-class chains and periodic signatures (learnable
        # but not trivially, so method deltas stay visible pre-saturation)
        self._handshake, self._kernel, self._signature, self._anomaly_sig = (
            _traffic_tables(self.seed, self.n_classes, self.vocab_size, self.hard_mode)
        )

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])

    def next_batch(self) -> Dict[str, np.ndarray]:
        g = _rng(self.seed, self.shard_id, self.step, 7)
        B, T, C = self.batch_size, self.seq_len, self.n_classes
        labels = g.integers(0, C, size=(B,))
        toks = np.empty((B, T), np.int32)
        # drift: the chain state offsets rotate slowly over steps (Table 5)
        drift_off = int(self.drift * self.step / 1000.0 * 64)
        hs = self._handshake[labels]
        toks[:, :8] = hs
        state = g.integers(0, 64, size=(B,))
        choice = g.integers(0, 8, size=(B, T))
        for t in range(8, T):
            emit_sig = (t % 17) == 0
            sig = self._signature[labels, t % 4]
            body = self._kernel[labels, (state + drift_off) % 64, choice[:, t]]
            toks[:, t] = np.where(emit_sig, sig, body)
            state = (state * 5 + toks[:, t]) % 64
        if self.noise > 0:
            noisy = g.random((B, T)) < self.noise
            rand = g.integers(0, 256, size=(B, T))
            toks[:, 8:] = np.where(noisy[:, 8:], rand[:, 8:], toks[:, 8:])
        if self.marker_noise > 0:
            mn = g.random((B, T)) < self.marker_noise
            randm = g.integers(256, self.vocab_size, size=(B, T))
            toks[:, 8:] = np.where(mn[:, 8:], randm[:, 8:], toks[:, 8:])
        anomalous = g.random((B,)) < self.anomaly_rate
        if anomalous.any():
            pos = g.integers(16, T - 4)
            toks[anomalous, pos : pos + 4] = self._anomaly_sig
        self.step += 1
        return {
            "tokens": toks,
            "labels": labels.astype(np.int32),
            "anomalous": anomalous,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


# --------------------------------------------------------------------------
# Flow-level traffic scenarios (FlowEngine workload)
# --------------------------------------------------------------------------

# per-kind arrival shapes: steady protocol mixture, scan floods of one-packet
# flows, periodic DDoS-style bursts of fresh flow IDs, short-lived churn, and
# rule-violating flows carrying the anomaly signature
SCENARIO_KINDS: Dict[str, Dict[str, float]] = {
    "protocol-mix": dict(new_flows=16, mean_pkts=8, burst_every=0, burst_size=0,
                         anomaly_rate=0.0),
    "port-scan": dict(new_flows=128, mean_pkts=1, burst_every=0, burst_size=0,
                      anomaly_rate=0.0),
    "burst": dict(new_flows=8, mean_pkts=6, burst_every=4, burst_size=384,
                  anomaly_rate=0.0),
    "heavy-churn": dict(new_flows=64, mean_pkts=2, burst_every=0, burst_size=0,
                        anomaly_rate=0.0),
    "rule-violating": dict(new_flows=16, mean_pkts=8, burst_every=0,
                           burst_size=0, anomaly_rate=0.5),
    # campaign-library kinds: slowloris holds many
    # long-lived connections open at a trickle (each flow's packets spread
    # thin across the uniformly-sampled emission lanes); low-and-slow is a
    # handful of very long flows — the exfiltration shape that hides a
    # signature burst inside an otherwise unremarkable stream
    "slowloris": dict(new_flows=48, mean_pkts=32, burst_every=0, burst_size=0,
                      anomaly_rate=0.0),
    "low-and-slow": dict(new_flows=4, mean_pkts=48, burst_every=0,
                         burst_size=0, anomaly_rate=0.0),
}
_MIX_CYCLE = (
    "protocol-mix", "port-scan", "burst", "heavy-churn", "rule-violating",
)


@dataclasses.dataclass
class FlowScenario:
    """Interleaved packet-arrival stream over a churning population of flows.

    Unlike a whole-flow (B, T) batch generator, this
    generator emits *packets*: each ``next_batch`` returns up to
    ``packets_per_batch`` arrivals ``(flow_ids, tokens, labels, anomalous)``
    drawn from the currently-active flow set, with new flows spawning and
    finished flows retiring per the scenario ``kind`` (see
    :data:`SCENARIO_KINDS`; ``"mix"`` cycles through all of them).  Flows
    continue the same class-conditional token chains as PacketStream —
    handshake prefix, per-class kernel, periodic signature markers — and
    rule-violating flows inject the 4-token anomaly signature, so the same
    :func:`repro_torch.train.classifier.default_rules` hard rules fire on them.
    """

    kind: str = "protocol-mix"
    n_classes: int = 8
    vocab_size: int = 512
    pkt_len: int = 16
    packets_per_batch: int = 256
    seed: int = 0
    hard_mode: bool = False
    max_flow_pkts: int = 64  # hard cap on flow length (keeps state bounded)
    # cap on concurrently-active flows: burst kinds spawn faster than the
    # packets_per_batch-bounded emission path retires, so without a ceiling
    # the host-side flow dict grows for the generator's lifetime
    max_active: int = 8192
    # shard-aware generation: every shard runs the FULL generator (same
    # seed, same flow population, same chain states — the RNG draw order
    # never depends on the shard) and emits only the packets whose
    # flow_shard owner is shard_id.  The union of the num_shards streams is
    # exactly the num_shards=1 stream, packet for packet, so sharded and
    # single-device runs replay identical traffic.
    shard_id: int = 0
    num_shards: int = 1
    # drift-phase knobs (all default to the stationary behaviour):
    # fid_base offsets every spawned flow ID (DriftScenario gives each phase
    # a disjoint ID space); label_probs replaces the uniform class draw;
    # anomaly_rate overrides the kind's knob; sig_rotation > 0 swaps the
    # anomaly signature for a freshly drawn one (the adversarial surge — the
    # rules compiled against rotation 0 no longer match)
    fid_base: int = 0
    label_probs: Optional[Tuple[float, ...]] = None
    anomaly_rate: Optional[float] = None
    sig_rotation: int = 0
    step: int = 0

    def __post_init__(self):
        if self.kind != "mix" and self.kind not in SCENARIO_KINDS:
            raise ValueError(
                f"unknown scenario kind {self.kind!r}; "
                f"expected 'mix' or one of {sorted(SCENARIO_KINDS)}"
            )
        if not 0 <= self.shard_id < self.num_shards:
            raise ValueError(
                f"shard_id {self.shard_id} outside [0, {self.num_shards})"
            )
        if self.label_probs is not None:
            p = np.asarray(self.label_probs, np.float64)
            if p.shape != (self.n_classes,) or (p < 0).any() or not np.isclose(p.sum(), 1.0):
                raise ValueError(
                    f"label_probs must be {self.n_classes} non-negative "
                    f"values summing to 1, got {self.label_probs}"
                )
            self._label_p = p / p.sum()
        self._handshake, self._kernel, self._signature, self._anomaly_sig = (
            _traffic_tables(self.seed, self.n_classes, self.vocab_size, self.hard_mode)
        )
        if self.sig_rotation:
            # a fresh signature from its own stream: rotation never perturbs
            # the base tables, so rotation-0 streams are byte-identical to
            # the pre-rotation generator
            g = _rng(self.seed, 0xA51, self.sig_rotation)
            self._anomaly_sig = g.integers(256, self.vocab_size, size=(4,))
        self._next_fid = self.fid_base
        # fid -> [label, chain_state, tok_pos, pkts_left, anomalous, anom_at]
        self._active: Dict[int, list] = {}
        self.flows_spawned = 0
        self.flows_retired = 0

    # ------------------------------------------------------------------
    @property
    def anomaly_signature(self) -> np.ndarray:
        return self._anomaly_sig

    @property
    def active_flows(self) -> int:
        return len(self._active)

    def _knobs(self) -> Dict[str, float]:
        kind = self.kind
        if kind == "mix":
            kind = _MIX_CYCLE[self.step % len(_MIX_CYCLE)]
        return SCENARIO_KINDS[kind]

    def _spawn(self, g: np.random.Generator, n: int, anomaly_rate: float,
               mean_pkts: float) -> None:
        n = min(n, self.max_active - len(self._active))
        for _ in range(n):
            fid = self._next_fid
            self._next_fid += 1
            if self.label_probs is None:
                label = int(g.integers(0, self.n_classes))
            else:
                label = int(g.choice(self.n_classes, p=self._label_p))
            state = int(g.integers(0, 64))
            left = int(min(g.geometric(1.0 / max(mean_pkts, 1.0)), self.max_flow_pkts))
            anom = bool(g.random() < anomaly_rate)
            anom_at = 0
            if anom:
                # guarantee the signature burst lands inside the flow body
                # without exceeding the max_flow_pkts hard cap; a cap too
                # tight to carry the 4-token burst downgrades to benign
                left = min(max(left, -(-24 // self.pkt_len)), self.max_flow_pkts)
                if left * self.pkt_len >= 13:
                    anom_at = int(g.integers(8, left * self.pkt_len - 4))
                else:
                    anom = False
            self._active[fid] = [label, state, 0, left, anom, anom_at]
            self.flows_spawned += 1

    def _gen_tokens(self, g, labels, state, pos, anom, anom_at) -> Tuple[np.ndarray, np.ndarray]:
        """Continue R flows by one packet each (vectorized over flows)."""
        R, T = labels.shape[0], self.pkt_len
        toks = np.empty((R, T), np.int32)
        choice = g.integers(0, 8, size=(R, T))
        for t in range(T):
            a = pos + t  # absolute token position per flow
            hs = self._handshake[labels, np.minimum(a, 7)]
            sig = self._signature[labels, a % 4]
            body = self._kernel[labels, state % 64, choice[:, t]]
            tok = np.where(a < 8, hs, np.where(a % 17 == 0, sig, body))
            inject = anom & (a >= anom_at) & (a < anom_at + 4)
            tok = np.where(inject, self._anomaly_sig[np.clip(a - anom_at, 0, 3)], tok)
            state = np.where(a >= 8, (state * 5 + tok) % 64, state)
            toks[:, t] = tok
        return toks, state

    def next_batch(self) -> Dict[str, np.ndarray]:
        g = _rng(self.seed, 0xF70, self.step)
        knobs = self._knobs()
        n_new = int(knobs["new_flows"])
        if knobs["burst_every"] and self.step % int(knobs["burst_every"]) == 0:
            n_new += int(knobs["burst_size"])  # DDoS-style flood of fresh IDs
        if not self._active and n_new == 0:
            n_new = 1
        ar = (
            float(knobs["anomaly_rate"])
            if self.anomaly_rate is None
            else float(self.anomaly_rate)
        )
        self._spawn(g, n_new, ar, float(knobs["mean_pkts"]))

        # sample arrival lanes with replacement: the same flow may send
        # several packets inside one batch (true interleaving)
        ids = np.fromiter(self._active, dtype=np.int64, count=len(self._active))
        lanes = ids[g.integers(0, len(ids), size=self.packets_per_batch)]
        scheduled: Dict[int, int] = {}
        emit: list = []
        for fid in lanes.tolist():
            if scheduled.get(fid, 0) < self._active[fid][3]:
                scheduled[fid] = scheduled.get(fid, 0) + 1
                emit.append(fid)
        P = len(emit)
        tokens = np.empty((P, self.pkt_len), np.int32)
        labels = np.empty((P,), np.int32)
        anomalous = np.zeros((P,), bool)
        first = np.zeros((P,), bool)
        for round_lanes in arrival_rounds(emit):
            sub = [emit[i] for i in round_lanes]
            st = np.array([self._active[f] for f in sub], dtype=np.int64)
            lab, state, pos = st[:, 0], st[:, 1], st[:, 2]
            toks, state = self._gen_tokens(
                g, lab, state, pos, st[:, 4].astype(bool), st[:, 5]
            )
            for j, f in enumerate(sub):
                rec = self._active[f]
                rec[1] = int(state[j])
                rec[2] = int(pos[j]) + self.pkt_len
                rec[3] -= 1
                idx = round_lanes[j]
                tokens[idx] = toks[j]
                labels[idx] = rec[0]
                anomalous[idx] = rec[4]
                first[idx] = pos[j] == 0
        for fid in [f for f, rec in self._active.items() if rec[3] <= 0]:
            del self._active[fid]
            self.flows_retired += 1
        self.step += 1
        fids = np.asarray(emit, np.int64)
        batch = {
            "flow_ids": fids,
            "tokens": tokens,
            "labels": labels,
            "anomalous": anomalous,
            "first_packet": first,
        }
        if self.num_shards > 1:
            # filter AFTER every state update so the generator evolves
            # identically for all (shard_id, num_shards) settings
            keep = flow_shard(fids, self.num_shards) == self.shard_id
            batch = {k: v[keep] for k, v in batch.items()}
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


# --------------------------------------------------------------------------
# Non-stationary traffic: piecewise phase schedules over the stationary kinds
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DriftPhase:
    """One stationary segment of a :class:`DriftScenario` schedule."""

    kind: str = "protocol-mix"
    batches: int = 8  # phase length, in next_batch calls
    label_probs: Optional[Tuple[float, ...]] = None
    anomaly_rate: Optional[float] = None  # overrides the kind's knob
    sig_rotation: int = 0  # > 0: rotated (adversarial) anomaly signature


def label_ramp(
    start: Tuple[float, ...],
    end: Tuple[float, ...],
    n_phases: int,
    batches_per_phase: int,
    kind: str = "protocol-mix",
    **phase_kwargs,
) -> Tuple[DriftPhase, ...]:
    """A gradual label-distribution ramp as a piecewise-constant phase
    schedule: ``n_phases`` stationary segments whose class distributions
    linearly interpolate ``start`` → ``end``.  Keeping each segment
    stationary preserves the DriftScenario invariant that every phase slice
    equals a stationary :class:`FlowScenario` stream."""
    phases = []
    for i in range(n_phases):
        f = i / max(n_phases - 1, 1)
        p = np.asarray(start, np.float64) * (1 - f) + np.asarray(end, np.float64) * f
        phases.append(DriftPhase(
            kind=kind, batches=batches_per_phase,
            label_probs=tuple(p / p.sum()), **phase_kwargs,
        ))
    return tuple(phases)


def parse_phases(spec: str) -> Tuple[DriftPhase, ...]:
    """Parse a CLI phase schedule: comma-separated
    ``kind:batches[:sig_rotation[:anomaly_rate]]`` items, e.g.
    ``protocol-mix:6,rule-violating:8:1:0.6,heavy-churn:6:1``."""
    phases = []
    for item in spec.split(","):
        parts = item.strip().split(":")
        if not 2 <= len(parts) <= 4:
            raise ValueError(
                f"bad phase {item!r}; want kind:batches[:rot[:anomaly_rate]]"
            )
        # validate up front: a bad kind or non-positive length otherwise
        # surfaces batches later as a confusing DriftScenario/FlowScenario
        # failure far from the CLI flag that caused it
        kind = parts[0]
        if kind != "mix" and kind not in SCENARIO_KINDS:
            raise ValueError(
                f"unknown phase kind {kind!r} in {item!r}; "
                f"expected 'mix' or one of {sorted(SCENARIO_KINDS)}"
            )
        batches = int(parts[1])
        if batches <= 0:
            raise ValueError(
                f"phase batches must be >= 1, got {batches} in {item!r}"
            )
        phases.append(DriftPhase(
            kind=kind,
            batches=batches,
            sig_rotation=int(parts[2]) if len(parts) > 2 else 0,
            anomaly_rate=float(parts[3]) if len(parts) > 3 else None,
        ))
    return tuple(phases)


@dataclasses.dataclass
class DriftScenario:
    """Piecewise non-stationary packet arrivals: a schedule of stationary
    :class:`DriftPhase` segments over the :data:`SCENARIO_KINDS` generators,
    plus label-distribution ramps (see :func:`label_ramp`) and adversarial
    rule-violation surges (``sig_rotation`` phases whose anomaly signature
    the installed rules have never seen).

    Construction guarantees, all property-tested:

    * **Union = concatenation.**  The stream is *exactly* the concatenation
      of the stationary :class:`FlowScenario` streams returned by
      :meth:`stationary_phase` — each phase instance runs a fresh stationary
      generator with a disjoint ``fid_base`` ID space (``instance << 32``)
      and a ``step`` offset continuing the global RNG schedule.  Drift
      enters only through *which* stationary process is active, never
      through hidden generator state.
    * **Sharding commutes with phasing.**  ``(shard_id, num_shards)`` is
      passed through to every phase generator, so the per-shard streams
      partition each batch by :func:`flow_shard` owner and their union is
      the unsharded stream — across phase boundaries too.
    * **Repeats.**  The schedule cycles (phase instance ``len(phases)`` is
      phase 0 again, with fresh flow IDs and fresh arrivals), so the stream
      is infinite like every other pipeline generator.

    At a phase boundary the previous phase's still-active flows simply stop
    transmitting (the serving engine's idle eviction reclaims them) — the
    flow-churn signature of a real traffic shift.
    """

    phases: Tuple[DriftPhase, ...] = (DriftPhase(),)
    n_classes: int = 8
    vocab_size: int = 512
    pkt_len: int = 16
    packets_per_batch: int = 256
    seed: int = 0
    hard_mode: bool = False
    max_flow_pkts: int = 64
    max_active: int = 8192
    shard_id: int = 0
    num_shards: int = 1
    step: int = 0

    def __post_init__(self):
        self.phases = tuple(
            ph if isinstance(ph, DriftPhase) else DriftPhase(**ph)
            for ph in self.phases
        )
        if not self.phases:
            raise ValueError("DriftScenario needs at least one phase")
        for ph in self.phases:
            if ph.kind != "mix" and ph.kind not in SCENARIO_KINDS:
                raise ValueError(f"unknown phase kind {ph.kind!r}")
            if ph.batches < 1:
                raise ValueError(f"phase batches must be >= 1, got {ph.batches}")
            if ph.label_probs is not None and (
                len(ph.label_probs) != self.n_classes
            ):
                # phases instantiate lazily; surface bad label_probs now
                raise ValueError(
                    f"phase label_probs needs {self.n_classes} entries, "
                    f"got {len(ph.label_probs)}"
                )
        if not 0 <= self.shard_id < self.num_shards:
            raise ValueError(
                f"shard_id {self.shard_id} outside [0, {self.num_shards})"
            )
        starts = [0]
        for ph in self.phases:
            starts.append(starts[-1] + ph.batches)
        self._starts = starts  # len(phases) + 1; [-1] == batches per cycle
        self._current: Optional[FlowScenario] = None
        self._current_instance = -1
        self._done_spawned = 0
        self._done_retired = 0

    # ------------------------------------------------------------------
    @property
    def batches_per_cycle(self) -> int:
        return self._starts[-1]

    def _locate(self, step: int) -> Tuple[int, int]:
        """Global batch index -> (phase instance, instance start step)."""
        cycle, within = divmod(step, self.batches_per_cycle)
        i = max(j for j in range(len(self.phases)) if self._starts[j] <= within)
        return cycle * len(self.phases) + i, cycle * self.batches_per_cycle + self._starts[i]

    def phase_index(self, step: Optional[int] = None) -> int:
        """Index into ``phases`` active at batch ``step`` (default: now)."""
        s = self.step if step is None else step
        return self._locate(s)[0] % len(self.phases)

    def phase_at(self, step: Optional[int] = None) -> DriftPhase:
        return self.phases[self.phase_index(step)]

    def stationary_phase(self, instance: int) -> FlowScenario:
        """The stationary generator whose stream IS phase ``instance``'s
        slice of this scenario (the union-equals-concatenation witness)."""
        cycle, i = divmod(instance, len(self.phases))
        ph = self.phases[i]
        return FlowScenario(
            kind=ph.kind, n_classes=self.n_classes, vocab_size=self.vocab_size,
            pkt_len=self.pkt_len, packets_per_batch=self.packets_per_batch,
            seed=self.seed, hard_mode=self.hard_mode,
            max_flow_pkts=self.max_flow_pkts, max_active=self.max_active,
            shard_id=self.shard_id, num_shards=self.num_shards,
            fid_base=instance << 32,
            label_probs=ph.label_probs, anomaly_rate=ph.anomaly_rate,
            sig_rotation=ph.sig_rotation,
            step=cycle * self.batches_per_cycle + self._starts[i],
        )

    def phase_anomaly_signature(self, phase: int) -> np.ndarray:
        """The 4-token anomaly signature phase ``phase`` injects (rotated
        when the phase is an adversarial surge) — what a phase oracle's
        rules must match."""
        ph = self.phases[phase % len(self.phases)]
        if not ph.sig_rotation:
            return _traffic_tables(
                self.seed, self.n_classes, self.vocab_size, self.hard_mode
            )[3]
        return _rng(self.seed, 0xA51, ph.sig_rotation).integers(
            256, self.vocab_size, size=(4,)
        )

    @property
    def anomaly_signature(self) -> np.ndarray:
        """Signature of the phase active now (matches FlowScenario's API)."""
        return self.phase_anomaly_signature(self.phase_index())

    @property
    def active_flows(self) -> int:
        return self._current.active_flows if self._current else 0

    @property
    def flows_spawned(self) -> int:
        cur = self._current.flows_spawned if self._current else 0
        return self._done_spawned + cur

    @property
    def flows_retired(self) -> int:
        cur = self._current.flows_retired if self._current else 0
        return self._done_retired + cur

    # ------------------------------------------------------------------
    def next_batch(self) -> Dict[str, np.ndarray]:
        instance, _ = self._locate(self.step)
        if instance != self._current_instance:
            if self._current is not None:
                self._done_spawned += self._current.flows_spawned
                self._done_retired += self._current.flows_retired
            self._current = self.stationary_phase(instance)
            self._current_instance = instance
        batch = self._current.next_batch()
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
