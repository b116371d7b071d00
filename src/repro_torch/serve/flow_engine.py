"""Flow-table streaming inference runtime (port of ``repro.serve.flow_engine``).

A flow-keyed table maps flow IDs to bounded per-flow Chimera state — the
Eq. 11/13 decode state plus the streaming classifier aggregates (running
sum of hidden states, cumulative packed marker signature, sticky TCAM veto
bit).  ``ingest(flow_ids, tokens)`` resolves slots on the host, splits the
batch into arrival rounds (same-flow packets serialized, distinct flows
vectorized) and runs one flow step per round of ``lanes`` packets:

1. gather the touched rows (lazily zeroing freshly allocated slots),
2. decode each packet token through :func:`repro_torch.models.model
   .decode_hidden_step` (the ``decode_step`` kernel per layer and token),
3. OR the packet's marker signature into the row,
4. score with :func:`repro_torch.train.classifier.streaming_scores` (the
   ``flow_score`` kernel): heads, TCAM match, sticky veto, Eq. 15 fusion,
5. scatter the rows back.

A hard TCAM hit marks the flow vetoed for its lifetime and pins trust to
1.0.  State is bounded per flow by construction and table-wide by the
byte budget, with LRU and idle eviction keeping the resident set inside
``capacity``.

With ``FlowEngineConfig(fused=True)`` a batch takes the fused path
instead (:meth:`FlowEngine._dispatch_fused`): its arrival rounds are packed
into width-bucketed chunk stacks (:func:`pack_width_groups`), and each chunk
runs the same flow step at its own power-of-two width, in chunk order, on
the resident table.  On the card every width is one CUDA graph of the whole
step (:mod:`repro_torch.kernels.flow_ingest.fused`), replayed once per
chunk; on the CPU the same structure runs eagerly
(:func:`make_fused_ingest`).  :class:`repro_torch.serve.ingest_pipeline
.AsyncIngestPipeline` overlaps the host's packing of one batch with the
card's work on the one before.

Under the ``int-emulation`` backend the score stage is the integer
lowering of :mod:`repro_torch.compile.int_lowering`: each decoded feature
is quantized at the Map boundary, the row keeps an int32 ``hidden_sum``,
and the ``int_flow_score`` kernel scores it; its outputs are dequantized
for the engine's float contract.  A program that does not lower within
the 32-bit budget is refused at construction (``BudgetError``).

:meth:`FlowEngine.swap_tables` installs new rule tables between ticks:
it rewrites the installed tensors in place, since the fused engine's CUDA
graphs read them at the addresses they were captured with.

Ported: the per-round and fused paths, both score backends, eviction,
``reset``, ``flow_scores``, ``swap_tables``, the deploy surface
(:mod:`repro_torch.serve.deploy`) and the state accounting.  The sharded
engine is :mod:`repro_torch.serve.sharded_flow_engine`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Collection, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compile import int_lowering as il
from repro_torch.compile.ledger import ResourceLedger
from repro_torch.compile.passes import INT_BACKEND, check_backend
from repro_torch.core import hardware_model
from repro_torch.core import symbolic
from repro_torch.core.chimera_attention import ChimeraState
from repro_torch.core.hardware_model import DEFAULT_DATAPLANE
from repro_torch.core.two_timescale import atomic_swap, measure_install_time
from repro_torch.data.pipeline import arrival_rounds, flow_shard
from repro_torch.kernels.flow_ingest import fused as fused_mod
from repro_torch.kernels.flow_ingest import int_ops
from repro_torch.models import model as M
from repro_torch.train import classifier as C


@dataclasses.dataclass(frozen=True)
class FlowEngineConfig:
    capacity: int = 4096  # max resident flows (table entries)
    lanes: int = 256  # batch width per arrival round (padded, fixed)
    state_budget_bytes: int = 0  # 0 → DataplaneSpec shared-SRAM default
    idle_timeout: int = 0  # ticks without traffic before eviction (0 = off)
    t_cp_s: float = 0.0  # control-plane epoch for Eq. 18 checks (0 = off)
    backend: Optional[str] = None  # score backend: None/"xla"/... float, "int-emulation"
    horizon: int = 1024  # Eq. 39 flow-length horizon (int-emulation lowering)
    fused: bool = False  # fused ingest: width-bucketed chunks, a CUDA graph per width
    min_chunk_lanes: int = 8  # smallest padded width for tail arrival rounds
    ring_slots: int = 4  # host staging-ring depth (AsyncIngestPipeline)


@dataclasses.dataclass
class FlowStats:
    packets: int = 0
    tokens: int = 0
    ticks: int = 0
    rounds: int = 0
    flows_created: int = 0
    flows_evicted_lru: int = 0
    flows_evicted_idle: int = 0

    @property
    def flows_evicted(self) -> int:
        return self.flows_evicted_lru + self.flows_evicted_idle

    @property
    def eviction_rate(self) -> float:
        """Evictions per engine tick — the flow-churn pressure metric."""
        return self.flows_evicted / max(self.ticks, 1)


@dataclasses.dataclass(frozen=True)
class SwapRecord:
    tick: int
    install_s: float  # measured wall-clock install (device-ready, Eq. 18)
    churn_ok: bool  # Eq. 18: install completed within the control epoch
    t_cp_s: float = 0.0  # the control-plane epoch the install was held to
    source: str = "manual"  # "manual" | "delta" (audited ProgramDelta)


class CaptureKeys:
    """One entry point of an engine for the graph-capture sentry
    (:class:`repro_torch.analysis.retrace_sentry.RetraceSentry`): the
    ``(width, pkt_len)`` keys its flow step has been captured or run at.

    On the card the fused engine's keys are its captured CUDA graphs
    (:meth:`FlowEngine.fused_graphs`): a new key is a capture, the port's
    counterpart of a retrace.  On the CPU nothing is captured, so the same
    entry point counts the keys the step has run at, the keys the card's
    graphs would be captured under.  The per-round step runs eagerly on
    both; its key is its launch shape, ``(num_shards * lanes, pkt_len)``."""

    def __init__(self, keys: Callable[[], Collection[Tuple[int, int]]]):
        self._keys = keys

    def capture_count(self) -> int:
        return len(self._keys())


def _state_leaves(caches) -> List[torch.Tensor]:
    return [t for st in caches.values() for t in st.leaves()]


def make_flow_step(ccfg: C.ClassifierConfig, n_slots: int, int_plan=None, *, score_fn=None):
    """Build the flow-table update step over ``n_slots`` table rows.

    ``step(params, rules, caches, positions, sig, hidden_sum, vetoed, idx,
    tokens, fresh) -> outputs`` updates the table tensors in place.
    ``score_fn(params, rules, pooled, sig, sticky) -> (outputs, new_sticky)``
    replaces the score stage; ``None`` keeps :func:`repro_torch.train
    .classifier.streaming_scores`.

    With an :class:`~repro_torch.compile.int_lowering.IntScorePlan` the
    score stage is the integer program (``int-emulation``): each decoded
    feature is quantized at the Map boundary, ``hidden_sum`` is the int32
    accumulator, ``rules`` is ``(rules, int_tables)``, and ``score_fn(
    int_tables, rules, hidden_sum, count, sig, sticky)`` returns quantized
    outputs (``None`` keeps the ``int_flow_score`` kernel's wrapper), which
    the step dequantizes.  The backbone is the float path either way.
    """
    arch = ccfg.arch
    if int_plan is not None:
        if score_fn is None:
            score_fn = fused_mod.make_int_score_fn(int_plan)
    elif score_fn is None:
        def score_fn(params, rules, pooled, sig, sticky):
            return C.streaming_scores(ccfg, params, rules, pooled, sig, sticky)

    def take(c, idx, fresh):
        # gather the touched rows; zero lanes holding newly-allocated flows
        # (slot reuse after eviction must look like a fresh table entry)
        f = fresh.reshape((1, -1) + (1,) * (c.ndim - 2))
        return torch.where(f, torch.zeros((), dtype=c.dtype, device=c.device), c[:, idx])

    def step(params, rules, caches, positions, sig, hidden_sum, vetoed, idx, tokens, fresh):
        cs = {
            name: ChimeraState(*(take(t, idx, fresh) for t in st.leaves()))
            for name, st in caches.items()
        }
        pos = torch.where(fresh, 0, positions[idx])
        sg = torch.where(fresh[:, None], 0, sig[idx])
        hs = torch.where(fresh[:, None], 0, hidden_sum[idx])
        vt = torch.where(fresh, False, vetoed[idx])

        for t in range(tokens.shape[1]):
            h = M.decode_hidden_step(arch, params["backbone"], tokens[:, t], pos, cs)
            pos = pos + 1
            if int_plan is not None:  # the one float->int crossing (Map stage)
                hs = hs + il.quantize_features(int_plan, h)
            else:
                hs = hs + h.float()
        sg = sg | C.packet_signature(ccfg, tokens)
        if int_plan is not None:
            rule_set, int_tables = rules
            out, vt = score_fn(int_tables, rule_set, hs, pos, sg, vt)
            out = il.dequantize_scores(int_plan, out)  # the engine's float contract
        else:
            pooled = hs / torch.clamp(pos, min=1)[:, None].float()
            out, vt = score_fn(params, rules, pooled, sg, vt)
        out["sig"] = sg  # cumulative signature after this packet

        for big, small in zip(_state_leaves(caches), _state_leaves(cs)):
            big[:, idx] = small
        positions[idx] = pos
        sig[idx] = sg
        hidden_sum[idx] = hs
        vetoed[idx] = vt
        return out

    return step


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def pack_width_groups(
    slots: np.ndarray, lanes: int, min_lanes: int = 8
) -> List[Tuple[int, List[np.ndarray]]]:
    """Pre-pack arrival rounds into width-bucketed chunk groups.

    Each round is split into chunks of at most ``lanes`` packets, each chunk
    gets the smallest power-of-two width that holds it (clamped to
    ``[min_lanes, lanes]``), and *consecutive* chunks sharing a width are
    grouped.  Order across groups preserves round order: round r + 1 of a
    flow always runs after round r (consecutive rounds can never merge:
    every flow in round r + 1 also appears in round r).

    Returns ``[(width, [packet-index arrays])]``.
    """
    groups: List[Tuple[int, List[np.ndarray]]] = []
    for round_lanes in arrival_rounds(list(slots)):
        for c0 in range(0, len(round_lanes), lanes):
            ch = np.asarray(round_lanes[c0 : c0 + lanes], np.intp)
            w = min(lanes, _next_pow2(max(len(ch), min_lanes)))
            if groups and groups[-1][0] == w:
                groups[-1][1].append(ch)
            else:
                groups.append((w, [ch]))
    return groups


def make_fused_ingest(ccfg: C.ClassifierConfig, n_slots: int, int_plan=None, *,
                      score_fn=None):
    """Build the fused ingest step over a stack of chunks.

    ``fused(params, rules, caches, positions, sig, hidden_sum, vetoed,
    idx (C, w), tokens (C, w, pkt_len), fresh (C, w)) -> outs`` runs the
    :func:`make_flow_step` body once per chunk, in chunk order, on the
    resident table (updated in place), and stacks the per-chunk score
    outputs on a leading C axis.  ``int_plan`` and ``score_fn`` are the
    step's (:func:`make_flow_step`).  The JAX package pads the chunk axis to
    a power-of-two bucket and passes the chunk count as a traced scalar,
    which bounds its traces;
    here the step runs exactly the C chunks it is given, eagerly, and on
    the card :class:`repro_torch.kernels.flow_ingest.fused.FlowStepGraphs`
    replays one CUDA graph of the same body per chunk.
    """
    step = make_flow_step(ccfg, n_slots, int_plan, score_fn=score_fn)

    def fused(params, rules, caches, positions, sig, hidden_sum, vetoed, idx, tokens, fresh):
        outs = [
            step(params, rules, caches, positions, sig, hidden_sum, vetoed,
                 idx[j], tokens[j], fresh[j])
            for j in range(idx.shape[0])
        ]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return fused


# columns of a packed result row: trust, s_nn and s_sym as float32 bit
# patterns, the veto bit, the predicted class, then the signature words
_RESULT_FIXED = 5


def pack_step_outputs(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A flow step's outputs (leading dims ``...``) as one int32 tensor
    ``(..., 5 + sig_words)``: one device-to-host copy carries a batch."""
    floats = torch.stack([out["trust"], out["s_nn"], out["s_sym"]], dim=-1)
    return torch.cat([
        floats.view(torch.int32),
        out["hard_hit"].to(torch.int32)[..., None],
        torch.argmax(out["class_logits"], -1).to(torch.int32)[..., None],
        out["sig"],
    ], dim=-1)


def unpack_step_outputs(res: np.ndarray) -> Dict[str, np.ndarray]:
    """Host rows ``(n, 5 + sig_words)`` of :func:`pack_step_outputs` as the
    per-packet arrays ``ingest`` returns (all but ``flow_ids``)."""
    floats = np.ascontiguousarray(res[:, :3]).view(np.float32)
    return {
        "trust": floats[:, 0].copy(),
        "vetoed": res[:, 3] != 0,
        "pred": res[:, 4].copy(),
        "s_nn": floats[:, 1].copy(),
        "s_sym": floats[:, 2].copy(),
        "sig": np.ascontiguousarray(res[:, _RESULT_FIXED:]).view(np.uint32),
    }


class _PendingIngest:
    """A dispatched fused batch whose results may still be in flight.

    :meth:`FlowEngine._dispatch_fused` returns one of these before anything
    waits for the card; the batch's results travel in one device-to-host
    copy into pinned memory, enqueued behind its replays, and ``event``
    completes with it.  :meth:`finalize` waits for that event and unpacks
    the rows into the per-packet dict ``ingest`` returns.
    """

    def __init__(self, flow_ids, n_packets: int, result: torch.Tensor, event, layout):
        self.flow_ids = flow_ids
        self.n_packets = n_packets
        self.result = result  # host (rows, 5 + sig_words) int32
        self.event = event  # None on the CPU, where the result is ready
        self.layout = layout  # [(first row, width, [chunk packet-index arrays])]
        self._out: Optional[Dict[str, np.ndarray]] = None

    def packet_rows(self) -> np.ndarray:
        """Each packet's row in the result."""
        rows = np.empty((self.n_packets,), np.intp)
        for r0, w, chunks in self.layout:
            for j, ch in enumerate(chunks):
                rows[ch] = r0 + j * w + np.arange(len(ch))
        return rows

    def finalize(self) -> Dict[str, np.ndarray]:
        if self._out is not None:
            return self._out
        if self.event is not None:
            self.event.synchronize()
        self._out = {"flow_ids": self.flow_ids,
                     **unpack_step_outputs(self.result.numpy()[self.packet_rows()])}
        self.result = None  # the pinned buffer can go back to its allocator
        return self._out


class FlowTableDirectory:
    """Host-side slot allocator for one flow table: fid → slot map, free
    list, LRU timestamps.  Owns no device state."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.slot_of: Dict[int, int] = {}
        self.fid_of: Dict[int, int] = {}
        self.free: List[int] = list(range(capacity - 1, -1, -1))
        self.last_seen = np.full((capacity,), np.iinfo(np.int64).max, np.int64)

    @property
    def resident(self) -> int:
        return len(self.slot_of)

    def touch(self, fid: int, tick: int) -> bool:
        """Refresh a resident flow's LRU stamp; False if not resident."""
        slot = self.slot_of.get(fid)
        if slot is None:
            return False
        self.last_seen[slot] = tick
        return True

    def slot_for(self, fid: int, tick: int) -> Tuple[int, bool, bool]:
        """Resolve ``fid`` to a table slot, allocating (free list, else LRU
        victim) when absent.  Returns ``(slot, fresh, lru_evicted)``."""
        slot = self.slot_of.get(fid)
        if slot is not None:
            self.last_seen[slot] = tick
            return slot, False, False
        evicted = False
        if self.free:
            slot = self.free.pop()
        else:
            slot = int(np.argmin(self.last_seen))  # LRU victim
            del self.slot_of[self.fid_of[slot]]
            evicted = True
        self.slot_of[fid] = slot
        self.fid_of[slot] = fid
        self.last_seen[slot] = tick
        return slot, True, evicted

    def evict(self, fid: int) -> bool:
        slot = self.slot_of.pop(fid, None)
        if slot is None:
            return False
        del self.fid_of[slot]
        self.last_seen[slot] = np.iinfo(np.int64).max
        self.free.append(slot)
        return True

    def idle_victims(self, horizon: int) -> List[int]:
        """Flows whose last packet predates ``horizon`` (exclusive)."""
        return [f for f, s in self.slot_of.items() if self.last_seen[s] < horizon]

    def reset(self) -> None:
        self.slot_of.clear()
        self.fid_of.clear()
        self.free = list(range(self.capacity - 1, -1, -1))
        self.last_seen[:] = np.iinfo(np.int64).max


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def resolve_swap(
    old: symbolic.RuleSet,
    ruleset: Optional[symbolic.RuleSet],
    weights,
    weight_spec,
    delta,
) -> Tuple[symbolic.RuleSet, str]:
    """Resolve a ``swap_tables`` request into the RuleSet to install.

    Accepts raw tables (``ruleset`` and/or ``weights`` — float, or a
    quantized Eq. 19 SRAM table with its ``FixedPointSpec``) or an audited
    :class:`repro_torch.compile.ProgramDelta`, and checks the result's
    shapes and dtypes against the installed tables: an install rewrites the
    installed tensors, so it cannot change them.  Returns ``(new, source)``.
    """
    source = "manual"
    if delta is not None:
        if ruleset is not None or weights is not None:
            raise ValueError("pass either a ProgramDelta or raw tables, not both")
        ruleset = delta.ruleset
        weights, weight_spec = delta.weight_table, delta.weight_spec
        source = "delta"
    new = ruleset if ruleset is not None else old
    if weights is not None:
        w = (
            symbolic.decompile_table(torch.as_tensor(weights), weight_spec)
            if weight_spec is not None
            else torch.as_tensor(weights, dtype=torch.float32)
        )
        new = symbolic.RuleSet(values=new.values, masks=new.masks,
                               weights=w.to(torch.float32), hard=new.hard)
    for name, a, b in zip(("values", "masks", "weights", "hard"), old.tensors(), new.tensors()):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(
                f"swap_tables: {name} {tuple(b.shape)}/{b.dtype} does not match "
                f"installed {tuple(a.shape)}/{a.dtype}; a shape-changing install "
                f"needs a new engine"
            )
    return new, source


def _engine_kwargs_from_program(program, backend: Optional[str] = None) -> Dict:
    """The constructor inputs the deploy paths share: the program's compiled
    classifier config, parameters and packed rules, plus the score backend
    (the program's unless the deployment site overrides it)."""
    return {
        "ccfg": program.ccfg,
        "params": program.params,
        "rules": program.rules,
        "backend": backend if backend is not None else program.backend,
    }


class TableEngine:
    """What the single and the sharded engine share: the control plane (the
    weights, the installed rules, the int-emulation lowering, ``swap_tables``),
    the flow tables and the per-round ingest over them.

    There are ``num_shards`` tables of ``capacity + 1`` rows each (the
    scratch row absorbs padding lanes), with one host directory per table.
    The Eq. 11 budget check holds per table and is made before any table is
    allocated.  The flow step sees every table's rows on one axis
    (:meth:`flat_tables`), table ``s`` at rows ``s * (capacity + 1)`` on; the
    single engine is the case of one table.  ``shard_axis`` is the leading
    axis of the aux tensors (``positions``, ``sig``, ``hidden_sum``,
    ``vetoed``): none on the single engine, ``(num_shards,)`` on the sharded
    one.  ``who`` names the entry point in the error raised for a CUDA
    device without a GPU."""

    def __init__(self, ccfg: C.ClassifierConfig, params, rules: symbolic.RuleSet,
                 fcfg: FlowEngineConfig, device, who: str, shard_axis: Tuple[int, ...] = ()):
        self.device = device = resolve_device(device, who)
        self.backend = check_backend(fcfg.backend)
        self.ccfg = ccfg
        self.fcfg = fcfg
        self.stats = FlowStats()
        self.swap_history: List[SwapRecord] = []
        self.program = None  # set by the deploy surface
        self.params = _to_device(params, device)
        # the engine owns its installed tables (swaps rewrite them in place)
        self.rules = symbolic.RuleSet(*(t.to(device).clone() for t in rules.tensors()))

        # int-emulation: lower the score path to fixed point.  The plan is a
        # pure function of (ccfg, params, rules, horizon); a lowering over
        # the 32-bit budget raises BudgetError here, before any allocation
        self._int_plan = None
        self._int_tables = None
        self._int_entries: List = []
        if self.backend == INT_BACKEND:
            self._int_plan, self._int_tables, self._int_entries = il.lower_scores(
                ccfg, self.params, self.rules, horizon=fcfg.horizon
            )
            deploy_ledger = ResourceLedger()
            deploy_ledger.extend(self._int_entries)
            deploy_ledger.raise_if_over()

        # capacity real slots + one scratch slot that absorbs padding lanes
        self._n_slots = fcfg.capacity + 1
        W, d = ccfg.sig_words, ccfg.arch.d_model
        self._shapes = {
            "positions": ((self._n_slots,), torch.int32),
            "sig": ((self._n_slots, W), torch.int32),
            "hidden_sum": ((self._n_slots, d),
                           torch.float32 if self._int_plan is None else torch.int32),
            "vetoed": ((self._n_slots,), torch.bool),
        }

        # Eq. 11 budget check before anything is allocated; it covers
        # everything the table holds (capacity entries + the scratch lane)
        budget = fcfg.state_budget_bytes or DEFAULT_DATAPLANE.sram_total_bits // 8
        self.state_budget_bytes = budget
        hardware_model.check_flow_table_budget(
            self._n_slots, self.per_flow_state_bytes(), budget
        )

        # fp32 Chimera state whatever the residual stream's dtype, as the
        # reference engine keeps it (the decode_step kernel takes fp32 only);
        # the caches keep the model's stacked layer axis in front, then every
        # table's rows: (groups, num_shards * (capacity + 1), ...)
        self.num_shards = S = int(np.prod(shard_axis, dtype=np.int64))
        self.caches = M.init_caches(ccfg.arch, S * self._n_slots, dtype=torch.float32,
                                    device=device)
        for name, (shape, dtype) in self._shapes.items():
            setattr(self, name, torch.zeros(tuple(shard_axis) + shape, dtype=dtype,
                                            device=device))
        # allocation, LRU and idle eviction are table-local: a flow competes
        # for slots only within its shard
        self.tables = [FlowTableDirectory(fcfg.capacity) for _ in range(S)]
        self._tick = 0
        self._step = make_flow_step(ccfg, S * self._n_slots, self._int_plan)
        self._step_keys: Set[Tuple[int, int]] = set()  # (width, pkt_len) run at

    def capture_entry_points(self) -> Dict[str, CaptureKeys]:
        """Named entry points for the graph-capture sentry (the counterpart
        of the JAX package's ``jit_entry_points``): the per-round step."""
        return {"step": CaptureKeys(lambda: self._step_keys)}

    def _step_rules(self):
        """The ``rules`` argument of the flow step: the installed RuleSet,
        paired with the lowered int tables under int-emulation."""
        if self._int_plan is not None:
            return (self.rules, self._int_tables)
        return self.rules

    def per_flow_state_bytes(self) -> int:
        """Bytes of one flow-table entry: Chimera decode state (S, Z, ring
        buffers, fill count) + classifier aggregates (signature words,
        pooled-feature accumulator, counters, veto bit) + the host LRU stamp."""
        meta = M.init_caches(self.ccfg.arch, self._n_slots, dtype=torch.float32, device="meta")
        cache_bytes = sum(
            t.numel() * t.element_size() // self._n_slots for t in _state_leaves(meta)
        )
        aux = sum(
            int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            for shape, dtype in self._shapes.values()
        ) // self._n_slots
        return cache_bytes + aux + 8

    def flat_tables(self):
        """The table tensors as the flow step takes them: every table's rows
        on one axis, ``num_shards * (capacity + 1)`` long (views, written in
        place)."""
        N = self.num_shards * self._n_slots
        return (self.caches, self.positions.view(N), self.sig.view(N, -1),
                self.hidden_sum.view(N, -1), self.vetoed.view(N))

    def shard_of(self, fid: int) -> int:
        """Owner shard of a flow ID (deterministic, batch-independent)."""
        return int(flow_shard([fid], self.num_shards)[0])

    def _row_of(self, fid: int) -> int:
        """A resident flow's row in :meth:`flat_tables`."""
        s = self.shard_of(fid)
        return s * self._n_slots + self.tables[s].slot_of[fid]

    @property
    def resident_flows(self) -> int:
        return sum(t.resident for t in self.tables)

    def flow_ids(self) -> List[int]:
        return [f for t in self.tables for f in t.slot_of]

    # ------------------------------------------------------------------
    # flow-table bookkeeping (host side)
    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Clear the flow tables.  Device state is not rewritten: reused
        slots are lazily zeroed by the per-lane ``fresh`` flag."""
        for t in self.tables:
            t.reset()
        self._tick = 0
        self.stats = FlowStats()

    def evict(self, fid: int) -> bool:
        """Drop a flow's table entry (state is lazily zeroed on slot reuse)."""
        return self.tables[self.shard_of(fid)].evict(fid)

    def evict_idle(self) -> int:
        """Evict flows idle for more than ``idle_timeout`` ticks."""
        if not self.fcfg.idle_timeout:
            return 0
        horizon = self._tick - self.fcfg.idle_timeout
        n = 0
        for t in self.tables:
            for fid in t.idle_victims(horizon):
                t.evict(fid)
                self.stats.flows_evicted_idle += 1
                n += 1
        return n

    def _resolve_slots(self, flow_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host bookkeeping for one batch: tick, LRU touch, idle sweep, slot
        assignment in the owner shard's table.  Returns each packet's row in
        :meth:`flat_tables` and its ``fresh`` flag."""
        self._tick += 1
        self.stats.ticks += 1
        pairs = list(zip(flow_ids.tolist(), flow_shard(flow_ids, self.num_shards).tolist()))
        # touch every already-resident flow in this batch BEFORE the idle
        # sweep and any allocation, so eviction victims come from flows with
        # no packets pending here
        for fid, own in pairs:
            self.tables[own].touch(fid, self._tick)
        self.evict_idle()

        rows = np.empty((len(pairs),), np.int64)
        fresh = np.zeros((len(pairs),), bool)
        for i, (fid, own) in enumerate(pairs):
            slot, fr, evicted = self.tables[own].slot_for(fid, self._tick)
            rows[i], fresh[i] = own * self._n_slots + slot, fr
            if fr:
                self.stats.flows_created += 1
            if evicted:
                self.stats.flows_evicted_lru += 1
        return rows, fresh

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def ingest(self, flow_ids: np.ndarray, tokens: np.ndarray) -> Dict[str, np.ndarray]:
        """Stream one batch of packet arrivals through the flow tables.

        ``flow_ids`` (P,) int — flow keys in arrival order (repeats allowed);
        ``tokens`` (P, pkt_len) int.  Returns per-packet numpy outputs aligned
        with the input order: ``trust``, ``vetoed``, ``pred``, ``s_nn``,
        ``s_sym`` and ``sig`` (uint32 words) after each flow's packet.
        Same-flow packets are serialized, distinct flows vectorized.
        """
        flow_ids = np.asarray(flow_ids)
        tokens = np.asarray(tokens, np.int32)
        P, _ = tokens.shape
        assert flow_ids.shape == (P,), (flow_ids.shape, P)
        rows, fresh = self._resolve_slots(flow_ids)
        if self.fcfg.fused:  # the single engine only: the sharded one refuses it
            return self._dispatch_fused(flow_ids, tokens, rows, fresh).finalize()
        return self._ingest_rounds(flow_ids, tokens, rows, fresh)

    def _ingest_rounds(
        self, flow_ids: np.ndarray, tokens: np.ndarray,
        rows: np.ndarray, fresh: np.ndarray,
    ) -> Dict[str, np.ndarray]:
        """One flow step per arrival round over every table: each shard's
        arrival rounds are cut into chunks of at most ``lanes``, and launch
        ``k`` carries chunk ``k`` of every shard, ``lanes`` lanes per shard
        (width ``num_shards * lanes``), each shard's unused lanes at its
        scratch row.  One device-to-host copy per launch brings back every
        shard's outputs."""
        P, pkt_len = tokens.shape
        S, lanes, n_slots = self.num_shards, self.fcfg.lanes, self._n_slots
        owners = rows // n_slots
        per_shard: List[List[np.ndarray]] = []
        for s in range(S):
            pkt_idx = np.nonzero(owners == s)[0]
            chunks = []
            for round_lanes in arrival_rounds(rows[pkt_idx].tolist()):
                sel = pkt_idx[round_lanes]
                chunks += [sel[c0 : c0 + lanes] for c0 in range(0, len(sel), lanes)]
            per_shard.append(chunks)
        n_steps = max((len(c) for c in per_shard), default=0)

        scratch = np.arange(S, dtype=np.int64)[:, None] * n_slots + self.fcfg.capacity
        if n_steps:
            self._step_keys.add((S * lanes, pkt_len))
        res_rows = np.empty((P, _RESULT_FIXED + self.ccfg.sig_words), np.int32)
        dev = self.device
        for k in range(n_steps):
            idx = np.repeat(scratch, lanes, axis=1)  # every lane at its shard's scratch row
            tok = np.zeros((S, lanes, pkt_len), np.int64)
            fr = np.zeros((S, lanes), bool)
            lane_of = []
            for s, chunks in enumerate(per_shard):
                if k < len(chunks):
                    sel = chunks[k]
                    n = len(sel)
                    idx[s, :n] = rows[sel]
                    tok[s, :n] = tokens[sel]
                    fr[s, :n] = fresh[sel]
                    lane_of.append((sel, s * lanes + np.arange(n)))
            out = self._step(
                self.params, self._step_rules(), *self.flat_tables(),
                torch.from_numpy(idx.reshape(-1)).to(dev),
                torch.from_numpy(tok.reshape(S * lanes, pkt_len)).to(dev),
                torch.from_numpy(fr.reshape(-1)).to(dev),
            )
            self.stats.rounds += 1
            res = pack_step_outputs(out).cpu().numpy()
            for sel, lane in lane_of:
                res_rows[sel] = res[lane]
        self.stats.packets += P
        self.stats.tokens += P * pkt_len
        return {"flow_ids": flow_ids, **unpack_step_outputs(res_rows)}

    # ------------------------------------------------------------------
    # per-flow snapshot
    # ------------------------------------------------------------------
    def flow_scores(self, fid: int) -> Dict[str, float]:
        """Current scores for a resident flow (control-plane read path; reads
        the owner shard's row)."""
        r = self._row_of(fid)
        _, positions, sig, hidden_sum, vetoed = self.flat_tables()
        pos = positions[r]
        hs, sg, vt = hidden_sum[r][None], sig[r][None], vetoed[r][None]
        if self._int_plan is not None:
            out, _ = int_ops.int_flow_score(self._int_plan, self._int_tables, self.rules,
                                            hs, pos[None], sg, vt)
            out = il.dequantize_scores(self._int_plan, out)
        else:
            pooled = hs / torch.clamp(pos, min=1).float()
            out, _ = C.streaming_scores(self.ccfg, self.params, self.rules, pooled, sg, vt)
        return {
            "trust": float(out["trust"][0]),
            "vetoed": bool(out["hard_hit"][0]),
            "pred": int(torch.argmax(out["class_logits"][0])),
            "s_nn": float(out["s_nn"][0]),
            "s_sym": float(out["s_sym"][0]),
            "tokens": int(pos),
        }

    # ------------------------------------------------------------------
    # two-timescale control-plane hook
    # ------------------------------------------------------------------
    def swap_tables(
        self,
        ruleset: Optional[symbolic.RuleSet] = None,
        weights=None,
        weight_spec=None,
        delta=None,
    ) -> SwapRecord:
        """Install new compiled tables between ticks (§3.6).

        ``ruleset`` replaces the whole TCAM/SRAM rule table; ``weights``
        only the soft-rule weight column — a float array, or a quantized
        SRAM table with its ``FixedPointSpec`` as ``weight_spec``; ``delta``
        installs an audited :class:`repro_torch.compile.ProgramDelta`.
        Shapes and dtypes must match the installed tables.

        The new tables are copied into the installed tensors, on the
        engine's stream: behind every step already launched, a batch that
        :class:`AsyncIngestPipeline` has in flight included, and read by the
        fused engine's graphs at their captured addresses.  Under
        int-emulation the weight column is re-lowered at the installed
        plan's LSB as part of the install.  A sharded engine's shards all
        read the one installed copy, so one install covers every shard.  The
        install is timed until the card has the tables (Eq. 18), and the
        record flags an install slower than ``t_cp_s``.
        """
        new, source = resolve_swap(self.rules, ruleset, weights, weight_spec, delta)

        def _install():
            atomic_swap(self.rules, new)
            if self._int_plan is not None:
                atomic_swap(self._int_tables["rule_w"],
                            il.requantize_rule_weights(self._int_plan, self.rules.weights))
            return self._step_rules()

        dt = measure_install_time(_install)
        t_cp = self.fcfg.t_cp_s
        rec = SwapRecord(
            tick=self._tick, install_s=dt,
            churn_ok=hardware_model.install_time_ok(dt, t_cp) if t_cp else True,
            t_cp_s=t_cp, source=source,
        )
        self.swap_history.append(rec)
        return rec


class FlowEngine(TableEngine):
    """Streaming per-flow classification over a bounded flow table.

    ``device=None`` means ``"cuda"``; without a GPU the constructor raises.
    With ``fcfg.fused`` on the card, the fused path runs only through
    captured CUDA graphs: a failed capture or replay raises.
    """

    def __init__(
        self,
        ccfg: C.ClassifierConfig,
        params,
        rules: symbolic.RuleSet,
        fcfg: FlowEngineConfig = FlowEngineConfig(),
        device=None,
    ):
        super().__init__(ccfg, params, rules, fcfg, device, "FlowEngine")
        device, plan = self.device, self._int_plan
        self.table = self.tables[0]

        # fused ingest: the flow step with a score kernel as its score stage
        # (flow_score, or int_flow_score under int-emulation), one CUDA graph
        # per width on the card, eager on the CPU
        self._staging: Dict[Tuple[int, int, int, int], torch.Tensor] = {}
        self._graphs: Optional[fused_mod.FlowStepGraphs] = None
        self._fused_eager = None
        self._fused_keys: Set[Tuple[int, int]] = set()  # the CPU's: (width, pkt_len) run at
        if fcfg.fused:
            score_fn = (fused_mod.make_score_fn(ccfg) if plan is None
                        else fused_mod.make_int_score_fn(plan))
            if device.type == "cuda":
                step = make_flow_step(ccfg, self._n_slots, plan, score_fn=score_fn)
                self._graphs = fused_mod.FlowStepGraphs(
                    lambda *a: pack_step_outputs(step(*a)), self._table_args(),
                    scratch=fcfg.capacity, device=device,
                )
            else:
                self._fused_eager = make_fused_ingest(ccfg, self._n_slots, plan,
                                                      score_fn=score_fn)

    @classmethod
    def from_program(cls, program, fcfg: FlowEngineConfig = FlowEngineConfig(),
                     device=None) -> "FlowEngine":
        """Deploy ``program`` (``program.deploy(DeploySpec(flow=fcfg))``)."""
        from repro_torch.serve.deploy import build_flow_engine

        return build_flow_engine(program, fcfg, device=device)

    def _table_args(self):
        """The flow step's leading arguments: weights, rules and the table."""
        return (self.params, self._step_rules(), self.caches, self.positions, self.sig,
                self.hidden_sum, self.vetoed)

    def fused_widths(self) -> List[int]:
        """The chunk widths :func:`pack_width_groups` can give this engine:
        the powers of two from ``_next_pow2(min_chunk_lanes)`` up to
        ``lanes``, and ``lanes`` itself when it is not a power of two."""
        lanes = self.fcfg.lanes
        widths = []
        w = min(lanes, _next_pow2(max(self.fcfg.min_chunk_lanes, 1)))
        while w < lanes:
            widths.append(w)
            w *= 2
        widths.append(lanes)
        return widths

    def warm_fused(self, pkt_len: int) -> int:
        """Capture the flow step's graph at every width traffic can produce,
        so that steady-state ingest captures nothing; returns the number of
        widths ready (on the CPU every width is, with no graph).  Optional:
        without it a width is captured at its first chunk."""
        if not self.fcfg.fused:
            return 0
        widths = self.fused_widths()
        for w in widths:
            if self._graphs is not None:
                self._graphs.capture(w, pkt_len)
            else:
                self._fused_keys.add((w, pkt_len))
        return len(widths)

    def fused_graphs(self) -> Dict[Tuple[int, int], "fused_mod.StepGraph"]:
        """The captured graphs by ``(width, pkt_len)`` (empty on the CPU)."""
        return dict(self._graphs.graphs) if self._graphs is not None else {}

    def capture_entry_points(self) -> Dict[str, CaptureKeys]:
        """The per-round step and, with ``fcfg.fused``, the fused step: its
        captured graphs on the card, the keys it has run at on the CPU."""
        entries = super().capture_entry_points()
        if self.fcfg.fused:
            if self._graphs is not None:
                entries["fused"] = CaptureKeys(lambda: self._graphs.graphs.keys())
            else:
                entries["fused"] = CaptureKeys(lambda: self._fused_keys)
        return entries

    # ------------------------------------------------------------------
    # state accounting
    # ------------------------------------------------------------------
    def resident_state_bytes(self) -> int:
        """Total allocated flow-table bytes (capacity + the scratch lane)."""
        return hardware_model.flow_table_bytes(self._n_slots, self.per_flow_state_bytes())

    # ------------------------------------------------------------------
    # fused ingest
    # ------------------------------------------------------------------
    def _dispatch_fused(
        self, flow_ids: np.ndarray, tokens: np.ndarray,
        slots: np.ndarray, fresh: np.ndarray, staging: Optional[Dict] = None,
    ) -> _PendingIngest:
        """Pack this batch's arrival rounds into width-bucketed chunk stacks,
        run every chunk through the flow step at its width, and return
        without waiting for the card.

        Each width group is packed into a pinned host buffer from ``staging``
        (the engine's own pool, or an :class:`AsyncIngestPipeline` ring
        slot's) and copied to the card with ``non_blocking=True``; its chunks
        then replay the width's graph one by one.  The results of every
        chunk land in one device tensor, which one non-blocking copy brings
        to pinned host memory behind the replays.
        """
        P, pkt_len = tokens.shape
        lanes, scratch = self.fcfg.lanes, self.fcfg.capacity
        pool = self._staging if staging is None else staging
        groups = pack_width_groups(slots, lanes, self.fcfg.min_chunk_lanes)
        cols = _RESULT_FIXED + self.ccfg.sig_words
        res = torch.empty((sum(w * len(ch) for w, ch in groups), cols), dtype=torch.int32,
                          device=self.device)
        pin = self.device.type == "cuda"
        # A buffer shape can recur non-consecutively within one batch: a round
        # larger than ``lanes`` emits a full-width group then a smaller tail,
        # so widths run like [256, 64, 256, 64].  Repacking one buffer for the
        # second group could overwrite data the first group's asynchronous
        # copy still reads, so the pool key carries the occurrence index
        # within the dispatch.  Across dispatches a pool is reused only after
        # the batch that last used it is finalized.
        uses: Dict[Tuple[int, int, int], int] = {}
        layout = []
        r0 = 0
        for w, chunks in groups:
            n = len(chunks)
            shape = (w, _next_pow2(n), pkt_len)
            occ = uses.get(shape, 0)
            uses[shape] = occ + 1
            key = shape + (occ,)
            buf = pool.get(key)
            if buf is None:
                buf = pool[key] = torch.empty((shape[1], w, pkt_len + 2), dtype=torch.int64,
                                              pin_memory=pin)
            host = buf.numpy()
            host[:n, :, 0] = scratch
            host[:n, :, 1:] = 0
            for j, ch in enumerate(chunks):
                k = len(ch)
                host[j, :k, 0] = slots[ch]
                host[j, :k, 1] = fresh[ch]
                host[j, :k, 2:] = tokens[ch]
            stack = buf[:n].to(self.device, non_blocking=True)
            self._run_fused(w, stack, res[r0 : r0 + n * w])
            layout.append((r0, w, chunks))
            r0 += n * w
            self.stats.rounds += n
        self.stats.packets += P
        self.stats.tokens += P * pkt_len
        event = None
        if pin:
            out = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
            out.copy_(res, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            res = out
        return _PendingIngest(flow_ids, P, res, event, layout)

    def _run_fused(self, width: int, stack: torch.Tensor, res: torch.Tensor) -> None:
        """Chunks ``stack (C, width, pkt_len + 2)`` through the flow step,
        their packed outputs into ``res (C * width, cols)``."""
        if self._graphs is not None:
            self._graphs.run(width, stack, res)
            return
        self._fused_keys.add((width, stack.shape[-1] - 2))
        outs = self._fused_eager(*self._table_args(), *fused_mod.step_inputs(stack))
        res.copy_(pack_step_outputs(outs).reshape(res.shape))
