"""Closed-loop two-timescale adaptation under traffic drift (port of
``repro.serve.adaptive_loop``).

:class:`AdaptiveLoop` wraps a program-deployed
:class:`~repro_torch.serve.flow_engine.FlowEngine` and closes the
drift-detect → recompile → atomic-install loop of §3.6:

* **Drift detection (fast timescale).**  After every ingest the engine's
  outputs update two-rate EWMAs — per-class trust-score histograms, class
  mix, veto rate, flow churn, packed-signature marker-bit frequencies
  (:mod:`repro_torch.core.two_timescale`) — in plain torch on the engine's
  device: one upload of the batch, one summary per ``stats_lanes`` chunk,
  one commit, one read of the five metrics.
* **Drift policy (host).**  :class:`DriftPolicy` thresholds the fast-vs-
  slow distances with warmup and cooldown and decides when the control
  plane wakes up.
* **Adaptation (slow timescale).**  A fired policy runs the relearn hook,
  ``TwoTimescaleController.maybe_recluster`` (harvested per-flow pooled
  features → k-means → Eq. 20 gate) and ``compile_delta`` (re-audited
  tables), then ``swap_tables(delta=)``.  Sync mode runs the chain inline
  at the firing tick (deterministic: what the conformance tests replay);
  async mode runs relearn + recluster + compile on a background thread and
  installs the finished delta at the next tick boundary.
* **Accounting.**  Every install is measured and held to the Eq. 18
  ``t_cp`` budget: a violating install is rolled back (the previous tables
  re-installed), and a delta that no longer fits the budget
  (``BudgetError``) is never installed.  Each epoch appends an
  :class:`AdaptationRecord` to :attr:`AdaptiveLoop.history`.

**The control plane never touches the card.**  The fused engine captures
a CUDA graph of its flow step at a width's first chunk, in torch's global
capture mode, and any CUDA call made from another thread during a capture
aborts it.  So everything the background thread reads is host state,
written by the main thread between ticks: the firing tick's statistics
(copied to the CPU when the policy fires), the reservoir of harvested
features (numpy), a CPU copy of the installed rules (:attr:`host_rules`)
and a CPU view of the program (:attr:`host_program`) that ``compile_delta``
packs against.  k-means runs on CPU tensors.  Only the install, on the
main thread at a tick boundary, copies the delta's tables to the card.

Over a :class:`~repro_torch.serve.sharded_flow_engine.ShardedFlowEngine`
the harvest reads each shard's rows in slot order, shard by shard, as the
JAX package's does.  :meth:`AdaptiveLoop.capture_entry_points` hands the
graph-capture sentry the inner engine's entry points, namespaced
``engine.``; the drift statistics run eagerly and capture nothing.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compile.ledger import BudgetError
from repro_torch.core import hardware_model
from repro_torch.core import symbolic
from repro_torch.core import two_timescale as TT

_METRIC_NAMES = (
    "class_dist", "hist_dist", "veto_shift", "churn_shift", "sig_novelty",
)


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """When does the control plane wake up?  Each field thresholds one
    drift metric of :func:`repro_torch.core.two_timescale.drift_metrics`
    (0 disables that detector).  ``warmup_ticks`` suppresses triggers until
    the EWMAs have content; ``cooldown_ticks`` is the minimum spacing
    between control-plane epochs."""

    class_dist: float = 0.12  # total variation on the predicted-class mix
    hist_dist: float = 0.0  # per-class trust-histogram TV (mass-weighted)
    veto_shift: float = 0.0  # |fast - slow| veto rate
    churn_shift: float = 0.15  # |fast - slow| new-flow fraction
    sig_novelty: float = 0.07  # max marker-bit frequency surge over baseline
    warmup_ticks: int = 3
    cooldown_ticks: int = 6

    def fired(self, metrics: Dict[str, float]) -> Tuple[str, ...]:
        """Names of the detectors whose thresholds ``metrics`` crossed."""
        return tuple(
            name for name in _METRIC_NAMES
            if getattr(self, name) > 0 and metrics[name] >= getattr(self, name)
        )


@dataclasses.dataclass(frozen=True)
class AdaptiveLoopConfig:
    eta_fast: float = 0.25  # recent-window EWMA rate (memory ~4 batches)
    eta_slow: float = 0.02  # baseline EWMA rate (memory ~50 batches)
    n_bins: int = 8  # trust-score histogram bins
    stats_lanes: int = 256  # drift-summary chunk width
    sync: bool = True  # inline control plane; False = background thread
    observe_cap: int = 32  # resident flows sampled into the reservoir/tick
    novelty_bit_threshold: float = 0.05  # relearn: marker-bit surge floor
    relearn_veto_floor: float = 0.06  # relearn only while the TCAM is blind
    t_cp_s: float = 0.0  # Eq. 18 install budget; 0 → engine's, else 60s


@dataclasses.dataclass
class AdaptationRecord:
    """One control-plane epoch, end to end: why it fired, what the
    recluster decided, what the delta cost, how the install went."""

    tick: int  # engine tick the policy fired on
    trigger: Dict[str, float]  # drift metrics at fire time
    fired_on: Tuple[str, ...]  # which DriftPolicy detectors crossed
    installed: bool
    rolled_back: bool = False  # install exceeded t_cp and was undone
    error: Optional[str] = None  # BudgetError text / hold reason
    install_tick: int = 0  # engine tick the install landed on (async ≥ tick)
    install_s: float = 0.0  # measured wall-clock install (Eq. 18)
    t_cp_s: float = 0.0  # the budget the install was held to
    churn_ok: bool = True  # Eq. 18 verdict
    delta_step: int = 0  # control-plane epoch counter
    recluster: Optional[Dict[str, Any]] = None  # InstallRecord fields
    ledger_diff: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )  # program ledger vs delta ledger, per stage/resource
    epoch_s: float = 0.0  # host seconds of relearn + recluster + compile_delta

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["fired_on"] = list(self.fired_on)
        return d


def _host_copy(rules: symbolic.RuleSet) -> symbolic.RuleSet:
    return symbolic.RuleSet(*(t.detach().to("cpu", copy=True) for t in rules.tensors()))


def default_relearn(
    loop: "AdaptiveLoop", trigger: Dict[str, float], fired_on: Tuple[str, ...]
) -> Dict[str, Any]:
    """Control-plane rule resynthesis from streaming novelty.

    If the signature-novelty detector names marker bits surging above the
    long-run baseline, rebuild every hard-rule row as an exact-match
    conjunction over the hottest novel bits — those within 2x of the
    strongest surge, at most 4 (the anomaly-signature width).  The rebuilt
    rows keep the installed RuleSet's shape.  With no novel bits the tables
    are left as they are (the delta still re-audits and re-installs them).

    Resynthesis is gated on veto coverage: while the installed rules still
    fire (recent veto rate above ``relearn_veto_floor``) the TCAM tier is
    not blind, and a trigger driven by churn or class drift must not
    overwrite a working signature with phase-boundary transients.

    Reads only host state (the firing tick's statistics and
    :attr:`AdaptiveLoop.host_rules`), so it may run on the control-plane
    thread.  Words are built as uint32 values and converted to the port's
    int32 bit patterns with :func:`~repro_torch.core.symbolic.words_to_int32`.
    """
    stats = loop.trigger_stats  # snapshot from the firing tick, not live
    veto_f, _ = TT._debiased(stats, loop.scfg, "veto")
    if float(veto_f) > loop.cfg.relearn_veto_floor:
        return {}
    mask = TT.novel_signature_bits(loop.scfg, stats, loop.cfg.novelty_bit_threshold).numpy()
    if not mask.any():
        return {}
    sig_f, sig_s = TT._debiased(stats, loop.scfg, "sig")
    strength = (sig_f - sig_s).numpy()
    novel = np.nonzero(mask)[0]
    novel = novel[np.argsort(-strength[novel], kind="stable")]
    novel = novel[strength[novel] >= 0.5 * strength[novel[0]]][:4]
    rules = loop.host_rules
    rows = np.nonzero(rules.hard.numpy())[0]
    if rows.size == 0:
        # nothing to resynthesize: overwriting a soft row would destroy an
        # HL-MRF rule without ever producing a veto
        return {}
    vals = rules.values.numpy().view(np.uint32).astype(np.int64)
    masks = rules.masks.numpy().view(np.uint32).astype(np.int64)
    word = np.zeros((vals.shape[1],), np.int64)
    for b in novel.tolist():
        word[b // 32] |= 1 << (b % 32)
    vals[rows] = word
    masks[rows] = word
    return {
        "ruleset": symbolic.RuleSet(
            values=symbolic.words_to_int32(torch.from_numpy(vals)),
            masks=symbolic.words_to_int32(torch.from_numpy(masks)),
            weights=rules.weights.clone(),
            hard=rules.hard.clone(),
        )
    }


class AdaptiveLoop:
    """Drive a flow-serving engine through non-stationary traffic, closing
    the drift-detect → recompile → atomic-install loop (§3.6).

    ``relearn(loop, trigger, fired_on) -> {"ruleset": ..., "new_weights":
    ...}`` lets deployments plug in their own slow-path learner; the
    default resynthesizes hard rules from signature novelty.  In async
    mode it runs on the control-plane thread and must not touch CUDA
    tensors (see the module docstring).
    """

    def __init__(
        self,
        engine,
        policy: Optional[DriftPolicy] = None,
        cfg: Optional[AdaptiveLoopConfig] = None,
        controller: Optional[TT.TwoTimescaleController] = None,
        relearn: Optional[Callable] = None,
    ):
        if getattr(engine, "program", None) is None:
            raise ValueError(
                "AdaptiveLoop needs a program-deployed engine "
                "(program.deploy(DeploySpec(...))): slow-timescale deltas "
                "recompile against the installed program"
            )
        self.engine = engine
        self.device = engine.device
        self.policy = policy if policy is not None else DriftPolicy()
        self.cfg = cfg if cfg is not None else AdaptiveLoopConfig()
        ccfg = engine.ccfg
        self.scfg = TT.DriftStatsConfig(
            n_classes=ccfg.n_classes,
            n_bins=self.cfg.n_bins,
            n_bits=32 * ccfg.sig_words,
            eta_fast=self.cfg.eta_fast,
            eta_slow=self.cfg.eta_slow,
        )
        self.stats = TT.init_drift_stats(self.scfg, self.device)
        # the firing tick's statistics, on the CPU (the control plane's view)
        self.trigger_stats = TT.init_drift_stats(self.scfg, "cpu")
        self.t_cp_s = (
            self.cfg.t_cp_s
            or engine.fcfg.t_cp_s
            or TT.TwoTimescaleConfig().t_cp_seconds
        )
        self.controller = controller if controller is not None else (
            # every fired policy IS a control-plane epoch (t_cp_steps=1) and
            # the Eq. 20 churn gate defers to the drift policy (tau_map=0)
            TT.TwoTimescaleController(
                TT.TwoTimescaleConfig(
                    t_cp_steps=1, tau_map=0.0, t_cp_seconds=self.t_cp_s
                ),
                n_centroids=ccfg.n_classes,
            )
        )
        self.relearn = relearn if relearn is not None else default_relearn
        self.history: List[AdaptationRecord] = []
        self.metrics: Dict[str, float] = {n: 0.0 for n in _METRIC_NAMES}
        self.centroids = torch.zeros((ccfg.n_classes, ccfg.arch.d_model), dtype=torch.float32)
        # host state the control plane reads (refreshed on the main thread)
        self.host_rules = _host_copy(engine.rules)
        program = engine.program
        self.host_program = dataclasses.replace(program, rules=_host_copy(program.rules))
        self.drift_s: List[float] = []  # host seconds of each tick's drift path
        self._tick = 0
        self._last_fire: Optional[int] = None
        self._epoch = 0  # control-plane epoch counter
        self._lock = threading.Lock()  # guards centroids/controller state
        self._executor = (
            None if self.cfg.sync
            else ThreadPoolExecutor(max_workers=1, thread_name_prefix="chimera-cp")
        )
        self._pending: Optional[Tuple[Future, Dict[str, float], Tuple[str, ...], int]] = None

    def capture_entry_points(self) -> Dict[str, Any]:
        """The inner engine's capture entry points, namespaced ``engine.``,
        for the graph-capture sentry (the JAX loop's jitted drift paths have
        no counterpart here: they run eagerly)."""
        return {f"engine.{name}": ep
                for name, ep in self.engine.capture_entry_points().items()}

    # ------------------------------------------------------------------
    # fast path
    # ------------------------------------------------------------------
    def ingest(self, flow_ids: np.ndarray, tokens: np.ndarray) -> Dict[str, np.ndarray]:
        """One engine tick plus the drift bookkeeping around it.  Same
        contract as ``FlowEngine.ingest``; a finished background delta is
        installed *before* the batch (at the tick boundary), and a fired
        policy schedules (async) or runs (sync) the control plane after."""
        self._install_if_ready()
        created0 = self.engine.stats.flows_created
        out = self.engine.ingest(flow_ids, tokens)
        self._tick += 1
        P = len(out["trust"])
        if P:
            churn = (self.engine.stats.flows_created - created0) / P
            t0 = time.perf_counter()
            self._update_stats(out, churn)
            self.drift_s.append(time.perf_counter() - t0)
        fired = self._policy_check()
        if fired:
            self._last_fire = self._tick
            trigger = dict(self.metrics)
            # freeze the firing tick's view on the host
            self.trigger_stats = {k: v.cpu() for k, v in self.stats.items()}
            if self.cfg.sync:
                self._run_epoch(trigger, fired, self._tick)
            else:
                self._epoch += 1
                fut = self._executor.submit(self._compile_epoch, trigger, fired, self._epoch)
                self._pending = (fut, trigger, fired, self._tick)
        return out

    def run(self, scenario, batches: int) -> List[Dict[str, np.ndarray]]:
        """Stream ``batches`` scenario batches through the loop."""
        outs = []
        for _ in range(batches):
            b = scenario.next_batch()
            outs.append(self.ingest(b["flow_ids"], b["tokens"]))
        return outs

    # ------------------------------------------------------------------
    # drift statistics (the engine's device)
    # ------------------------------------------------------------------
    def _update_stats(self, out: Dict[str, np.ndarray], churn: float) -> None:
        L = self.cfg.stats_lanes
        P = len(out["trust"])
        n_pad = -(-P // L) * L
        W = out["sig"].shape[1]
        pred = np.zeros((n_pad,), np.int32)
        trust = np.zeros((n_pad,), np.float32)
        veto = np.zeros((n_pad,), bool)
        sig = np.zeros((n_pad, W), np.int32)
        valid = np.zeros((n_pad,), bool)
        pred[:P] = out["pred"]
        trust[:P] = out["trust"]
        veto[:P] = out["vetoed"]
        sig[:P] = np.asarray(out["sig"], np.uint32).view(np.int32)
        valid[:P] = True
        dev = self.device
        cols = [torch.from_numpy(a).to(dev) for a in (pred, trust, veto, sig, valid)]
        total = None
        for c0 in range(0, n_pad, L):
            s = TT.summarize_drift_chunk(self.scfg, *(c[c0 : c0 + L] for c in cols))
            total = s if total is None else TT.merge_drift_summaries(total, s)
        self.stats = TT.commit_drift(self.scfg, self.stats, total, churn)
        m = TT.drift_metrics(self.scfg, self.stats)
        values = torch.stack([m[k] for k in _METRIC_NAMES]).tolist()
        self.metrics = dict(zip(_METRIC_NAMES, values))
        self._observe_features()

    def _observe_features(self) -> None:
        feats = self._harvest_pooled(self.cfg.observe_cap)
        if feats is not None and len(feats):
            self.controller.observe(feats)

    def _harvest_pooled(self, cap: int) -> Optional[np.ndarray]:
        """Pooled hidden features of up to ``cap`` resident flows (the
        control plane's recluster reservoir), in slot order (shard by shard
        on a sharded engine), so the sample is deterministic for a replayed
        stream.  Reads the table tensors the fused graphs write in place; a
        float32 result under int-emulation too (int32 / int32 is a true
        division)."""
        eng = self.engine
        rows: List[int] = []
        for s, t in enumerate(eng.tables):
            rows += [s * eng._n_slots + slot for slot in sorted(t.fid_of)[: cap - len(rows)]]
            if len(rows) >= cap:
                break
        _, positions, _, hidden_sum, _ = eng.flat_tables()
        if not rows:
            return None
        idx = torch.tensor(rows, dtype=torch.long, device=eng.device)
        pos = torch.clamp(positions[idx], min=1)[:, None]
        return (hidden_sum[idx] / pos).to(torch.float32).cpu().numpy()

    # ------------------------------------------------------------------
    # drift policy
    # ------------------------------------------------------------------
    def _policy_check(self) -> Tuple[str, ...]:
        if self._tick <= self.policy.warmup_ticks:
            return ()
        if (
            self._last_fire is not None
            and self._tick - self._last_fire <= self.policy.cooldown_ticks
        ):
            return ()
        if self._pending is not None:
            return ()  # one control-plane epoch in flight at a time
        return self.policy.fired(self.metrics)

    @property
    def trigger_ticks(self) -> List[int]:
        return [r.tick for r in self.history]

    @property
    def installs(self) -> int:
        return sum(r.installed for r in self.history)

    @property
    def installs_within_budget(self) -> int:
        return sum(r.installed and r.churn_ok for r in self.history)

    # ------------------------------------------------------------------
    # slow path: recluster -> audited delta -> measured atomic install
    # ------------------------------------------------------------------
    def _compile_epoch(self, trigger, fired, epoch):
        """Relearn + recluster + delta compilation, on host state only
        (thread-safe: touches the controller and centroids under the lock,
        never the engine).  Returns ``(rec, delta, error, seconds)``."""
        t0 = time.perf_counter()
        with self._lock:
            learned = self.relearn(self, trigger, fired) or {}
            try:
                cent, rec, delta = self.controller.maybe_recluster(
                    step=epoch * self.controller.cfg.t_cp_steps,
                    centroids=self.centroids,
                    occupancy=self.trigger_stats["class_fast"],
                    key=TT.prng_key(epoch),
                    program=self.host_program,
                    new_weights=learned.get("new_weights"),
                    new_ruleset=learned.get("ruleset"),
                )
            except BudgetError as e:
                return None, None, f"BudgetError: {e}", time.perf_counter() - t0
            self.centroids = cent
            dt = time.perf_counter() - t0
            if rec is None:
                return None, None, "no-observations", dt
            if delta is None:
                return rec, None, "recluster-held", dt
            return rec, delta, None, dt

    def _run_epoch(self, trigger, fired, fire_tick) -> AdaptationRecord:
        self._epoch += 1
        return self._install(*self._compile_epoch(trigger, fired, self._epoch),
                             trigger, fired, fire_tick)

    def _install_if_ready(self) -> None:
        if self._pending is None:
            return
        fut, trigger, fired, fire_tick = self._pending
        if not fut.done():
            return
        self._pending = None
        self._install(*fut.result(), trigger, fired, fire_tick)

    def _install(self, rec, delta, err, epoch_s, trigger, fired, fire_tick) -> AdaptationRecord:
        record = AdaptationRecord(
            tick=fire_tick,
            trigger=trigger,
            fired_on=fired,
            installed=False,
            install_tick=self._tick,
            t_cp_s=self.t_cp_s,
            delta_step=self._epoch,
            recluster=dataclasses.asdict(rec) if rec is not None else None,
            epoch_s=epoch_s,
        )
        if err is not None or delta is None:
            record.error = err
            self.history.append(record)
            return record
        # the engine's tables are rewritten in place, so keep a copy to roll back to
        prev_rules = _host_copy(self.engine.rules)
        swap = self.engine.swap_tables(delta=delta)
        record.install_s = swap.install_s
        record.churn_ok = hardware_model.install_time_ok(swap.install_s, self.t_cp_s)
        record.ledger_diff = self.engine.program.ledger.diff(delta.ledger)
        if not record.churn_ok:
            # Eq. 18 violated: the install did not complete inside the
            # control epoch — put the previous tables back (also measured,
            # also atomic) rather than serving a half-trusted deployment
            self.engine.swap_tables(ruleset=prev_rules)
            record.rolled_back = True
            record.error = (
                f"install {swap.install_s:.3f}s exceeded t_cp "
                f"{self.t_cp_s:.3f}s (Eq. 18); rolled back"
            )
        else:
            record.installed = True
        self.host_rules = _host_copy(self.engine.rules)
        self.history.append(record)
        return record

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Wait for an in-flight background epoch and install its delta
        (call between scenario phases / before reading final history)."""
        if self._pending is None:
            return
        self._pending[0].result()
        self._install_if_ready()

    def close(self) -> None:
        self.flush()
        if self._executor is not None:
            self._executor.shutdown(wait=True)

    def __enter__(self) -> "AdaptiveLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
