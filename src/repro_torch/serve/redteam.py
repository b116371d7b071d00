"""Red-team trust gate (port of ``repro.serve.redteam``): replay
adversarial campaigns through deployed engines and measure the §3.5-3.6
hard guarantees.

Every registered :mod:`~repro_torch.data.campaigns` campaign, and the
committed sample trace, is replayed through

* **static** — tables frozen at deploy time (the blind baseline),
* **oracle** — phase-correct rules installed at every boundary (the
  perfect-foreknowledge upper bound),
* **adaptive** — an :class:`~repro_torch.serve.adaptive_loop.AdaptiveLoop`
  closing the detect → relearn → audited-delta → measured-install loop,

and each campaign's scorecard holds:

1. **No hard-veto flips.**  Once a packet of a flow is vetoed, every later
   packet of that flow is vetoed, across swaps, installs and phase
   boundaries, in all three modes.
2. **S = 1.0 pinning.**  ``trust == 1.0`` exactly on the vetoed packets,
   strictly below elsewhere.
3. **Recovery.**  Adaptive per-phase accuracy of the veto verdict against
   the ground-truth anomaly label reaches ``recovery_floor`` of the
   oracle's, phase by phase.
4. **Eq. 18 compliance.**  Every install lands inside ``t_cp`` (violators
   must have been rolled back).
5. **No evictions** during the replay: the sticky-veto guarantee is scoped
   to table-resident flows.

The engines run on ``RedTeamConfig.device`` (``"cuda"`` unless the caller
asks for ``"cpu"``).  Programs compile with the static-verification pass
on, as the JAX package's do.  The CLI exits 1 if any gate check fails::

    PYTHONPATH=src python -m repro_torch.serve.redteam --fast --out scorecard.json
    PYTHONPATH=src python -m repro_torch.serve.redteam --campaigns all --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_MODES = ("static", "oracle", "adaptive")

# harness-default detector sensitivity (campaigns may override per threat
# model): the serving-tier policy with a faster cooldown, so short CI
# campaigns still fit several control-plane epochs
DEFAULT_POLICY: Dict[str, float] = dict(
    warmup_ticks=2, cooldown_ticks=4, sig_novelty=0.05, churn_shift=0.12,
)


def split_policy(campaign_policy) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Route a campaign's policy overrides onto the two tuning surfaces:
    keys naming :class:`~repro_torch.serve.adaptive_loop.DriftPolicy` fields
    (trigger thresholds) vs :class:`~repro_torch.serve.adaptive_loop
    .AdaptiveLoopConfig` fields (EWMA rates, relearn sensitivity).  The
    DriftPolicy side starts from :data:`DEFAULT_POLICY`."""
    import dataclasses as dc

    from repro_torch.serve.adaptive_loop import AdaptiveLoopConfig, DriftPolicy

    drift_fields = {f.name for f in dc.fields(DriftPolicy)}
    loop_fields = {f.name for f in dc.fields(AdaptiveLoopConfig)}
    drift, loop_cfg = dict(DEFAULT_POLICY), {}
    for k, v in dict(campaign_policy).items():
        if k in drift_fields:
            drift[k] = v
        elif k in loop_fields:
            loop_cfg[k] = v
        else:
            raise ValueError(
                f"campaign policy key {k!r} matches neither DriftPolicy "
                f"nor AdaptiveLoopConfig fields"
            )
    return drift, loop_cfg


class RedTeamError(AssertionError):
    """A red-team gate check failed (the scorecard names the violation)."""


@dataclasses.dataclass(frozen=True)
class RedTeamConfig:
    recovery_floor: float = 0.9  # adaptive/oracle per-phase accuracy bar
    capacity: int = 4096  # sized so no campaign evicts (precondition)
    lanes: int = 128
    backend: Optional[str] = None  # None -> the program pass's default
    sync: bool = True  # inline control plane (deterministic scorecards)
    record_history: bool = False  # keep per-batch veto/pred (golden test)
    device: str = "cuda"  # where the engines run ("cpu" only when asked)


@dataclasses.dataclass
class PhaseReport:
    """Per-phase slice of one campaign scorecard."""

    phase: int
    kind: str
    batches: int
    sig_rotation: int
    packets: int = 0
    anomalous: int = 0
    veto_rate: Dict[str, float] = dataclasses.field(default_factory=dict)
    accuracy: Dict[str, float] = dataclasses.field(default_factory=dict)
    recovery: float = 0.0  # adaptive accuracy / oracle accuracy


@dataclasses.dataclass
class CampaignScorecard:
    campaign: str
    goal: str
    benign: bool
    phases: List[PhaseReport]
    # invariant counters, summed over all replayed modes
    pinning_violations: int = 0
    veto_flips: int = 0
    evictions: int = 0
    # adaptation accounting (the adaptive replay)
    triggers: int = 0
    installs: int = 0
    installs_within_t_cp: int = 0
    rollbacks: int = 0
    t_cp_s: float = 0.0
    installs_per_hour: float = 0.0
    wall_s: float = 0.0
    packets: int = 0
    recovery_floor: float = 0.0
    policy: Dict[str, float] = dataclasses.field(default_factory=dict)
    passed: bool = False
    failures: List[str] = dataclasses.field(default_factory=list)
    history: Optional[List[Dict[str, List[int]]]] = None

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if self.history is None:
            d.pop("history")
        return d


class TrustInvariantTracker:
    """Streaming observer of the §3.5 hard guarantees.

    ``observe`` must see every ingested batch of one replay, in order.
    Flips are counted per *flow*: a flow whose veto bit was ever set and
    whose later packet comes back un-vetoed is a broken sticky veto."""

    def __init__(self):
        self._vetoed_once: Dict[int, bool] = {}
        self.pinning_violations = 0
        self.veto_flips = 0
        self.packets = 0
        self.vetoed_packets = 0

    def observe(self, flow_ids: np.ndarray, out: Dict[str, np.ndarray]) -> None:
        trust = np.asarray(out["trust"])
        vetoed = np.asarray(out["vetoed"], bool)
        self.packets += int(vetoed.shape[0])
        self.vetoed_packets += int(vetoed.sum())
        # Eq. 15 pinning, both directions: vetoed <=> trust exactly 1.0
        self.pinning_violations += int(np.sum((trust == 1.0) != vetoed))
        for fid, v in zip(
            np.asarray(flow_ids).tolist(), vetoed.tolist()
        ):
            if self._vetoed_once.get(fid, False) and not v:
                self.veto_flips += 1
            elif v:
                self._vetoed_once[fid] = True


def _build_classifier(vocab_size: int = 512, device="cuda"):
    """The harness's fixed tiny deployment (the shape of the conformance
    tests), deterministic in a ``torch.Generator`` seeded 0.  The JAX
    package draws its weights from ``PRNGKey(0)``, so the two harnesses
    serve different weights; the hard invariants do not depend on them."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import smoke_config
    from repro_torch.train import classifier as C

    arch = dc.replace(
        smoke_config("chimera-dataplane"), n_layers=2, d_model=32, d_ff=64,
        n_heads=2, n_kv_heads=2, d_head=16, vocab_size=vocab_size,
    )
    ccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256)
    params = C.init_classifier(ccfg, torch.Generator().manual_seed(0), device=device)
    return ccfg, params


def _compile_for_signature(ccfg, params, signature, backend, device):
    from repro_torch.compile import compile_program
    from repro_torch.train import classifier as C

    return compile_program(
        ccfg, params,
        rules=lambda c: C.default_rules(c, signature, device=device),
        backend=backend,
    )


def _deploy(program, cfg: RedTeamConfig):
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig

    return program.deploy(DeploySpec(
        flow=FlowEngineConfig(capacity=cfg.capacity, lanes=cfg.lanes),
        device=cfg.device,
    ))


# --------------------------------------------------------------------------
# campaign replay
# --------------------------------------------------------------------------

def _replay_campaign_mode(campaign, cfg: RedTeamConfig, mode: str):
    """One full campaign cycle through one deployment mode.  Returns
    (per-phase correct/total/veto counts, tracker, loop|None, wall_s,
    history)."""
    from repro_torch.serve.adaptive_loop import (
        AdaptiveLoop, AdaptiveLoopConfig, DriftPolicy,
    )

    ccfg, params = _build_classifier(device=cfg.device)
    sc = campaign.scenario()
    program = _compile_for_signature(
        ccfg, params, sc.phase_anomaly_signature(0), cfg.backend, cfg.device
    )
    eng = _deploy(program, cfg)
    loop = None
    if mode == "adaptive":
        drift, loop_cfg = split_policy(campaign.policy)
        loop = AdaptiveLoop(
            eng,
            policy=DriftPolicy(**drift),
            cfg=AdaptiveLoopConfig(sync=cfg.sync, **loop_cfg),
        )
    n_phases = len(campaign.phases)
    correct = np.zeros(n_phases)
    total = np.zeros(n_phases)
    vetoes = np.zeros(n_phases)
    anom = np.zeros(n_phases)
    tracker = TrustInvariantTracker()
    history: List[Dict[str, List[int]]] = []
    cur = 0
    t0 = time.perf_counter()
    for _ in range(sc.batches_per_cycle):
        ph = sc.phase_index()
        if mode == "oracle" and ph != cur:
            oracle = _compile_for_signature(
                ccfg, params, sc.phase_anomaly_signature(ph), cfg.backend,
                cfg.device,
            )
            eng.swap_tables(ruleset=oracle.rules)
            cur = ph
        b = sc.next_batch()
        out = (loop or eng).ingest(b["flow_ids"], b["tokens"])
        tracker.observe(b["flow_ids"], out)
        correct[ph] += int((out["vetoed"] == b["anomalous"]).sum())
        total[ph] += len(out["vetoed"])
        vetoes[ph] += int(np.asarray(out["vetoed"]).sum())
        anom[ph] += int(np.asarray(b["anomalous"]).sum())
        if cfg.record_history:
            history.append({
                "vetoed": np.asarray(out["vetoed"], np.int64).tolist(),
                "pred": np.asarray(out["pred"], np.int64).tolist(),
            })
    wall = time.perf_counter() - t0
    if loop is not None:
        loop.close()
    evicted = int(eng.stats.flows_evicted)
    return correct, total, vetoes, anom, tracker, loop, wall, evicted, history


def run_campaign(campaign, cfg: Optional[RedTeamConfig] = None) -> CampaignScorecard:
    """Replay one campaign through all three modes and score the gate."""
    cfg = cfg if cfg is not None else RedTeamConfig()
    drift, loop_cfg = split_policy(campaign.policy)
    policy = {**drift, **loop_cfg}
    card = CampaignScorecard(
        campaign=campaign.name, goal=campaign.goal, benign=campaign.benign,
        phases=[
            PhaseReport(phase=i, kind=p.kind, batches=p.batches,
                        sig_rotation=p.sig_rotation)
            for i, p in enumerate(campaign.phases)
        ],
        recovery_floor=cfg.recovery_floor,
        policy={k: float(v) for k, v in policy.items()},
    )
    acc: Dict[str, np.ndarray] = {}
    for mode in _MODES:
        (correct, total, vetoes, anom, tracker, loop, wall, evicted,
         history) = _replay_campaign_mode(campaign, cfg, mode)
        acc[mode] = correct / np.maximum(total, 1)
        card.pinning_violations += tracker.pinning_violations
        card.veto_flips += tracker.veto_flips
        card.evictions += evicted
        for i, rep in enumerate(card.phases):
            rep.veto_rate[mode] = round(
                float(vetoes[i] / max(total[i], 1)), 6
            )
            rep.accuracy[mode] = round(float(acc[mode][i]), 6)
            if mode == "static":  # identical traffic in every mode
                rep.packets = int(total[i])
                rep.anomalous = int(anom[i])
        if mode == "adaptive":
            card.triggers = len(loop.history)
            card.installs = loop.installs
            card.installs_within_t_cp = loop.installs_within_budget
            card.rollbacks = sum(r.rolled_back for r in loop.history)
            card.t_cp_s = float(loop.t_cp_s)
            card.wall_s = round(wall, 3)
            card.packets = tracker.packets
            card.installs_per_hour = round(loop.installs / wall * 3600.0, 1)
            if cfg.record_history:
                card.history = history
    for rep in card.phases:
        oracle_acc = max(acc["oracle"][rep.phase], 1e-9)
        rep.recovery = round(float(acc["adaptive"][rep.phase] / oracle_acc), 6)

    # ---- the gate -----------------------------------------------------
    f = card.failures
    if card.pinning_violations:
        f.append(f"S=1.0 pinning violated on "
                 f"{card.pinning_violations} packet(s)")
    if card.veto_flips:
        f.append(f"hard-veto invariant flipped on "
                 f"{card.veto_flips} flow occurrence(s)")
    if card.evictions:
        f.append(f"{card.evictions} eviction(s): replay precondition broken "
                 f"(grow RedTeamConfig.capacity)")
    for rep in card.phases:
        if rep.recovery < cfg.recovery_floor:
            f.append(
                f"phase {rep.phase} ({rep.kind}"
                f"{f', rot {rep.sig_rotation}' if rep.sig_rotation else ''}): "
                f"recovery {rep.recovery:.3f} < floor {cfg.recovery_floor}"
            )
    if card.installs != card.installs_within_t_cp:
        f.append(
            f"{card.installs - card.installs_within_t_cp} install(s) "
            f"outside the Eq. 18 t_cp budget ({card.t_cp_s:g}s) "
            f"survived without rollback"
        )
    if not campaign.benign and campaign.attack_phases and not card.installs:
        f.append("attack campaign triggered no adaptation install "
                 "(the loop never saw the rotation)")
    card.passed = not f
    return card


# --------------------------------------------------------------------------
# trace replay check
# --------------------------------------------------------------------------

def run_trace(trace_path: Optional[str] = None,
              cfg: Optional[RedTeamConfig] = None,
              packets_per_batch: int = 128) -> CampaignScorecard:
    """Replay a recorded trace (default: the committed sample) through a
    static deployment compiled against the trace's labeled signature, and
    hold the same hard invariants.  There is no drift schedule in a single
    trace, so the oracle IS the static deployment: the scorecard's
    recovery is static-accuracy coverage, and the adaptation fields stay
    zero."""
    from repro_torch.data import traces as TR

    cfg = cfg if cfg is not None else RedTeamConfig()
    trace = TR.load_trace(trace_path or TR.SAMPLE_TRACE)
    sc = TR.TraceReplayScenario(trace, packets_per_batch=packets_per_batch)
    ccfg, params = _build_classifier(vocab_size=trace.meta.vocab_size, device=cfg.device)
    program = _compile_for_signature(
        ccfg, params, sc.anomaly_signature, cfg.backend, cfg.device
    )
    eng = _deploy(program, cfg)
    tracker = TrustInvariantTracker()
    correct = total = 0
    t0 = time.perf_counter()
    for b in sc:
        out = eng.ingest(b["flow_ids"], b["tokens"])
        tracker.observe(b["flow_ids"], out)
        correct += int((out["vetoed"] == b["anomalous"]).sum())
        total += len(out["vetoed"])
    wall = time.perf_counter() - t0
    acc = correct / max(total, 1)
    card = CampaignScorecard(
        campaign=f"trace-replay:{trace_path or 'sample'}",
        goal="recorded-traffic replay: invariants under real arrival "
             "processes",
        benign=False,
        phases=[PhaseReport(
            phase=0, kind="trace", batches=sc.batches_per_cycle,
            sig_rotation=0, packets=total,
            anomalous=int(trace.anomalous.sum()),
            veto_rate={"static": round(tracker.vetoed_packets / max(total, 1), 6)},
            accuracy={"static": round(acc, 6)},
            recovery=1.0,
        )],
        pinning_violations=tracker.pinning_violations,
        veto_flips=tracker.veto_flips,
        evictions=int(eng.stats.flows_evicted),
        wall_s=round(wall, 3),
        packets=total,
        recovery_floor=cfg.recovery_floor,
    )
    f = card.failures
    if card.pinning_violations:
        f.append(f"S=1.0 pinning violated on "
                 f"{card.pinning_violations} packet(s)")
    if card.veto_flips:
        f.append(f"hard-veto invariant flipped on "
                 f"{card.veto_flips} flow occurrence(s)")
    if card.evictions:
        f.append(f"{card.evictions} eviction(s) during trace replay")
    if not 0 < tracker.vetoed_packets < total:
        f.append("trace replay must exercise both veto branches "
                 "(all-or-none vetoes make the invariant checks vacuous)")
    card.passed = not f
    return card


# --------------------------------------------------------------------------
# the gate CLI
# --------------------------------------------------------------------------

def run_redteam(
    names: Optional[List[str]] = None,
    cfg: Optional[RedTeamConfig] = None,
    include_trace: bool = True,
    trace_path: Optional[str] = None,
) -> List[CampaignScorecard]:
    from repro_torch.data.campaigns import get_campaign, list_campaigns

    cfg = cfg if cfg is not None else RedTeamConfig()
    cards = []
    for name in (names if names is not None else list_campaigns()):
        cards.append(run_campaign(get_campaign(name), cfg))
    if include_trace:
        cards.append(run_trace(trace_path, cfg))
    return cards


def _summary_line(card: CampaignScorecard) -> str:
    worst = min((p.recovery for p in card.phases), default=1.0)
    return (
        f"{'PASS' if card.passed else 'FAIL'}  {card.campaign:24s} "
        f"pkts={card.packets:<6d} flips={card.veto_flips} "
        f"pin_viol={card.pinning_violations} "
        f"installs={card.installs} ({card.installs_within_t_cp} in t_cp, "
        f"{card.rollbacks} rolled back) min_recovery={worst:.3f}"
    )


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.data.campaigns import SMOKE_CAMPAIGN, list_campaigns

    ap = argparse.ArgumentParser(
        description="red-team trust gate over the campaign library")
    ap.add_argument("--campaigns", default="all",
                    help="'all' or comma-separated campaign names")
    ap.add_argument("--fast", action="store_true",
                    help=f"CI fast lane: only the {SMOKE_CAMPAIGN!r} "
                         f"campaign + the sample-trace replay")
    ap.add_argument("--list", action="store_true",
                    help="list registered campaigns and exit")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the scorecards as a JSON artifact")
    ap.add_argument("--backend", default=None,
                    help="score backend override (None/xla float, or "
                         "int-emulation)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (default) or cpu")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="background control plane (scorecards then depend "
                         "on host timing; the gate only runs sync)")
    ap.add_argument("--recovery-floor", type=float, default=0.9)
    ap.add_argument("--skip-trace", action="store_true",
                    help="skip the sample-trace replay check")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="replay this trace file instead of the sample")
    args = ap.parse_args(argv)

    if args.list:
        from repro_torch.data.campaigns import get_campaign

        for name in list_campaigns():
            c = get_campaign(name)
            kinds = ",".join(
                f"{p.kind}:{p.batches}"
                + (f":rot{p.sig_rotation}" if p.sig_rotation else "")
                for p in c.phases
            )
            print(f"{name:20s} [{'benign' if c.benign else 'attack'}] "
                  f"{c.batches} batches  {kinds}\n    {c.goal}")
        return 0

    if args.fast:
        names: Optional[List[str]] = [SMOKE_CAMPAIGN]
    elif args.campaigns == "all":
        names = None
    else:
        names = [n.strip() for n in args.campaigns.split(",") if n.strip()]

    cfg = RedTeamConfig(
        recovery_floor=args.recovery_floor,
        backend=args.backend,
        sync=not args.use_async,
        device=args.device,
    )
    cards = run_redteam(
        names, cfg, include_trace=not args.skip_trace, trace_path=args.trace
    )

    for card in cards:
        print(_summary_line(card))
        for msg in card.failures:
            print(f"        {msg}")
    if args.out:
        payload = {
            "schema": "redteam-scorecard-v1",
            "recovery_floor": cfg.recovery_floor,
            "sync": cfg.sync,
            "passed": all(c.passed for c in cards),
            "scorecards": [c.as_dict() for c in cards],
        }
        with open(args.out, "w") as fp:
            json.dump(payload, fp, indent=2, sort_keys=True)
            fp.write("\n")
        print(f"scorecards written to {args.out}")

    failed = [c.campaign for c in cards if not c.passed]
    if failed:
        print(f"red-team gate FAILED: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(f"red-team gate OK: {len(cards)} scorecard(s) green "
          f"(zero veto flips, zero pinning violations, recovery >= "
          f"{cfg.recovery_floor:g}, all installs within t_cp)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
