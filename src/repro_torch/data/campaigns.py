"""Named adversarial-campaign library (port of ``repro.data.campaigns``,
numpy only: the same six campaigns, phases, geometry and policies).

A *campaign* is a named composition of :class:`~repro_torch.data.pipeline
.DriftPhase` segments modeling one attack arc end to end: benign baseline
-> attack onset -> (optional escalation) -> aftermath.  The catalog:

* ``volumetric-ddos`` — floods of fresh flow ids (the ``burst`` kind's
  periodic sprays) carrying a rotated rule-violating signature.
* ``slowloris`` — many long-lived connections held open at a trickle.
* ``low-and-slow-exfil`` — a handful of very long flows hiding a rotated
  signature at a low anomaly rate: the weakest novelty signal.
* ``scan-evasion`` — a coordinated port scan under a rotated signature.
* ``flash-crowd`` — the benign control: a DDoS-shaped burst with zero rule
  violations, so a gate that vetoes everything cannot pass.
* ``smoke-surge`` — the short fast-lane campaign (one signature rotation).

Every attack campaign first shows its rotated signature inside a
shape-stable ``protocol-mix`` segment, where the novelty detector sees the
rotated marker bits cleanly and the loop re-learns them, and only then
launches the flood kind (see :func:`repro_torch.serve.adaptive_loop
.default_relearn`'s veto-coverage gate).  Each campaign pins its scenario
geometry (pkt_len, packets/batch, seed) so replays are deterministic, and
may carry :attr:`Campaign.policy` overrides of the detector sensitivity.

The registry is what the red-team harness (:mod:`repro_torch.serve
.redteam`) and the ``--campaign`` serving CLI enumerate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.data.pipeline import DriftPhase, DriftScenario

SMOKE_CAMPAIGN = "smoke-surge"


@dataclasses.dataclass(frozen=True)
class Campaign:
    """One named attack arc over the drift-phase algebra."""

    name: str
    goal: str  # the attacker's objective, one line (scorecard header)
    phases: Tuple[DriftPhase, ...]
    pkt_len: int = 8
    packets_per_batch: int = 64
    seed: int = 11
    benign: bool = False  # control campaign: no rule violations expected
    # DriftPolicy keyword overrides the red-team harness applies when
    # replaying THIS campaign adaptively (deployment-tuned sensitivity)
    policy: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.phases:
            raise ValueError(f"campaign {self.name!r} needs >= 1 phase")

    @property
    def batches(self) -> int:
        return sum(p.batches for p in self.phases)

    @property
    def attack_phases(self) -> Tuple[int, ...]:
        """Indices of phases that inject rule violations the deployed
        rules have never seen (``sig_rotation > 0``)."""
        return tuple(
            i for i, p in enumerate(self.phases) if p.sig_rotation > 0
        )

    def scenario(self, shard_id: int = 0, num_shards: int = 1,
                 **overrides) -> DriftScenario:
        """A fresh deterministic replay of this campaign's traffic."""
        kw = dict(
            phases=self.phases, pkt_len=self.pkt_len,
            packets_per_batch=self.packets_per_batch, seed=self.seed,
            shard_id=shard_id, num_shards=num_shards,
        )
        kw.update(overrides)
        return DriftScenario(**kw)


CAMPAIGNS: Dict[str, Campaign] = {}


def register_campaign(campaign: Campaign) -> Campaign:
    if campaign.name in CAMPAIGNS:
        raise ValueError(f"campaign {campaign.name!r} already registered")
    CAMPAIGNS[campaign.name] = campaign
    return campaign


def get_campaign(name: str) -> Campaign:
    if name not in CAMPAIGNS:
        raise KeyError(
            f"unknown campaign {name!r}; registered: {sorted(CAMPAIGNS)}"
        )
    return CAMPAIGNS[name]


def list_campaigns() -> Tuple[str, ...]:
    return tuple(sorted(CAMPAIGNS))


# --------------------------------------------------------------------------
# the catalog
# --------------------------------------------------------------------------

register_campaign(Campaign(
    name=SMOKE_CAMPAIGN,
    goal="short single-rotation surge (CI fast lane / golden scorecard)",
    phases=(
        DriftPhase(kind="protocol-mix", batches=4, anomaly_rate=0.3),
        DriftPhase(kind="rule-violating", batches=14, anomaly_rate=0.6,
                   sig_rotation=1),
        DriftPhase(kind="heavy-churn", batches=5, anomaly_rate=0.3,
                   sig_rotation=1),
    ),
    # short campaign: a tighter cooldown lets the loop land the install
    # early enough in the 14-batch surge to clear the recovery floor
    policy={"cooldown_ticks": 3},
))

register_campaign(Campaign(
    name="volumetric-ddos",
    goal="exhaust the flow table with fresh-id floods while slipping a "
         "rotated signature past the stale TCAM",
    phases=(
        DriftPhase(kind="protocol-mix", batches=4, anomaly_rate=0.3),
        DriftPhase(kind="protocol-mix", batches=12, anomaly_rate=0.6,
                   sig_rotation=1),
        DriftPhase(kind="burst", batches=10, anomaly_rate=0.5,
                   sig_rotation=1),
        DriftPhase(kind="heavy-churn", batches=6, anomaly_rate=0.3,
                   sig_rotation=1),
    ),
    policy={"cooldown_ticks": 3},
))

register_campaign(Campaign(
    name="slowloris",
    goal="hold many near-idle connections open to squat flow state, with "
         "violations trickling under a rotated signature",
    phases=(
        DriftPhase(kind="protocol-mix", batches=4, anomaly_rate=0.3),
        DriftPhase(kind="protocol-mix", batches=12, anomaly_rate=0.6,
                   sig_rotation=1),
        DriftPhase(kind="slowloris", batches=12, anomaly_rate=0.5,
                   sig_rotation=1),
        DriftPhase(kind="heavy-churn", batches=6, anomaly_rate=0.3,
                   sig_rotation=1),
    ),
    policy={"cooldown_ticks": 3},
))

register_campaign(Campaign(
    name="low-and-slow-exfil",
    goal="exfiltrate through a few very long flows at a low violation "
         "rate: the weakest novelty signal the loop must still catch",
    phases=(
        DriftPhase(kind="protocol-mix", batches=4, anomaly_rate=0.3),
        DriftPhase(kind="protocol-mix", batches=12, anomaly_rate=0.6,
                   sig_rotation=1),
        DriftPhase(kind="low-and-slow", batches=14, anomaly_rate=0.3,
                   sig_rotation=1),
    ),
    policy={"cooldown_ticks": 3},
))

register_campaign(Campaign(
    name="scan-evasion",
    goal="coordinated probe scan under a rotated signature: 2-packet "
         "flow shapes maximally unlike the rules' training traffic",
    phases=(
        DriftPhase(kind="protocol-mix", batches=4, anomaly_rate=0.3),
        DriftPhase(kind="protocol-mix", batches=12, anomaly_rate=0.6,
                   sig_rotation=1),
        DriftPhase(kind="port-scan", batches=10, anomaly_rate=0.6,
                   sig_rotation=1),
        DriftPhase(kind="heavy-churn", batches=6, anomaly_rate=0.3,
                   sig_rotation=1),
    ),
    policy={"cooldown_ticks": 3},
))

register_campaign(Campaign(
    name="flash-crowd",
    goal="benign control: DDoS-shaped arrival burst with zero rule "
         "violations — the gate must not reward blanket vetoing",
    phases=(
        DriftPhase(kind="protocol-mix", batches=5, anomaly_rate=0.0),
        DriftPhase(kind="burst", batches=8, anomaly_rate=0.0),
        DriftPhase(kind="protocol-mix", batches=5, anomaly_rate=0.0),
    ),
    benign=True,
    # benign burst shapes (churn spikes, handshake-marker surges) look
    # exactly like attack transients to the default detectors; a control
    # deployment that expects flash crowds runs them deliberately colder
    # so the loop does not re-learn (and install junk rules) from them
    policy={"sig_novelty": 0.15, "churn_shift": 0.4},
))
