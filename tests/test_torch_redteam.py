"""The port's red-team gate and flow-serving launcher, on the CPU.

* The smoke campaign through the port's harness, with the JAX harness's
  weights bridged over (``_build_classifier`` monkeypatched), against a
  live ``repro.serve.redteam.run_campaign`` on the same campaign: every
  deterministic scorecard field identical (all but ``wall_s`` and
  ``installs_per_hour``; the per-batch veto/pred history included), both
  passing.  ``run_trace`` likewise.
* ``TrustInvariantTracker`` counts fabricated flips and pinning breaks;
  ``split_policy`` routes every campaign's overrides as JAX's does.
* The red-team CLI: exit 0 on a green gate (the port's own weights,
  ``--fast --device cpu``), 1 on a failing scorecard, ``--list``, and a
  raise for the default ``cuda`` device without a GPU.
* The launcher in-process: ``--adapt --adapt-sync``, ``--adapt --fused``
  (async), ``--campaign``, ``--trace sample`` and ``--fused`` with the
  staging ring, all ``--device cpu``; the sharding and elastic flags
  serve on the CPU (``--num-shards``, ``--elastic``, ``--reshard``,
  ``--checkpoint-dir``, ``--checkpoint-every``), their combinations the
  JAX launcher refuses are refused, and ``--host-devices`` raises.
* ``cuda``-marked: the pieces of ``chip_smoke.phase_adapt`` that run at the
  tiny width (card against CPU, and the gate on both).
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.data import campaigns as jcamp
from repro.serve import redteam as JR
from repro_torch import bridge
from repro_torch.data import campaigns as tcamp
from repro_torch.launch import flow_serve as F
from repro_torch.serve import redteam as R

NONDETERMINISTIC = ("wall_s", "installs_per_hour")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridged_classifier(vocab_size=512, device="cpu"):
    """The JAX harness's classifier (PRNGKey(0)) in the port's layout."""
    ccfg, params = JR._build_classifier(vocab_size)
    return (bridge.classifier_config_from_reference(ccfg),
            bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device=device))


@pytest.fixture(scope="module")
def bridged():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "_build_classifier", _bridged_classifier)
        yield


def _deterministic(card):
    d = card.as_dict()
    for k in NONDETERMINISTIC:
        d.pop(k)
    return d


@pytest.fixture(scope="module")
def smoke_cards(bridged):
    campaign = jcamp.get_campaign(jcamp.SMOKE_CAMPAIGN)
    jcard = JR.run_campaign(campaign, JR.RedTeamConfig(record_history=True))
    tcard = R.run_campaign(tcamp.get_campaign(tcamp.SMOKE_CAMPAIGN),
                           R.RedTeamConfig(record_history=True, device="cpu"))
    return jcard, tcard


def test_smoke_campaign_scorecard_equals_jax(smoke_cards):
    jcard, tcard = smoke_cards
    assert jcard.passed, jcard.failures
    assert tcard.passed, tcard.failures
    want, got = _deterministic(jcard), _deterministic(tcard)
    assert set(got) == set(want)
    for k in sorted(want):
        assert got[k] == want[k], f"scorecard field {k!r} differs from JAX's"
    assert tcard.installs > 0 and tcard.veto_flips == 0 == tcard.pinning_violations
    attack = [p for p in tcard.phases if p.sig_rotation][0]
    assert attack.accuracy["adaptive"] > attack.accuracy["static"]
    json.dumps(tcard.as_dict())


def test_sample_trace_scorecard_equals_jax(bridged):
    jcard, tcard = JR.run_trace(), R.run_trace(cfg=R.RedTeamConfig(device="cpu"))
    assert jcard.passed and tcard.passed, (jcard.failures, tcard.failures)
    assert _deterministic(tcard) == _deterministic(jcard)
    assert 0 < tcard.phases[0].veto_rate["static"] < 1
    assert "history" not in tcard.as_dict()


def test_tracker_counts_flips_and_pinning_breaks():
    t = R.TrustInvariantTracker()
    fids = np.array([7, 8])
    t.observe(fids, {"trust": np.array([1.0, 0.3]), "vetoed": np.array([True, False])})
    assert t.veto_flips == 0
    t.observe(fids, {"trust": np.array([0.5, 0.3]), "vetoed": np.array([False, False])})
    assert t.veto_flips == 1
    t = R.TrustInvariantTracker()
    t.observe(np.array([1, 2]), {"trust": np.array([0.9, 1.0]),
                                 "vetoed": np.array([True, False])})
    assert t.pinning_violations == 2
    t = R.TrustInvariantTracker()
    for _ in range(3):
        t.observe(np.array([1, 2]), {"trust": np.array([1.0, 0.2]),
                                     "vetoed": np.array([True, False])})
    assert (t.veto_flips, t.pinning_violations, t.packets, t.vetoed_packets) == (0, 0, 6, 3)


@pytest.mark.parametrize("name", jcamp.list_campaigns())
def test_split_policy_matches_jax(name):
    policy = jcamp.get_campaign(name).policy
    assert R.split_policy(policy) == JR.split_policy(policy)


def test_split_policy_routes_and_rejects():
    drift, loop_cfg = R.split_policy({"cooldown_ticks": 3, "relearn_veto_floor": 0.15})
    assert drift["cooldown_ticks"] == 3 and loop_cfg == {"relearn_veto_floor": 0.15}
    assert drift["warmup_ticks"] == R.DEFAULT_POLICY["warmup_ticks"]
    with pytest.raises(ValueError, match="neither"):
        R.split_policy({"sig_noveltyy": 0.1})
    assert R.RedTeamConfig().device == "cuda"


# --------------------------------------------------------------------------
# the red-team CLI
# --------------------------------------------------------------------------

def test_redteam_cli_green_gate_exits_0(smoke_cards, monkeypatch, tmp_path, capsys):
    """``--fast``: the smoke campaign (its scorecard from the replay above,
    not replayed again) and a live sample-trace replay."""
    monkeypatch.setattr(R, "run_campaign", lambda campaign, cfg: smoke_cards[1])
    out = tmp_path / "scorecards.json"
    assert R.main(["--fast", "--device", "cpu", "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["passed"] and len(payload["scorecards"]) == 2
    assert payload["scorecards"][0]["campaign"] == tcamp.SMOKE_CAMPAIGN
    assert "red-team gate OK" in capsys.readouterr().out


def test_redteam_cli_failing_scorecard_exits_1(monkeypatch, capsys):
    def failing(campaign, cfg):
        assert cfg.device == "cpu" and cfg.recovery_floor == 0.95
        return R.CampaignScorecard(campaign=campaign.name, goal=campaign.goal,
                                   benign=campaign.benign, phases=[],
                                   failures=["phase 1 (rule-violating): recovery 0.9 < 0.95"])

    monkeypatch.setattr(R, "run_campaign", failing)
    rc = R.main(["--campaigns", "smoke-surge,flash-crowd", "--skip-trace", "--device", "cpu",
                 "--recovery-floor", "0.95"])
    assert rc == 1
    captured = capsys.readouterr()
    assert "red-team gate FAILED: smoke-surge, flash-crowd" in captured.err
    assert captured.out.count("FAIL ") == 2


def test_redteam_cli_list_and_device(capsys):
    assert R.main(["--list"]) == 0
    listed = capsys.readouterr().out
    for name in tcamp.list_campaigns():
        assert name in listed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            R.main(["--fast", "--skip-trace"])


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

CPU = ["--device", "cpu", "--smoke"]


def _serve(argv):
    dep = F.build(F.parse_args(CPU + argv))
    res = F.serve(dep, keep=True)
    for out in res.outputs:
        np.testing.assert_array_equal(out["trust"] == 1.0, out["vetoed"])
    assert res.packets == sum(len(b["flow_ids"]) for b in res.batches)
    return dep, res


def test_launcher_adapt_sync_fires_and_installs(capsys):
    dep, res = _serve(["--adapt", "--adapt-sync", "--pkt-len", "8", "--batches", "10",
                       "--lanes", "16"])
    loop = dep.loop
    assert loop.cfg.sync and loop.installs >= 1 and loop.trigger_ticks[0] > 6  # in the surge
    assert loop.installs == loop.installs_within_budget
    assert dep.engine.stats.flows_evicted == 0
    lines = F.report(dep, res)
    assert lines[0].startswith("drift: ") and "adaptation (sync)" in lines[1]


def test_launcher_adapt_fused_async():
    dep, res = _serve(["--adapt", "--fused", "--pkt-len", "8", "--batches", "10"])
    assert not dep.loop.cfg.sync and dep.pipe is None and dep.warmed == 6
    assert dep.loop.history and all(r.install_tick >= r.tick for r in dep.loop.history)
    assert dep.loop._executor._shutdown


def test_launcher_campaign_pins_geometry_and_policy():
    dep, res = _serve(["--campaign", "smoke-surge", "--adapt-sync", "--batches", "10",
                       "--lanes", "16"])
    c = tcamp.get_campaign("smoke-surge")
    assert (dep.args.pkt_len, dep.args.packets, len(res.batches)) == (
        c.pkt_len, c.packets_per_batch, 10)
    assert dep.loop.policy.cooldown_ticks == 3 and dep.label == "campaign:smoke-surge"
    assert dep.loop.installs >= 1


def test_launcher_trace_and_fused_ring(capsys):
    dep, res = _serve(["--trace", "sample", "--packets", "512", "--lanes", "64"])
    assert dep.label == "trace:sample" and len(res.batches) == dep.scenario.batches_per_cycle
    assert dep.engine.stats.flows_evicted == 0
    dep, res = _serve(["--fused", "--batches", "2", "--pkt-len", "8", "--packets", "48"])
    assert dep.pipe is not None and len(res.outputs) == 2
    assert F.main(CPU + ["--batches", "1", "--pkt-len", "4", "--packets", "16",
                         "--lanes", "16"]) == 0
    assert "pkt/s" in capsys.readouterr().out


SHARD_RUN = ["--pkt-len", "4", "--packets", "32", "--lanes", "8", "--capacity", "256",
             "--batches", "6"]


@pytest.mark.parametrize("flag", ["--num-shards", "--elastic", "--reshard", "--checkpoint-dir",
                                  "--checkpoint-every"])
def test_launcher_sharding_flags_serve_on_cpu(flag, tmp_path):
    """Each sharding or elastic flag of the JAX package's launcher, served
    on the CPU: the engine kind it deploys, its reshard lines and its
    checkpoints, and the ``shards=`` field of the summary."""
    argv = {
        "--num-shards": ["--num-shards", "3"],
        "--elastic": ["--elastic"],
        "--reshard": ["--elastic", "--num-shards", "2", "--reshard", "2:4,4:2"],
        "--checkpoint-dir": ["--elastic", "--num-shards", "2", "--reshard", "3:1",
                             "--checkpoint-dir", str(tmp_path)],
        "--checkpoint-every": ["--elastic", "--checkpoint-every", "2"],
    }[flag]
    dep, res = _serve(argv + SHARD_RUN)
    eng = dep.engine
    lines = F.report(dep, res)
    assert f"shards={eng.num_shards} " in lines[-1]
    assert f"/{eng.aggregate_capacity} " in lines[-1]
    if flag == "--num-shards":
        assert type(eng).__name__ == "ShardedFlowEngine" and eng.num_shards == 3
        return
    assert type(eng).__name__ == "ElasticFlowService" and all(o["admitted"].all()
                                                              for o in res.outputs)
    if flag == "--reshard":
        assert [(i, r.old_shards, r.new_shards) for i, r in res.reshards] == [(2, 2, 4), (4, 4, 2)]
        assert lines[0].startswith("reshard @batch 2: 2->4 shards") and lines[1].endswith(" ok")
        assert eng.num_shards == 2 and all(r.churn_ok for _, r in res.reshards)
    elif flag == "--checkpoint-dir":
        assert eng.num_shards == 1 and eng._ckpt.all_steps() == [0]  # the reshard's snapshot
        assert eng._ckpt.manifest(0)["extra"]["elastic"]["kind"] == "reshard->1"
    elif flag == "--checkpoint-every":
        assert eng._ckpt is None and eng._ckpt_seq == 3  # in memory at ticks 2, 4, 6


def test_launcher_sharding_flags_raise():
    with pytest.raises(NotImplementedError, match="no counterpart on the card"):
        F.parse_args(CPU + ["--host-devices", "8"])


@pytest.mark.parametrize("argv,match", [
    (["--fused", "--num-shards", "2"], "--fused serves one engine"),
    (["--fused", "--elastic"], "--fused serves one engine"),
    (["--reshard", "4:2"], "--reshard needs --elastic"),
    (["--elastic", "--adapt"], "--adapt drives a fixed engine"),
    (["--elastic", "--campaign", "smoke-surge"], "--adapt drives a fixed engine"),
])
def test_launcher_refuses_sharding_combinations_as_jax(argv, match, capsys):
    with pytest.raises(SystemExit):
        F.parse_args(CPU + argv)
    assert match in capsys.readouterr().err


def test_launcher_refuses_cuda_without_gpu_and_mixed_sources():
    with pytest.raises(SystemExit):
        F.parse_args(CPU + ["--campaign", "smoke-surge", "--trace", "sample"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            F.build(F.parse_args(["--smoke"]))


# --------------------------------------------------------------------------
# on the card (skip without a GPU)
# --------------------------------------------------------------------------

def _chip_smoke():
    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the adapt phase runs the engines on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_adapt_card_vs_cpu(cuda):
    rec = _chip_smoke().adapt_card_vs_cpu()
    assert rec["triggers"] and rec["overlap"]


@pytest.mark.cuda
def test_adapt_gate_card_equals_cpu(cuda):
    rec = _chip_smoke().adapt_gate()
    assert rec["invariant_violations"] == 0


def test_scorecards_of_the_two_packages_share_their_fields():
    names = {f.name for f in dataclasses.fields(R.CampaignScorecard)}
    assert names == {f.name for f in dataclasses.fields(JR.CampaignScorecard)}
    assert {f.name for f in dataclasses.fields(R.RedTeamConfig)} == {
        f.name for f in dataclasses.fields(JR.RedTeamConfig)} | {"device"}
