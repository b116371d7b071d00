"""The port's elastic flow service (live resharding, flow-state checkpoints,
kill-a-shard recovery, tenant admission) against the JAX package's, on the
CPU, mirroring ``tests/test_elastic.py``.

The JAX package's ``ElasticFlowService(num_shards=1)`` and its
single-device ``FlowEngine`` run in process as the reference (its own tests
prove the multi-shard service equal to the single engine).  The tiny
classifier of ``tests/conftest.py`` with JAX's seed-0 weights bridged over,
compiled (``xla``, ``verify=False``) against the rule-violating seed-3
scenario's signature, so its flows trip real sticky vetoes.

Held identical: veto bits, trust == 1.0 pinning, signatures, ``pred``,
admission masks, shed counts, tenant residency and the ledger rows.  Float
scores within rtol 1e-4, atol 1e-5 (``tests/test_torch_flow_engine.py``'s
tolerance) wherever the two sides ran the flow step at other widths or in
other frameworks; within one package and one topology (a checkpoint
restored and replayed, a snapshot installed) they are bit-exact.

Also: a flow-state checkpoint written by JAX's 1-shard service restores
in the port's service, and the reverse, and both continue with identical
decisions.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import compile_program as j_compile_program
from repro.runtime.fault_tolerance import HeartbeatMonitor as JHeartbeatMonitor
from repro.serve import elastic as JE
from repro.serve.deploy import DeploySpec as JDeploySpec
from repro.serve.deploy import ElasticConfig as JElasticConfig
from repro.serve.deploy import TenantSpec as JTenantSpec
from repro.serve.flow_engine import FlowEngineConfig as JFlowEngineConfig
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.compile import compile_program
from repro_torch.data.pipeline import FlowScenario
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.serve.deploy import DeploySpec, ElasticConfig, Engine, TenantSpec
from repro_torch.serve.elastic import (
    ElasticFlowService,
    concat_snapshots,
    install_flow_state,
    select_rows,
    snapshot_flow_state,
    snapshot_template,
)
from repro_torch.serve.flow_engine import FlowEngineConfig
from repro_torch.train import classifier as TC

RTOL, ATOL = 1e-4, 1e-5
FLOATS = ("trust", "s_nn", "s_sym")
SCENARIO_SIG = tuple(int(t) for t in FlowScenario(kind="rule-violating", seed=3).anomaly_signature)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tiny_classifier_cfg):
    params, _ = JC.init_classifier(tiny_classifier_cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return (tiny_classifier_cfg, params, bridge.classifier_config_from_reference(
        tiny_classifier_cfg), tparams)


def _program(weights):
    _, _, tccfg, tparams = weights
    return compile_program(tccfg, tparams, backend="xla", verify=False,
                           rules=lambda c: TC.default_rules(c, np.asarray(SCENARIO_SIG),
                                                            device="cpu"))


def _jprogram(weights):
    jccfg, jparams, _, _ = weights
    return j_compile_program(jccfg, jparams, backend="xla", verify=False,
                             rules=lambda c: JC.default_rules(c, jnp.asarray(SCENARIO_SIG)))


def _service(weights, *, num_shards=1, capacity=64, lanes=8, t_cp_s=60.0,
             ecfg=ElasticConfig(), program=None):
    program = program if program is not None else _program(weights)
    return program.deploy(DeploySpec(
        engine="elastic", num_shards=num_shards, device="cpu", elastic=ecfg,
        flow=FlowEngineConfig(capacity=capacity, lanes=lanes, t_cp_s=t_cp_s)))


def _jservice(weights, *, capacity=64, lanes=8, ecfg=JElasticConfig()):
    return _jprogram(weights).deploy(JDeploySpec(
        engine="elastic", num_shards=1, elastic=ecfg,
        flow=JFlowEngineConfig(capacity=capacity, lanes=lanes, t_cp_s=60.0)))


def _batches(n, *, kind="rule-violating", pkt_len=8, packets_per_batch=48, seed=3):
    sc = FlowScenario(kind=kind, pkt_len=pkt_len, packets_per_batch=packets_per_batch, seed=seed)
    return [sc.next_batch() for _ in range(n)]


def assert_outputs_match(got, want, what="", exact=False):
    for k in ("vetoed", "sig", "pred"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{what} {k}")
    for k in FLOATS:
        if exact:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {k}")
    np.testing.assert_array_equal(got["trust"] == 1.0, got["vetoed"])


def _all_scores(svc):
    return {fid: svc.flow_scores(fid) for fid in svc.flow_ids()}


def assert_scores_match(got, want):
    assert got.keys() == want.keys()
    for fid, w in want.items():
        g = got[fid]
        assert (g["vetoed"], g["tokens"], g["pred"]) == (w["vetoed"], w["tokens"], w["pred"]), fid
        for k in FLOATS:
            assert g[k] == pytest.approx(w[k], rel=RTOL, abs=ATOL), (fid, k)


# --------------------------------------------------------------------------
# snapshot / install primitives
# --------------------------------------------------------------------------

def test_snapshot_matches_jax_one_shard(weights):
    svc, jsvc = _service(weights), _jservice(weights)
    for b in _batches(3):
        assert_outputs_match(svc.ingest(b["flow_ids"], b["tokens"]),
                             jsvc.ingest(b["flow_ids"], b["tokens"]))
    snap, jsnap = snapshot_flow_state(svc.engine), JE.snapshot_flow_state(jsvc.engine)
    assert len(snap["fids"]) == svc.resident_flows and (np.diff(snap["fids"]) > 0).all()
    for k in ("fids", "last_seen", "positions", "sig", "vetoed"):
        np.testing.assert_array_equal(snap[k], jsnap[k], err_msg=k)
        assert snap[k].dtype == jsnap[k].dtype, k
    np.testing.assert_allclose(snap["hidden_sum"], jsnap["hidden_sum"], rtol=RTOL, atol=1e-4)
    jleaves = jax.tree_util.tree_leaves(jsnap["caches"])
    leaves = [a for st in snap["caches"].values() for a in st.leaves()]
    assert len(leaves) == len(jleaves) == 5
    for a, b in zip(leaves, jleaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-4)
    tmpl = snapshot_template(svc.engine)
    for k in ("fids", "last_seen", "positions", "sig", "hidden_sum", "vetoed"):
        assert tmpl[k].dtype == snap[k].dtype and tmpl[k].shape[1:] == snap[k].shape[1:]


def test_select_concat_roundtrip(weights):
    svc = _service(weights, num_shards=2)
    for b in _batches(3):
        svc.ingest(b["flow_ids"], b["tokens"])
    snap = snapshot_flow_state(svc.engine)
    mask = snap["fids"] % 2 == 0
    evens, odds = select_rows(snap, mask), select_rows(snap, ~mask)
    merged = concat_snapshots(evens, odds)
    assert sorted(merged["fids"].tolist()) == snap["fids"].tolist()
    order = np.argsort(merged["fids"])
    np.testing.assert_array_equal(merged["caches"]["b0"].S[order], snap["caches"]["b0"].S)
    with pytest.raises(ValueError, match="overlapping"):
        concat_snapshots(evens, evens)


def test_install_over_capacity_raises_eq11(weights):
    svc = _service(weights, capacity=64)
    for b in _batches(4):
        svc.ingest(b["flow_ids"], b["tokens"])
    assert svc.resident_flows > 4
    tiny = _program(weights).deploy(DeploySpec(engine="sharded", num_shards=1, device="cpu",
                                               flow=FlowEngineConfig(capacity=4, lanes=8)))
    with pytest.raises(ValueError, match="Eq. 11"):
        install_flow_state(tiny, snapshot_flow_state(svc.engine), tick=svc.engine._tick)


@pytest.mark.parametrize("num_shards", [1, 3])
def test_install_roundtrip_preserves_scores(weights, num_shards):
    """snapshot → install onto a fresh engine of any shard count reproduces
    every per-flow score bit-exactly (a row's score reads only its row)."""
    svc = _service(weights)
    for b in _batches(4):
        svc.ingest(b["flow_ids"], b["tokens"])
    want = _all_scores(svc)
    fresh = _program(weights).deploy(DeploySpec(engine="sharded", num_shards=num_shards,
                                                device="cpu",
                                                flow=FlowEngineConfig(capacity=64, lanes=8)))
    install_flow_state(fresh, snapshot_flow_state(svc.engine), tick=svc.engine._tick)
    assert sorted(fresh.flow_ids()) == sorted(want) and fresh._tick == svc.engine._tick
    for fid, scores in want.items():
        assert fresh.flow_scores(fid) == scores, fid


# --------------------------------------------------------------------------
# reshard control
# --------------------------------------------------------------------------

def test_same_count_reshard_is_noop_and_quiesce_refuses_ingest(weights):
    svc = _service(weights)
    assert isinstance(svc, ElasticFlowService) and isinstance(svc, Engine)
    b = _batches(1)[0]
    svc.ingest(b["flow_ids"], b["tokens"])
    before = svc.engine
    rec = svc.reshard(1)
    assert svc.engine is before and svc.reshard_history[-1] is rec
    assert rec.reason.endswith("(no-op)") and rec.churn_ok
    assert rec.migrated_flows == 0 and not rec.rolled_back
    assert rec.as_dict()["old_shards"] == rec.as_dict()["new_shards"] == 1
    svc._resharding = True
    try:
        with pytest.raises(RuntimeError, match="quiesce"):
            svc.ingest(b["flow_ids"], b["tokens"])
    finally:
        svc._resharding = False
    assert svc.ingest(b["flow_ids"], b["tokens"])["admitted"].all()


def test_reshard_2_4_2_matches_unsharded_and_jax(weights):
    """A replay through reshard(2→4→2) against the port's single engine and
    JAX's, in the no-eviction regime: decisions identical, floats within
    tolerance, sticky veto bits and S = 1.0 pinning across topologies."""
    jccfg, jparams, _, _ = weights
    program = _program(weights)
    svc = _service(weights, num_shards=2, capacity=256, program=program)
    one = _program(weights).deploy(DeploySpec(flow=FlowEngineConfig(capacity=256, lanes=8),
                                              device="cpu"))
    jref = _jprogram(weights).deploy(JDeploySpec(flow=JFlowEngineConfig(capacity=256, lanes=8)))
    plan = {3: 4, 7: 2}
    for i, b in enumerate(_batches(12)):
        if i in plan:
            rec = svc.reshard(plan[i])
            assert not rec.rolled_back and rec.churn_ok, rec
            assert rec.install_s > 0.0 and rec.t_cp_s == 60.0 and svc.num_shards == plan[i]
            assert rec.migrated_flows == svc.resident_flows and 0 < rec.moved_flows
        got = svc.ingest(b["flow_ids"], b["tokens"])
        assert_outputs_match(got, one.ingest(b["flow_ids"], b["tokens"]), f"batch {i} (port)")
        assert_outputs_match(got, jref.ingest(b["flow_ids"], b["tokens"]), f"batch {i} (JAX)")
    want = {fid: jref.flow_scores(fid) for fid in jref.flow_ids()}
    assert_scores_match(_all_scores(svc), want)
    assert_scores_match(_all_scores(svc), {f: one.flow_scores(f) for f in one.flow_ids()})
    pinned = [f for f, s in want.items() if s["vetoed"]]
    assert pinned and all(svc.flow_scores(f)["trust"] == 1.0 for f in pinned)
    # the topology cache: both counts kept, resharding back reused the engine
    assert sorted(svc._engines) == [2, 4] and svc.engine is svc._engines[2]
    rows = [e for e in program.ledger.entries if e.stage == "flow-table-sharding"]
    assert len(rows) == 1 and "2 shard(s)" in rows[0].detail and "elastic" in rows[0].detail
    assert svc.stats.packets == one.stats.packets and svc.stats.flows_evicted == 0


def test_t_cp_violation_rolls_back(weights):
    svc = _service(weights, num_shards=2, t_cp_s=1e-12)
    for b in _batches(3):
        svc.ingest(b["flow_ids"], b["tokens"])
    want = _all_scores(svc)
    rec = svc.reshard(4)
    assert rec.rolled_back and not rec.churn_ok and "rolled back" in rec.error
    assert svc.num_shards == 2 and _all_scores(svc) == want  # old topology untouched
    assert svc._engines[4].resident_flows == 0  # the provisional rows were discarded
    b = _batches(4)[-1]
    assert len(svc.ingest(b["flow_ids"], b["tokens"])["trust"]) == len(b["flow_ids"])


# --------------------------------------------------------------------------
# checkpoint / restore
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_divergent_future_bit_exact(weights, tmp_path):
    svc = _service(weights, num_shards=2, ecfg=ElasticConfig(checkpoint_dir=str(tmp_path)))
    batches = _batches(6)
    for b in batches[:4]:
        svc.ingest(b["flow_ids"], b["tokens"])
    want_scores = _all_scores(svc)
    step = svc.checkpoint()
    tail_a = [svc.ingest(b["flow_ids"], b["tokens"]) for b in batches[4:]]
    assert svc.restore_checkpoint(step) == step
    assert _all_scores(svc) == want_scores
    tail_b = [svc.ingest(b["flow_ids"], b["tokens"]) for b in batches[4:]]
    for i, (a, b) in enumerate(zip(tail_a, tail_b)):
        assert_outputs_match(a, b, f"post-restore batch {i}", exact=True)


def test_restore_composes_with_swap_tables(weights, tmp_path):
    svc = _service(weights, ecfg=ElasticConfig(checkpoint_dir=str(tmp_path)))
    batches = _batches(4)
    for b in batches[:3]:
        svc.ingest(b["flow_ids"], b["tokens"])
    svc.restore_checkpoint(svc.checkpoint())
    # rules are live state, not checkpoint state: a swap after restore lands
    # on the restored topology and ingest keeps serving
    rec = svc.swap_tables(ruleset=TC.default_rules(svc.ccfg, np.array([410, 411]), device="cpu"))
    assert svc.swap_history[-1] is rec
    out = svc.ingest(batches[3]["flow_ids"], batches[3]["tokens"])
    assert len(out["trust"]) == len(batches[3]["flow_ids"])


def test_restore_without_dir_raises_and_autosave(weights, tmp_path):
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        _service(weights).restore_checkpoint()
    svc = _service(weights, ecfg=ElasticConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2))
    for b in _batches(4):
        svc.ingest(b["flow_ids"], b["tokens"])
    assert svc._ckpt_seq == 2 and svc._last_ckpt is not None  # ticks 2 and 4
    assert svc._ckpt.all_steps() == [0, 1]
    meta = svc._ckpt.manifest(1)["extra"]["elastic"]
    assert (meta["tick"], meta["num_shards"], meta["kind"]) == (4, 1, "periodic")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(weights, tmp_path, writer):
    """A flow-state checkpoint written by one package's 1-shard service
    restores in the other's, and both continue with identical decisions."""
    svc = _service(weights, ecfg=ElasticConfig(checkpoint_dir=str(tmp_path / "port")))
    jsvc = _jservice(weights, ecfg=JElasticConfig(checkpoint_dir=str(tmp_path / "jax")))
    batches = _batches(6)
    src = jsvc if writer == "jax" else svc
    for b in batches[:4]:
        src.ingest(b["flow_ids"], b["tokens"])
    src.checkpoint()
    if writer == "jax":
        svc._ckpt.directory = str(tmp_path / "jax")
        svc.restore_checkpoint()
    else:
        jsvc._ckpt.directory = str(tmp_path / "port")
        jsvc.restore_checkpoint()
    assert sorted(svc.flow_ids()) == sorted(jsvc.flow_ids())
    assert svc.engine._tick == jsvc.engine._tick == 4
    assert svc._tenant_of == jsvc._tenant_of and len(svc._tenant_of) == svc.resident_flows
    for i, b in enumerate(batches[4:]):
        assert_outputs_match(svc.ingest(b["flow_ids"], b["tokens"]),
                             jsvc.ingest(b["flow_ids"], b["tokens"]), f"batch {i}")
    assert_scores_match(_all_scores(svc), _all_scores(jsvc))


# --------------------------------------------------------------------------
# liveness and kill-a-shard recovery
# --------------------------------------------------------------------------

def test_heartbeat_timeout_matches_jax():
    t0 = time.monotonic()
    mons = HeartbeatMonitor(timeout_s=10.0), JHeartbeatMonitor(timeout_s=10.0)
    for mon in mons:
        mon.beat(0, step=1, t=t0)
        mon.beat(1, step=4, t=t0 + 8.0)
    for now in (9.0, 11.0, 30.0):
        assert mons[0].dead_workers(now=t0 + now) == mons[1].dead_workers(now=t0 + now)
    assert mons[0].dead_workers(now=t0 + 11.0) == [0]
    assert mons[0].laggards() == mons[1].laggards() == [0]


def test_service_merges_killed_and_lapsed_shards(weights):
    svc = _service(weights, num_shards=2, ecfg=ElasticConfig(heartbeat_timeout_s=1e-9))
    b = _batches(1)[0]
    svc.ingest(b["flow_ids"], b["tokens"])
    time.sleep(0.01)
    assert svc.dead_shards() == [0, 1]
    svc = _service(weights, num_shards=2)
    svc.ingest(b["flow_ids"], b["tokens"])
    assert svc.dead_shards() == []
    with pytest.raises(ValueError, match="no shard"):
        svc.kill_shard(3)
    lost = svc.kill_shard(1)
    assert svc.dead_shards() == [1] and lost and svc.engine.tables[1].resident == 0
    with pytest.raises(RuntimeError, match="no checkpoint"):
        svc.recover()


def test_kill_and_recover_equals_never_killed(weights, tmp_path):
    """Checkpoint → lose a shard → recover: survivors move live, lost flows
    come back from the checkpoint, the replay window re-ingests their
    post-checkpoint packets; afterwards every flow's decisions and scores
    equal a never-killed service's and JAX's never-killed 1-shard
    service's, sticky veto bits included."""
    ecfg = ElasticConfig(checkpoint_dir=str(tmp_path), replay_window=64)
    svc = _service(weights, num_shards=4, capacity=256, ecfg=ecfg)
    ref = _service(weights, num_shards=4, capacity=256)
    jref = _jservice(weights, capacity=256)
    batches = _batches(10)
    for i, b in enumerate(batches[:8]):
        for s in (svc, ref, jref):
            s.ingest(b["flow_ids"], b["tokens"])
        if i == 4:
            svc.checkpoint()
    lost = svc.kill_shard(2)
    assert lost and svc.dead_shards() == [2]
    rec = svc.recover()
    assert rec.reason == "recovery" and rec.new_shards == 3 == svc.num_shards
    assert rec.failed_shards == (2,) and 0 < rec.restored_flows <= len(lost)
    assert rec.replayed_packets > 0 and svc.dead_shards() == [] and rec.churn_ok
    # flows born on the lost shard after the checkpoint come back from replay alone
    assert rec.migrated_flows <= svc.resident_flows == ref.resident_flows
    for i, b in enumerate(batches[8:]):
        got = svc.ingest(b["flow_ids"], b["tokens"])
        assert_outputs_match(got, ref.ingest(b["flow_ids"], b["tokens"]), f"batch {i}")
        assert_outputs_match(got, jref.ingest(b["flow_ids"], b["tokens"]), f"batch {i} (JAX)")
    want = _all_scores(ref)
    assert_scores_match(_all_scores(svc), want)
    assert_scores_match(_all_scores(svc), _all_scores(jref))
    assert {f for f, s in _all_scores(svc).items() if s["vetoed"]} == {
        f for f, s in want.items() if s["vetoed"]} != set()


def test_replay_window_gap_refuses_then_allows_partial(weights, tmp_path):
    ecfg = ElasticConfig(checkpoint_dir=str(tmp_path), replay_window=2)
    svc = _service(weights, num_shards=2, capacity=256, ecfg=ecfg)
    batches = _batches(8)
    for b in batches[:2]:
        svc.ingest(b["flow_ids"], b["tokens"])
    svc.checkpoint()
    for b in batches[2:8]:  # 6 batches > the 2-deep replay buffer
        svc.ingest(b["flow_ids"], b["tokens"])
    svc.kill_shard(1)
    with pytest.raises(RuntimeError, match="replay window"):
        svc.recover()
    assert svc.num_shards == 2  # nothing committed
    rec = svc.recover(allow_partial=True)
    assert rec.new_shards == 1 == svc.num_shards and rec.replayed_packets >= 0


# --------------------------------------------------------------------------
# admission control, against JAX's 1-shard service
# --------------------------------------------------------------------------

def _admission_pair(weights):
    tenants = (("bronze", 0, 0.5), ("gold", 2, 1.0))
    svc = _service(weights, capacity=8, ecfg=ElasticConfig(
        tenants=tuple(TenantSpec(n, priority=p, share=s) for n, p, s in tenants)))
    jsvc = _jservice(weights, capacity=8, ecfg=JElasticConfig(
        tenants=tuple(JTenantSpec(n, priority=p, share=s) for n, p, s in tenants)))
    return svc, jsvc


def _pkts(fids):
    fids = np.asarray(fids, np.int64)
    return fids, np.full((len(fids), 8), 300, np.int32)


def _ingest_both(pair, fids, tenant):
    outs = [s.ingest(*_pkts(fids), tenant=tenant) for s in pair]
    np.testing.assert_array_equal(outs[0]["admitted"], outs[1]["admitted"])
    assert_outputs_match(outs[0], outs[1])
    svc, jsvc = pair
    assert (svc.shed_flows, svc.shed_packets) == (jsvc.shed_flows, jsvc.shed_packets)
    for name in svc.tenants:
        assert svc.tenant_resident(name) == jsvc.tenant_resident(name)
        assert svc.tenant_budget_flows(name) == jsvc.tenant_budget_flows(name)
    return outs[0]


def test_share_budget_caps_admission(weights):
    pair = _admission_pair(weights)
    svc = pair[0]
    assert svc.tenant_budget_flows("bronze") == 4  # 0.5 x 8 aggregate
    out = _ingest_both(pair, np.arange(6), "bronze")
    assert out["admitted"].sum() == 4 and svc.tenant_resident("bronze") == 4
    shed = ~out["admitted"]  # shed packets keep alignment with null outputs
    assert (out["trust"][shed] == 0).all() and (out["pred"][shed] == -1).all()
    assert not out["vetoed"][shed].any()


def test_pressure_sheds_lowest_priority_first(weights):
    pair = _admission_pair(weights)
    svc = pair[0]
    _ingest_both(pair, np.arange(6), "bronze")
    out = _ingest_both(pair, np.arange(100, 108), "gold")
    assert out["admitted"].all()  # gold's full share wins the table: bronze is evicted
    assert svc.tenant_resident("gold") == 8 and svc.tenant_resident("bronze") == 0
    assert svc.shed_flows["bronze"] >= 4
    out2 = _ingest_both(pair, np.arange(200, 203), "gold")  # past its own budget
    assert not out2["admitted"].any() and svc.shed_flows["gold"] == 3


def test_resident_flows_always_admitted(weights):
    pair = _admission_pair(weights)
    assert _ingest_both(pair, np.arange(4), "bronze")["admitted"].all()
    assert _ingest_both(pair, np.arange(4), "bronze")["admitted"].all()  # at budget
    assert pair[0].shed_packets.get("bronze", 0) == 0


def test_per_packet_tenants_and_unknown_tenant(weights):
    pair = _admission_pair(weights)
    svc = pair[0]
    out = _ingest_both(pair, [1, 2], ["bronze", "gold"])
    assert out["admitted"].all()
    assert svc.tenant_resident("bronze") == svc.tenant_resident("gold") == 1
    with pytest.raises(ValueError, match="per-packet"):
        svc.ingest(*_pkts([1, 2]), tenant=["bronze"])
    with pytest.raises(KeyError, match="silver"):
        svc.ingest(*_pkts([1]), tenant="silver")


def test_ledger_reflects_admission_as_jax(weights):
    pair = _admission_pair(weights)
    _ingest_both(pair, np.arange(6), "bronze")
    rows = []
    for s in pair:
        s._record_admission_entries()
        rows.append([(e.stage, e.resource, e.used, e.budget, e.detail)
                     for e in s.program.ledger.entries if e.stage == "admission-control"])
    assert rows[0] == rows[1]
    bronze = next(r for r in rows[0] if r[1] == "tenant[bronze]-flows")
    assert bronze[2:4] == (4, 4) and "shed 2 flow(s)" in bronze[4]
    pair[0].register_tenant(TenantSpec("silver", priority=1, share=0.25))
    assert pair[0].tenant_budget_flows("silver") == 2


def test_elastic_deploy_defaults_to_the_card(weights):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _program(weights).deploy(DeploySpec(engine="elastic", num_shards=2))
