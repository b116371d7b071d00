"""The port's sharded flow serving (N logical shards on one device) against
the JAX package, on the CPU.

The reference is the JAX package's single-device ``FlowEngine`` on the same
stream (its own tests prove sharded == single) and, in process, its
``ShardedFlowEngine(num_shards=1)``.  The tiny classifier of
``tests/conftest.py`` with JAX's seed-0 weights bridged over, ``xla``
backend, capacity 256 per shard (no eviction), lanes 8.

Held identical: hard-veto bits, trust == 1.0 pinning, cumulative
signatures, ``pred`` (every top-2 margin of these replays exceeds 1e-4),
the resident flows and FlowStats.  Float scores (trust, s_nn, s_sym)
within rtol 1e-4, atol 1e-5, the tolerance of
``tests/test_torch_flow_engine.py``: the port runs all shards in one launch
of width ``S * lanes``, so its matrix products see another row count than
the single engine's, and the JAX side sums in other orders anyway (measured
here: at most 6e-8 between the port's sharded and single engines).

Also: a swap mid-stream, LRU and idle eviction per shard, ``reset``, the
per-shard Eq. 11 refusal, the ``fused=True`` refusal, ``reshard_moves``
and ``plan_shard_recovery``, the ``flow-table-sharding`` ledger entry at
one shard, sharded int-emulation bit-exact to JAX's int engine, and an
``AdaptiveLoop`` over the sharded engine (its harvest against JAX's, and
its triggers and installs against the port's single-engine loop on the
canonical drift replay).  The ``cuda``-marked test runs
``chip_smoke.phase_shard`` on the card.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import compile_program as j_compile_program
from repro.data import pipeline as jpipe
from repro.runtime import fault_tolerance as jft
from repro.serve import adaptive_loop as JAL
from repro.serve.deploy import DeploySpec as JDeploySpec
from repro.serve.flow_engine import FlowEngine as JFlowEngine
from repro.serve.flow_engine import FlowEngineConfig as JFlowEngineConfig
from repro.serve.sharded_flow_engine import ShardedFlowEngine as JShardedFlowEngine
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.compile import compile_program
from repro_torch.data import pipeline as tpipe
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.serve import adaptive_loop as TAL
from repro_torch.serve.deploy import DeploySpec, Engine
from repro_torch.serve.flow_engine import FlowEngine, FlowEngineConfig
from repro_torch.serve.sharded_flow_engine import ShardedFlowEngine
from repro_torch.train import classifier as TC

RTOL, ATOL = 1e-4, 1e-5
BOUNDARY_SHARE = 0.02  # int-emulation packets whose scores may differ from JAX's (measured 0)
FLOATS = ("trust", "s_nn", "s_sym")
SCENARIO = dict(kind="rule-violating", pkt_len=8, packets_per_batch=48, seed=3)
N_BATCHES = 3


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


def _rules(weights, sig):
    jccfg, _, tccfg, _ = weights
    return (JC.default_rules(jccfg, jnp.asarray(sig)),
            TC.default_rules(tccfg, np.asarray(sig), device="cpu"))


def _sharded(weights, num_shards, rules=None, **fkw):
    _, _, tccfg, tparams = weights
    fkw.setdefault("capacity", 256)
    fkw.setdefault("lanes", 8)
    if rules is None:
        rules = _rules(weights, tpipe.FlowScenario(**SCENARIO).anomaly_signature)[1]
    return ShardedFlowEngine(tccfg, tparams, rules, FlowEngineConfig(**fkw),
                             num_shards=num_shards, device="cpu")


def assert_outputs_match(got, want, what=""):
    for k in ("vetoed", "sig", "pred"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{what} {k}")
    for k in FLOATS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")
    np.testing.assert_array_equal(got["trust"] == 1.0, got["vetoed"])


def assert_scores_match(got, want, what=""):
    assert (got["vetoed"], got["tokens"], got["pred"]) == (
        want["vetoed"], want["tokens"], want["pred"]), what
    for k in FLOATS:
        assert got[k] == pytest.approx(want[k], rel=RTOL, abs=ATOL), (what, k)


@pytest.fixture(scope="module")
def jax_stream(weights):
    """The rule-violating stream through JAX's single engine and its
    1-shard engine (bit-identical to each other, as the JAX package's own
    tests hold)."""
    jccfg, jparams, _, _ = weights
    sc = jpipe.FlowScenario(**SCENARIO)
    jrules = _rules(weights, sc.anomaly_signature)[0]
    fcfg = JFlowEngineConfig(capacity=256, lanes=8)
    single = JFlowEngine(jccfg, jparams, jrules, fcfg)
    one = JShardedFlowEngine(jccfg, jparams, jrules, fcfg, num_shards=1)
    batches, outs = [], []
    for i in range(N_BATCHES):
        b = sc.next_batch()
        o1, o2 = single.ingest(b["flow_ids"], b["tokens"]), one.ingest(b["flow_ids"], b["tokens"])
        for k in FLOATS + ("vetoed", "pred", "sig"):
            np.testing.assert_array_equal(np.asarray(o1[k]), np.asarray(o2[k]), err_msg=k)
        batches.append(b)
        outs.append(o1)
    return batches, outs, single, one


# --------------------------------------------------------------------------
# replay against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_replay_matches_jax(weights, jax_stream, num_shards):
    batches, outs, single, one = jax_stream
    eng = _sharded(weights, num_shards)
    vetoes = 0
    for i, (b, want) in enumerate(zip(batches, outs)):
        got = eng.ingest(b["flow_ids"], b["tokens"])
        assert_outputs_match(got, want, f"S={num_shards} batch {i}")
        vetoes += int(got["vetoed"].sum())
    assert vetoes > 0
    assert sorted(eng.flow_ids()) == sorted(single.flow_ids())
    for fid in single.flow_ids():
        assert_scores_match(eng.flow_scores(fid), single.flow_scores(fid), fid)
    st, js = eng.stats, single.stats
    assert (st.packets, st.tokens, st.flows_created, st.flows_evicted) == (
        js.packets, js.tokens, js.flows_created, 0)
    assert eng.resident_flows_per_shard() == [t.resident for t in eng.tables]
    assert eng.resident_flows == single.table.resident
    if num_shards == 1:  # one shard: JAX's 1-shard engine's slots, rounds and stats
        assert eng.tables[0].slot_of == one.tables[0].slot_of
        assert dataclasses.asdict(st) == dataclasses.asdict(one.stats)
    assert eng.per_flow_state_bytes() == one.per_flow_state_bytes()
    assert eng.shard_state_bytes() == one.shard_state_bytes()
    assert eng.resident_state_bytes() == num_shards * one.resident_state_bytes()


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sharded_equals_the_ports_single_engine(weights, num_shards):
    """One launch of width S x lanes against the single engine's launches of
    width lanes: decisions identical, floats within the stated tolerance;
    every shard's rounds ride one launch.  At one shard both engines run
    the same ingest on the same rows: outputs, slots and stats identical."""
    _, _, tccfg, tparams = weights
    sc = tpipe.FlowScenario(**SCENARIO)
    rules = TC.default_rules(tccfg, sc.anomaly_signature, device="cpu")
    single = FlowEngine(tccfg, tparams, rules, FlowEngineConfig(capacity=256, lanes=8),
                        device="cpu")
    eng = _sharded(weights, num_shards, rules=rules)
    for i in range(N_BATCHES):
        b = sc.next_batch()
        got, want = eng.ingest(b["flow_ids"], b["tokens"]), single.ingest(b["flow_ids"], b["tokens"])
        assert_outputs_match(got, want, f"batch {i}")
        if num_shards == 1:
            for k in FLOATS:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"batch {i} {k}")
    if num_shards == 1:
        assert eng.tables[0].slot_of == single.table.slot_of
        assert dataclasses.asdict(eng.stats) == dataclasses.asdict(single.stats)
    else:
        assert eng.stats.rounds < single.stats.rounds
    for fid in single.flow_ids():
        assert_scores_match(eng.flow_scores(fid), single.flow_scores(fid), fid)
    # each flow sits in its owner's directory, off the owner's scratch row
    for fid in eng.flow_ids():
        assert eng.tables[eng.shard_of(fid)].slot_of[fid] < eng.fcfg.capacity


def test_swap_mid_stream_matches_jax(weights):
    jccfg, jparams, _, _ = weights
    sig = (400, 401, 402, 403)
    jrules, trules = _rules(weights, sig)
    single = JFlowEngine(jccfg, jparams, jrules, JFlowEngineConfig(capacity=32, lanes=8))
    eng = _sharded(weights, 2, rules=trules, capacity=32)
    sc = tpipe.FlowScenario(kind="protocol-mix", pkt_len=8, packets_per_batch=32, seed=9)
    b = sc.next_batch()
    assert_outputs_match(eng.ingest(b["flow_ids"], b["tokens"]),
                         single.ingest(b["flow_ids"], b["tokens"]))
    w = np.asarray(jrules.weights) * 2.0
    r1, r2 = single.swap_tables(weights=w), eng.swap_tables(weights=w)
    assert r1.source == r2.source == "manual"
    assert eng.swap_history == [r2] and r2.install_s >= 0 and r2.churn_ok
    b = sc.next_batch()
    assert_outputs_match(eng.ingest(b["flow_ids"], b["tokens"]),
                         single.ingest(b["flow_ids"], b["tokens"]), "after the swap")
    np.testing.assert_array_equal(eng.rules.weights.numpy(), np.asarray(single.rules.weights))
    with pytest.raises(ValueError, match="swap_tables"):
        eng.swap_tables(weights=np.ones((3,), np.float32))


# --------------------------------------------------------------------------
# table management
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 2])
def test_lru_eviction_aggregates_per_shard(weights, num_shards):
    """Over-subscribed tiny tables: every fresh allocation is still resident
    or was LRU-evicted, in aggregate and per shard; at one shard the
    eviction sequence is JAX's 1-shard engine's."""
    eng = _sharded(weights, num_shards, capacity=4, lanes=4)
    jeng = None
    if num_shards == 1:
        jccfg, jparams, _, _ = weights
        jeng = JShardedFlowEngine(jccfg, jparams, _rules(weights, (400, 401, 402, 403))[0],
                                  JFlowEngineConfig(capacity=4, lanes=4), num_shards=1)
        eng = _sharded(weights, 1, rules=_rules(weights, (400, 401, 402, 403))[1],
                       capacity=4, lanes=4)
    for start in (0, 100, 200):  # 16 distinct flows per wave
        fids = np.arange(start, start + 16)
        toks = np.zeros((16, 8), np.int32)
        out = eng.ingest(fids, toks)
        if jeng is not None:
            assert_outputs_match(out, jeng.ingest(fids, toks), f"wave {start}")
            assert eng.tables[0].slot_of == jeng.tables[0].slot_of
    st = eng.stats
    assert st.flows_created == 48
    assert st.flows_evicted_lru == st.flows_created - eng.resident_flows
    assert eng.resident_flows == sum(t.resident for t in eng.tables) <= eng.aggregate_capacity
    assert all(t.resident <= eng.fcfg.capacity for t in eng.tables)
    if jeng is not None:
        assert dataclasses.asdict(st) == dataclasses.asdict(jeng.stats)


def test_idle_eviction_and_reset(weights):
    eng = _sharded(weights, 2, capacity=16, lanes=4, idle_timeout=1)
    toks = np.zeros((4, 8), np.int32)
    o1 = eng.ingest(np.arange(4), toks)  # tick 1
    eng.ingest(np.arange(10, 14), toks)  # tick 2
    eng.ingest(np.arange(20, 24), toks)  # tick 3: flows 0..3 now stale
    assert eng.stats.flows_evicted_idle >= 4
    assert all(f >= 10 for f in eng.flow_ids())
    assert eng.evict(20) and not eng.evict(20) and 20 not in eng.flow_ids()
    eng.reset()
    assert eng.resident_flows == 0 and eng.stats.packets == 0 and eng._tick == 0
    o2 = eng.ingest(np.arange(4), toks)  # reused slots are lazily zeroed
    for k in FLOATS + ("vetoed", "pred", "sig"):
        np.testing.assert_array_equal(o1[k], o2[k], err_msg=k)


def test_per_shard_budget_and_fused_refusals(weights):
    eng = _sharded(weights, 2, capacity=32)
    need = eng.shard_state_bytes()
    assert eng.resident_state_bytes() == 2 * need
    assert eng.aggregate_state_budget_bytes == 2 * eng.state_budget_bytes
    with pytest.raises(ValueError, match="budget"):
        _sharded(weights, 2, capacity=32, state_budget_bytes=need - 1)
    _sharded(weights, 4, capacity=32, state_budget_bytes=need)  # per shard, not in all
    with pytest.raises(ValueError, match="budget"):
        _sharded(weights, 1, capacity=32, state_budget_bytes=1024)
    with pytest.raises(NotImplementedError, match="fused=True"):
        _sharded(weights, 2, fused=True)
    with pytest.raises(ValueError, match="num_shards"):
        _sharded(weights, 0)


@pytest.mark.parametrize("old,new", [(1, 2), (2, 4), (4, 2), (4, 3), (3, 3)])
def test_reshard_moves_matches_jax(old, new):
    fids = np.arange(0, 5000, 7)
    np.testing.assert_array_equal(tpipe.reshard_moves(fids, old, new),
                                  jpipe.reshard_moves(fids, old, new))
    assert tpipe.reshard_moves([], old, new).shape == (0,)


@pytest.mark.parametrize("n,failed,tick", [(4, [2], 7), (2, [0, 1], 0), (3, [0, 0], 5)])
def test_plan_shard_recovery_matches_jax(n, failed, tick):
    t, j = tft.plan_shard_recovery(n, failed, tick), jft.plan_shard_recovery(n, failed, tick)
    assert dataclasses.asdict(t) == dataclasses.asdict(j) and t.valid == j.valid
    with pytest.raises(ValueError, match="outside"):
        tft.plan_shard_recovery(n, [n], tick)


# --------------------------------------------------------------------------
# the deploy surface
# --------------------------------------------------------------------------

def _programs(weights, backend="xla", sig=tuple(jpipe.FlowScenario(**SCENARIO).anomaly_signature)):
    jccfg, jparams, tccfg, tparams = weights
    jprog = j_compile_program(jccfg, jparams, backend=backend, verify=False,
                              rules=lambda c: JC.default_rules(c, jnp.asarray(sig)))
    tprog = compile_program(tccfg, tparams, backend=backend, verify=False,
                            rules=lambda c: TC.default_rules(c, np.asarray(sig), device="cpu"))
    return jprog, tprog


def test_sharding_ledger_entry_matches_jax(weights):
    jprog, tprog = _programs(weights)
    fcfg = dict(capacity=16, lanes=8)
    jeng = jprog.deploy(JDeploySpec(engine="sharded", flow=JFlowEngineConfig(**fcfg),
                                    num_shards=1))
    for _ in range(2):  # re-deploys refresh rather than duplicate the entry
        eng = tprog.deploy(DeploySpec(engine="sharded", flow=FlowEngineConfig(**fcfg),
                                      num_shards=1, device="cpu"))
    assert isinstance(eng, ShardedFlowEngine) and isinstance(eng, Engine)
    assert eng.program is tprog and eng.backend == "xla" and eng.fcfg.horizon == tprog.horizon

    def rows(prog):
        return [(e.stage, e.resource, e.used, e.budget, e.detail, e.ok)
                for e in prog.ledger.entries if e.stage == "flow-table-sharding"]

    assert rows(tprog) == rows(jprog) and len(rows(tprog)) == 1
    assert rows(tprog)[0][2] == eng.shard_state_bytes() == jeng.shard_state_bytes()
    four = tprog.deploy(DeploySpec(engine="sharded", flow=FlowEngineConfig(**fcfg),
                                   num_shards=4, device="cpu"))
    assert four.num_shards == 4 and "4 shard(s) x 16 flows/shard" in rows(tprog)[0][4]
    assert ShardedFlowEngine.from_program(tprog, FlowEngineConfig(**fcfg), num_shards=2,
                                          device="cpu").num_shards == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tprog.deploy(DeploySpec(engine="sharded", num_shards=2))


# --------------------------------------------------------------------------
# int-emulation
# --------------------------------------------------------------------------

def test_int_emulation_sharded_bit_exact_to_jax(weights):
    """The lowered tables are flow-independent: every shard reads the one
    copy.  Against the port's single int engine everything is bit-exact
    (the int32 accumulators included).  Against JAX's int engine the rule
    of ``tests/test_torch_int_emulation.py``: an element of a flow's int32
    accumulator may move by one rounding LSB per token (a decoded float
    within float32 rounding of a quantization boundary; such a flow is a
    boundary flow), and a packet whose quantized scores differ must lie on
    one, at most BOUNDARY_SHARE of the packets.  Measured here: 24 of 41
    flows are boundary flows, and no packet's scores differ."""
    jprog, tprog = _programs(weights, "int-emulation")
    fcfg = dict(capacity=256, lanes=8)
    jeng = jprog.deploy(JDeploySpec(flow=JFlowEngineConfig(**fcfg)))
    single = tprog.deploy(DeploySpec(flow=FlowEngineConfig(**fcfg), device="cpu"))
    eng = tprog.deploy(DeploySpec(engine="sharded", flow=FlowEngineConfig(**fcfg),
                                  num_shards=2, device="cpu"))
    assert eng.backend == "int-emulation" and eng.hidden_sum.dtype == torch.int32
    sc = tpipe.FlowScenario(**SCENARIO)
    vetoes, boundary, moved, n = 0, set(), 0, 0
    for i in range(N_BATCHES):
        b = sc.next_batch()
        got = eng.ingest(b["flow_ids"], b["tokens"])
        one = single.ingest(b["flow_ids"], b["tokens"])
        want = jeng.ingest(b["flow_ids"], b["tokens"])
        jhs = np.asarray(jeng.hidden_sum).astype(np.int64)
        for fid in jeng.flow_ids():
            s, slot = eng.shard_of(fid), eng.tables[eng.shard_of(fid)].slot_of[fid]
            hs = eng.hidden_sum[s, slot].numpy()
            np.testing.assert_array_equal(hs, single.hidden_sum[single.table.slot_of[fid]])
            delta = np.abs(hs - jhs[jeng.table.slot_of[fid]])
            assert (delta <= int(eng.positions[s, slot])).all(), fid
            if delta.any():
                boundary.add(fid)
        edge = np.array([f in boundary for f in b["flow_ids"].tolist()], bool)
        for k in FLOATS + ("vetoed", "pred", "sig"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=f"batch {i} {k}")
        for k in ("vetoed", "sig"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"batch {i} {k}")
        differ = np.zeros(len(edge), bool)
        for k in FLOATS + ("pred",):
            differ |= got[k] != np.asarray(want[k])
        assert not (differ & ~edge).any(), f"batch {i}: scores differ off the boundary flows"
        moved += int(differ.sum())
        n += len(edge)
        vetoes += int(got["vetoed"].sum())
    assert vetoes > 0 and moved <= BOUNDARY_SHARE * n, (moved, n)
    for fid in jeng.flow_ids():
        assert eng.flow_scores(fid) == single.flow_scores(fid), fid
        if fid not in boundary:
            assert eng.flow_scores(fid) == jeng.flow_scores(fid), fid
    w = np.asarray(jprog.rules.weights) * 0.5
    eng.swap_tables(weights=w)
    jeng.swap_tables(weights=w)
    np.testing.assert_array_equal(eng._int_tables["rule_w"].numpy(),
                                  np.asarray(jeng._int_tables["rule_w"]))


# --------------------------------------------------------------------------
# the adaptation loop over the sharded engine
# --------------------------------------------------------------------------

POLICY = dict(warmup_ticks=2, cooldown_ticks=4, sig_novelty=0.05, churn_shift=0.12)
HISTORY_FIELDS = ("tick", "fired_on", "installed", "rolled_back", "error", "delta_step",
                  "install_tick")


def _drift(mod):
    return mod.DriftScenario(phases=(
        mod.DriftPhase(kind="protocol-mix", batches=4, anomaly_rate=0.3),
        mod.DriftPhase(kind="rule-violating", batches=6, anomaly_rate=0.6, sig_rotation=1),
        mod.DriftPhase(kind="heavy-churn", batches=4, anomaly_rate=0.3, sig_rotation=1),
    ), pkt_len=8, packets_per_batch=48, seed=11)


def test_harvest_matches_jax_sharded_engine(weights):
    """The sharded harvest reads each shard's rows in slot order: at one
    shard, the rows JAX's loop harvests from its 1-shard engine."""
    sig = tuple(_drift(jpipe).phase_anomaly_signature(0))
    jprog, tprog = _programs(weights, sig=sig)
    fcfg = dict(capacity=64, lanes=16)
    jl = JAL.AdaptiveLoop(jprog.deploy(JDeploySpec(engine="sharded", num_shards=1,
                                                   flow=JFlowEngineConfig(**fcfg))))
    tl = TAL.AdaptiveLoop(tprog.deploy(DeploySpec(engine="sharded", num_shards=1,
                                                  flow=FlowEngineConfig(**fcfg), device="cpu")))
    js, ts = _drift(jpipe), _drift(tpipe)
    for _ in range(3):
        b, _ = js.next_batch(), ts.next_batch()
        jl.engine.ingest(b["flow_ids"], b["tokens"])
        tl.engine.ingest(b["flow_ids"], b["tokens"])
    for cap in (5, 32, 1000):
        np.testing.assert_allclose(tl._harvest_pooled(cap), jl._harvest_pooled(cap),
                                   rtol=RTOL, atol=ATOL)
    two = TAL.AdaptiveLoop(tprog.deploy(DeploySpec(engine="sharded", num_shards=2,
                                                   flow=FlowEngineConfig(**fcfg), device="cpu")))
    assert two._harvest_pooled(8) is None  # an empty table harvests nothing
    sc = _drift(tpipe)
    b = sc.next_batch()
    two.engine.ingest(b["flow_ids"], b["tokens"])
    eng = two.engine
    want = []
    for s, t in enumerate(eng.tables):  # shard by shard, slot order within each
        for slot in sorted(t.fid_of):
            want.append((eng.hidden_sum[s, slot] / max(int(eng.positions[s, slot]), 1)).numpy())
    np.testing.assert_array_equal(two._harvest_pooled(1000), np.stack(want))
    np.testing.assert_array_equal(two._harvest_pooled(3), np.stack(want[:3]))


def test_adaptive_loop_over_sharded_equals_single_loop(weights):
    """The canonical drift replay under sync loops: the loop over a 2-shard
    engine triggers and installs where the loop over the single engine does,
    with identical decisions and the same relearned tables."""
    sig = tuple(_drift(jpipe).phase_anomaly_signature(0))
    _, tprog = _programs(weights, sig=sig)
    loops = {}
    for kind, n in (("flow", None), ("sharded", 2)):
        eng = tprog.deploy(DeploySpec(engine=kind, num_shards=n, device="cpu",
                                      flow=FlowEngineConfig(capacity=512, lanes=16)))
        loops[kind] = TAL.AdaptiveLoop(eng, policy=TAL.DriftPolicy(**POLICY),
                                       cfg=TAL.AdaptiveLoopConfig(sync=True))
    outs = {k: loop.run(_drift(tpipe), 14) for k, loop in loops.items()}
    for loop in loops.values():
        loop.close()
    for i, (a, b) in enumerate(zip(outs["sharded"], outs["flow"])):
        assert_outputs_match(a, b, f"batch {i}")
    one, sharded = loops["flow"], loops["sharded"]
    assert sharded.installs >= 1 and sharded.trigger_ticks == one.trigger_ticks
    for a, b in zip(sharded.history, one.history):
        for f in HISTORY_FIELDS:
            assert getattr(a, f) == getattr(b, f), (f, a.tick)
        for k, v in b.trigger.items():
            assert a.trigger[k] == pytest.approx(v, abs=1e-6), (a.tick, k)
    for x, y in zip(sharded.engine.rules.tensors(), one.engine.rules.tensors()):
        assert torch.equal(x, y)
    assert sharded.engine.swap_history and all(r.source == "delta"
                                               for r in sharded.engine.swap_history)


# --------------------------------------------------------------------------
# on the card (skips without a GPU)
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_phase_shard_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the shard phase runs the engines on the card")
    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    rec = chip_smoke.phase_shard()
    assert min(rec["launches"].values()) > 0
