"""The slice end to end: one FlowScenario replayed through the JAX
``FlowEngine`` and through the port's on the CPU (plain kernel versions).

Backends of the reference: ``xla`` with the tiny arch's n_global=8 (the
JAX package sends n_global > 0 down its jnp branch), and
``pallas-interpret`` with n_global=0 (its decode_step kernel in interpret
mode).  A small table forces LRU eviction and ``idle_timeout`` > 0 idle
eviction.

Held identical: hard-veto bits, trust == 1.0 pinning, cumulative
signatures, FlowStats and the slot/eviction sequence; ``pred`` wherever the
top-2 logit margin exceeds PRED_MARGIN.  Float scores (trust, s_nn, s_sym)
within rtol 1e-4, atol 1e-5: both sides are float32, but the two
frameworks sum in different orders, through 2 layers and up to hundreds of
decode steps per flow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import FlowScenario, arrival_rounds
from repro.serve.flow_engine import FlowEngine as JFlowEngine
from repro.serve.flow_engine import FlowEngineConfig as JFlowEngineConfig
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.serve import flow_engine as TFE
from repro_torch.train import classifier as TC

RTOL, ATOL = 1e-4, 1e-5
PRED_MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(tiny_classifier_cfg, n_global, backend, capacity=10, lanes=8, idle_timeout=2,
          scenario_seed=3):
    arch = dataclasses.replace(
        tiny_classifier_cfg.arch,
        chimera=dataclasses.replace(tiny_classifier_cfg.arch.chimera, n_global=n_global),
    )
    ccfg = dataclasses.replace(tiny_classifier_cfg, arch=arch)
    params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(1))
    sc = FlowScenario(kind="rule-violating", pkt_len=8, packets_per_batch=24, seed=scenario_seed)
    rules = JC.default_rules(ccfg, jnp.asarray(sc.anomaly_signature))
    jeng = JFlowEngine(ccfg, params, rules, JFlowEngineConfig(
        capacity=capacity, lanes=lanes, idle_timeout=idle_timeout, backend=backend))
    teng = TFE.FlowEngine(
        bridge.classifier_config_from_reference(ccfg),
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu"),
        bridge.rules_from_numpy(*(np.asarray(a) for a in
                                  (rules.values, rules.masks, rules.weights, rules.hard)), device="cpu"),
        TFE.FlowEngineConfig(capacity=capacity, lanes=lanes, idle_timeout=idle_timeout),
        device="cpu",
    )
    return jeng, teng, sc


class _LogitRecorder:
    """Per-packet class logits of the port's engine, for the margin rule:
    records each round's score-stage logits and the batch's slots."""

    def __init__(self, monkeypatch, engine):
        self.rounds, self.slots = [], None
        real_scores = TC.streaming_scores
        real_rounds = engine._ingest_rounds

        def scores(*a, **k):
            out, sticky = real_scores(*a, **k)
            self.rounds.append(out["class_logits"].numpy().copy())
            return out, sticky

        def ingest_rounds(flow_ids, tokens, slots, fresh):
            self.rounds, self.slots = [], slots.copy()
            return real_rounds(flow_ids, tokens, slots, fresh)

        monkeypatch.setattr(TC, "streaming_scores", scores)
        monkeypatch.setattr(engine, "_ingest_rounds", ingest_rounds)

    def margins(self, lanes):
        logits = np.empty((len(self.slots), self.rounds[0].shape[1]), np.float32)
        chunks = [r[c0:c0 + lanes] for r in arrival_rounds(self.slots.tolist())
                  for c0 in range(0, len(r), lanes)]
        for chunk, lg in zip(chunks, self.rounds):
            logits[chunk] = lg[: len(chunk)]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]


def _replay(jeng, teng, sc, monkeypatch, batches):
    rec = _LogitRecorder(monkeypatch, teng)
    vetoes = 0
    for _ in range(batches):
        b = sc.next_batch()
        oj = jeng.ingest(b["flow_ids"], b["tokens"])
        ot = teng.ingest(b["flow_ids"], b["tokens"])
        np.testing.assert_array_equal(ot["vetoed"], oj["vetoed"])
        np.testing.assert_array_equal(ot["sig"], oj["sig"])
        assert (ot["trust"][ot["vetoed"]] == 1.0).all()
        assert (oj["trust"][oj["vetoed"]] == 1.0).all()
        clear = rec.margins(teng.fcfg.lanes) > PRED_MARGIN
        np.testing.assert_array_equal(ot["pred"][clear], oj["pred"][clear])
        for k in ("trust", "s_nn", "s_sym"):
            np.testing.assert_allclose(ot[k], oj[k], rtol=RTOL, atol=ATOL)
        # the same flows sit in the same slots: identical eviction sequence
        assert teng.table.slot_of == jeng.table.slot_of
        assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
        vetoes += int(ot["vetoed"].sum())
    return vetoes


@pytest.mark.parametrize("n_global,backend", [(8, "xla"), (0, "pallas-interpret")])
def test_flowscenario_replay_matches_jax_engine(tiny_classifier_cfg, monkeypatch,
                                                n_global, backend):
    jeng, teng, sc = _pair(tiny_classifier_cfg, n_global, backend)
    vetoes = _replay(jeng, teng, sc, monkeypatch, batches=5)
    assert vetoes > 0  # the hard-veto branch was exercised
    s = teng.stats
    assert s.flows_evicted_lru > 0 and s.rounds > 5
    for fid in teng.flow_ids()[:4]:  # control-plane read path
        want, got = jeng.flow_scores(fid), teng.flow_scores(fid)
        assert got["vetoed"] == want["vetoed"] and got["tokens"] == want["tokens"]
        np.testing.assert_allclose(got["trust"], want["trust"], rtol=RTOL, atol=ATOL)


def test_idle_eviction_and_reset_match_jax_engine(tiny_classifier_cfg, monkeypatch):
    """Roomy table, so flows leave only through the idle sweep; then reset()
    and replay again (reused slots are lazily zeroed on both sides)."""
    jeng, teng, sc = _pair(tiny_classifier_cfg, 8, "xla", capacity=64, idle_timeout=1)
    _replay(jeng, teng, sc, monkeypatch, batches=3)
    assert teng.stats.flows_evicted_idle > 0 and teng.stats.flows_evicted_lru == 0
    jeng.reset()
    teng.reset()
    _replay(jeng, teng, sc, monkeypatch, batches=2)


def test_bfloat16_arch_keeps_fp32_flow_state_as_jax_engine(tiny_classifier_cfg):
    # the engine's Chimera state stays fp32 whatever the residual stream's
    # dtype (the reference passes dtype=float32), and the Eq. 11 budget counts it so
    _, fp32_eng, _ = _pair(tiny_classifier_cfg, 8, "xla")
    bf16 = dataclasses.replace(tiny_classifier_cfg,
                               arch=dataclasses.replace(tiny_classifier_cfg.arch, dtype="bfloat16"))
    jeng, teng, _ = _pair(bf16, 8, "xla")
    assert teng.ccfg.arch.dtype == "bfloat16"
    floats = [t for t in TFE._state_leaves(teng.caches) if t.dtype.is_floating_point]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    jfloats = [a for a in jax.tree_util.tree_leaves(jeng.caches) if jnp.issubdtype(a.dtype, jnp.floating)]
    assert jfloats and all(a.dtype == jnp.float32 for a in jfloats)
    assert teng.per_flow_state_bytes() == jeng.per_flow_state_bytes() == fp32_eng.per_flow_state_bytes()


def test_state_accounting_and_budget_match_jax_engine(tiny_classifier_cfg):
    jeng, teng, _ = _pair(tiny_classifier_cfg, 8, "xla")
    assert teng.per_flow_state_bytes() == jeng.per_flow_state_bytes()
    assert teng.resident_state_bytes() == jeng.resident_state_bytes()
    need = teng.resident_state_bytes()
    ccfg = teng.ccfg
    with pytest.raises(ValueError, match="Eq. 11"):
        TFE.FlowEngine(ccfg, teng.params, teng.rules,
                       TFE.FlowEngineConfig(capacity=10, lanes=8, state_budget_bytes=need - 1),
                       device="cpu")
    TFE.FlowEngine(ccfg, teng.params, teng.rules,
                   TFE.FlowEngineConfig(capacity=10, lanes=8, state_budget_bytes=need),
                   device="cpu")
