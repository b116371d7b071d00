"""Fused ingest in the port: width-bucketed chunk stacks through the flow
step, on the CPU (the eager structure) and, in the ``cuda``-marked tests,
through one CUDA graph per width on the card.

Held on the CPU:

* ``pack_width_groups`` and ``_next_pow2`` equal the JAX package's;
* fused ≡ per-round in the port on FlowScenario ``mix``, ``rule-violating``
  and ``heavy-churn``, with a roomy table and under table pressure with
  ``idle_timeout``.  Decisions (veto bits, signatures, trust == 1.0 on every
  veto, the slot and eviction sequence, FlowStats) are identical, and so is
  ``s_sym``, a sum of rule weights that no product touches.  trust and s_nn
  are within rtol 1e-4 / atol 1e-5, not bit-equal: a chunk runs at its own
  power-of-two width where the per-round path pads to ``lanes``, and the
  CPU's matrix products sum in another order at another row count (about
  1e-7 apart).  ``pred`` is identical wherever the top-2 margin exceeds
  1e-4;
* the port's fused engine ≡ the JAX package's (``FlowEngineConfig(fused=
  True)``) under its ``xla`` backend with n_global 8 and under
  ``pallas-interpret`` with n_global 0 (``fused_ingest_pallas``, score
  kernel in interpret mode): the rules of ``tests/test_torch_flow_engine.py``;
* ``AsyncIngestPipeline``: bit-identical to synchronous fused ingest,
  backpressure bounds ``in_flight``, the sync wrapper equals
  ``engine.ingest``, a per-round engine raises;
* ``warm_fused``'s widths are the buckets ``pack_width_groups`` emits, and
  a batch whose widths recur gets distinct staging buffers per occurrence.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import FlowScenario as JFlowScenario
from repro.serve import flow_engine as JFE
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.data.pipeline import FlowScenario
from repro_torch.kernels.decode_step import ops as dops
from repro_torch.kernels.flow_ingest import ops as sops
from repro_torch.serve import flow_engine as TFE
from repro_torch.serve.ingest_pipeline import AsyncIngestPipeline
from repro_torch.train import classifier as TC

RTOL, ATOL = 1e-4, 1e-5
PRED_MARGIN = 1e-4
DECISIONS = ("vetoed", "sig")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(tiny_classifier_cfg, n_global=8):
    """The reference's tiny classifier (2 layers, d 32, d_head 16, m 16,
    L 16) with the given static-global set, in both packages."""
    arch = dataclasses.replace(
        tiny_classifier_cfg.arch,
        chimera=dataclasses.replace(tiny_classifier_cfg.arch.chimera, n_global=n_global),
    )
    ccfg = dataclasses.replace(tiny_classifier_cfg, arch=arch)
    params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(1))
    tccfg = bridge.classifier_config_from_reference(ccfg)
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return ccfg, params, tccfg, tparams


def _engines(tiny_classifier_cfg, scenario, **fcfg):
    """(per-round, fused) port engines from one set of weights."""
    _, _, ccfg, params = _port_model(tiny_classifier_cfg)
    rules = TC.default_rules(ccfg, scenario.anomaly_signature, device="cpu")
    legacy = TFE.FlowEngine(ccfg, params, rules, TFE.FlowEngineConfig(**fcfg), device="cpu")
    fused = TFE.FlowEngine(ccfg, params, rules, TFE.FlowEngineConfig(fused=True, **fcfg),
                           device="cpu")
    return legacy, fused


class _Logits:
    """Per-packet class logits of a fused port engine (for the margin rule):
    the packed step outputs' logits in result-row order, mapped to packets
    through the dispatch's layout."""

    def __init__(self, monkeypatch, engine):
        self.rows, self.pending = [], None
        real_pack, real_dispatch = TFE.pack_step_outputs, engine._dispatch_fused

        def pack(out):
            lg = out["class_logits"]
            self.rows.append(lg.reshape(-1, lg.shape[-1]).numpy().copy())
            return real_pack(out)

        def dispatch(*a, **k):
            self.rows = []
            self.pending = real_dispatch(*a, **k)
            return self.pending

        monkeypatch.setattr(TFE, "pack_step_outputs", pack)
        monkeypatch.setattr(engine, "_dispatch_fused", dispatch)

    def margins(self):
        logits = np.concatenate(self.rows)[self.pending.packet_rows()]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]


def _assert_same(a, b, margins=None):
    """Decisions identical, s_sym too, trust and s_nn within tolerance."""
    for k in DECISIONS:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert (a["trust"][a["vetoed"]] == 1.0).all() and (b["trust"][b["vetoed"]] == 1.0).all()
    clear = slice(None) if margins is None else margins > PRED_MARGIN
    np.testing.assert_array_equal(b["pred"][clear], a["pred"][clear])
    for k in ("trust", "s_nn", "s_sym"):
        np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL, err_msg=k)


# --------------------------------------------------------------------------
# the packer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lanes,min_lanes", [(16, 8), (8, 2), (32, 12), (24, 4)])
def test_pack_width_groups_matches_jax(seed, lanes, min_lanes):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, 40, size=int(rng.integers(1, 200))).astype(np.int32)
    want = JFE.pack_width_groups(slots, lanes, min_lanes)
    got = TFE.pack_width_groups(slots, lanes, min_lanes)
    assert [w for w, _ in got] == [w for w, _ in want]
    for (_, gc), (_, wc) in zip(got, want):
        assert len(gc) == len(wc)
        for a, b in zip(gc, wc):
            np.testing.assert_array_equal(a, b)
    for n in list(range(0, 70)) + [255, 256, 257, 4096]:
        assert TFE._next_pow2(n) == JFE._next_pow2(n)


# --------------------------------------------------------------------------
# fused ≡ per-round in the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mix", "rule-violating", "heavy-churn"])
@pytest.mark.parametrize("regime", ["roomy", "pressure"])
def test_fused_matches_per_round(tiny_classifier_cfg, monkeypatch, kind, regime):
    fcfg = (dict(capacity=512, lanes=16) if regime == "roomy"
            else dict(capacity=24, lanes=16, idle_timeout=2))
    sc = [FlowScenario(kind=kind, pkt_len=8, packets_per_batch=40, seed=11) for _ in range(2)]
    legacy, fused = _engines(tiny_classifier_cfg, sc[0], **fcfg)
    rec = _Logits(monkeypatch, fused)
    for _ in range(4):
        b1, b2 = sc[0].next_batch(), sc[1].next_batch()
        a = legacy.ingest(b1["flow_ids"], b1["tokens"])
        b = fused.ingest(b2["flow_ids"], b2["tokens"])
        _assert_same(a, b, rec.margins())
        np.testing.assert_array_equal(b["s_sym"], a["s_sym"])  # bit-equal
        assert fused.table.slot_of == legacy.table.slot_of
        assert fused.stats == legacy.stats  # rounds too: the same chunks
    if regime == "roomy":
        assert legacy.stats.flows_evicted == 0
    else:
        assert legacy.stats.flows_evicted > 0
    cap = legacy.fcfg.capacity  # the scratch row is padding's, unspecified
    for name in ("positions", "sig", "vetoed"):
        torch.testing.assert_close(getattr(fused, name)[:cap], getattr(legacy, name)[:cap],
                                   rtol=0, atol=0)
    torch.testing.assert_close(fused.hidden_sum[:cap], legacy.hidden_sum[:cap],
                               rtol=RTOL, atol=ATOL)


def test_recurring_widths_get_distinct_staging_buffers(tiny_classifier_cfg):
    """6 distinct flows x 2 packets at lanes 4: two arrival rounds, each a
    full-width chunk (w 4) then a 2-packet tail (w 2), so the widths run
    [4, 2, 4, 2]; every use within one dispatch has its own pinned-pool
    buffer, and the batch still matches the per-round engine."""
    sc = FlowScenario(kind="mix", pkt_len=8, packets_per_batch=40, seed=11)
    legacy, fused = _engines(tiny_classifier_cfg, sc, capacity=64, lanes=4, min_chunk_lanes=2)
    flow_ids = np.tile(np.arange(6), 2)
    tokens = np.random.default_rng(7).integers(0, 512, (12, 8)).astype(np.int32)
    slots, fresh = fused._resolve_slots(flow_ids)
    staging = {}
    b = fused._dispatch_fused(flow_ids, tokens, slots, fresh, staging=staging).finalize()
    assert sorted(k[:3] for k in staging) == [(2, 1, 8), (2, 1, 8), (4, 1, 8), (4, 1, 8)]
    assert {k[3] for k in staging} == {0, 1}
    assert len({buf.data_ptr() for buf in staging.values()}) == 4
    a = legacy.ingest(flow_ids, tokens)
    _assert_same(a, b)


def test_warm_fused_widths_are_the_packers_buckets(tiny_classifier_cfg):
    """min_chunk_lanes 12 at lanes 32: the packer emits widths 16 and 32
    (never 12 or 24), and those are the widths warm_fused makes ready."""
    sc = FlowScenario(kind="mix", pkt_len=8, packets_per_batch=40, seed=11)
    _, eng = _engines(tiny_classifier_cfg, sc, capacity=128, lanes=32, min_chunk_lanes=12)
    assert eng.fused_widths() == [16, 32]
    assert eng.warm_fused(pkt_len=8) == 2
    emitted = {w for n in range(1, 80)
               for w, _ in TFE.pack_width_groups(np.arange(n), 32, 12)}
    assert emitted == set(eng.fused_widths())
    assert eng.fused_graphs() == {}  # the CPU runs the step eagerly, no graph


# --------------------------------------------------------------------------
# the port's fused engine ≡ the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_global,backend", [(8, "xla"), (0, "pallas-interpret")])
def test_fused_engine_matches_jax_fused_engine(tiny_classifier_cfg, monkeypatch,
                                               n_global, backend):
    ccfg, params, tccfg, tparams = _port_model(tiny_classifier_cfg, n_global)
    sc = JFlowScenario(kind="rule-violating", pkt_len=8, packets_per_batch=24, seed=3)
    rules = JC.default_rules(ccfg, jnp.asarray(sc.anomaly_signature))
    fcfg = dict(capacity=10, lanes=8, idle_timeout=2, min_chunk_lanes=2)
    jeng = JFE.FlowEngine(ccfg, params, rules,
                          JFE.FlowEngineConfig(fused=True, backend=backend, **fcfg))
    teng = TFE.FlowEngine(
        tccfg, tparams,
        bridge.rules_from_numpy(*(np.asarray(a) for a in
                                  (rules.values, rules.masks, rules.weights, rules.hard)),
                                device="cpu"),
        TFE.FlowEngineConfig(fused=True, **fcfg), device="cpu",
    )
    rec = _Logits(monkeypatch, teng)
    vetoes = 0
    for _ in range(4):
        b = sc.next_batch()
        oj = jeng.ingest(b["flow_ids"], b["tokens"])
        ot = teng.ingest(b["flow_ids"], b["tokens"])
        _assert_same(oj, ot, rec.margins())
        assert teng.table.slot_of == jeng.table.slot_of
        assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
        vetoes += int(ot["vetoed"].sum())
    assert vetoes > 0 and teng.stats.flows_evicted_lru > 0


# --------------------------------------------------------------------------
# AsyncIngestPipeline
# --------------------------------------------------------------------------

def _scenario():
    return FlowScenario(kind="mix", pkt_len=8, packets_per_batch=40, seed=11)


def test_pipelined_replay_is_bit_identical_to_sync_ingest(tiny_classifier_cfg):
    _, sync = _engines(tiny_classifier_cfg, _scenario(), capacity=512, lanes=16)
    _, piped = _engines(tiny_classifier_cfg, _scenario(), capacity=512, lanes=16)
    pipe = AsyncIngestPipeline(piped, depth=3)
    s1, s2 = _scenario(), _scenario()
    want = []
    for _ in range(7):
        b1, b2 = s1.next_batch(), s2.next_batch()
        want.append(sync.ingest(b1["flow_ids"], b1["tokens"]))
        pipe.submit(b2["flow_ids"], b2["tokens"])
    got = pipe.drain()
    assert len(got) == len(want) and pipe.in_flight == 0
    for a, b in zip(want, got):
        for k in ("flow_ids", "trust", "vetoed", "pred", "s_nn", "s_sym", "sig"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_pipeline_backpressure_bounds_in_flight(tiny_classifier_cfg):
    _, fused = _engines(tiny_classifier_cfg, _scenario(), capacity=512, lanes=16)
    pipe = AsyncIngestPipeline(fused, depth=2)
    sc = _scenario()
    for _ in range(6):
        b = sc.next_batch()
        pipe.submit(b["flow_ids"], b["tokens"])
        assert pipe.in_flight <= 2
    assert len(pipe.drain()) == 6 and pipe.in_flight == 0


def test_pipeline_sync_wrapper_matches_engine_ingest(tiny_classifier_cfg):
    legacy, fused = _engines(tiny_classifier_cfg, _scenario(), capacity=512, lanes=16)
    pipe = AsyncIngestPipeline(fused)
    assert pipe.depth == fused.fcfg.ring_slots == 4
    s1, s2 = _scenario(), _scenario()
    for _ in range(3):
        b1, b2 = s1.next_batch(), s2.next_batch()
        _assert_same(legacy.ingest(b1["flow_ids"], b1["tokens"]),
                     pipe.ingest(b2["flow_ids"], b2["tokens"]))


def test_pipeline_requires_a_fused_engine(tiny_classifier_cfg):
    legacy, _ = _engines(tiny_classifier_cfg, _scenario(), capacity=64, lanes=8)
    with pytest.raises(ValueError, match="fused"):
        AsyncIngestPipeline(legacy)


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
        pytest.skip("needs an NVIDIA GPU: the fused path on the card runs CUDA graphs")
    return torch.device("cuda")


def _card_engines(tiny_classifier_cfg, **fcfg):
    """(per-round, fused) engines on the card from one set of weights."""
    sc = FlowScenario(kind="rule-violating", pkt_len=8, packets_per_batch=40, seed=5)
    _, _, ccfg, params = _port_model(tiny_classifier_cfg)
    rules = TC.default_rules(ccfg, sc.anomaly_signature, device="cuda")
    legacy = TFE.FlowEngine(ccfg, params, rules, TFE.FlowEngineConfig(**fcfg), device="cuda")
    fused = TFE.FlowEngine(ccfg, params, rules, TFE.FlowEngineConfig(fused=True, **fcfg),
                           device="cuda")
    return legacy, fused, sc


@pytest.mark.cuda
def test_captures_equal_widths_and_steady_state_captures_nothing(cuda, tiny_classifier_cfg):
    legacy, fused, sc = _card_engines(tiny_classifier_cfg, capacity=256, lanes=16)
    n = fused.warm_fused(pkt_len=8)
    assert n == len(fused.fused_graphs()) == len(fused.fused_widths())
    for _ in range(4):
        b = sc.next_batch()
        fused.ingest(b["flow_ids"], b["tokens"])
    assert len(fused.fused_graphs()) == n


@pytest.mark.cuda
def test_fused_launches_equal_per_round_launches_on_card(cuda, tiny_classifier_cfg):
    legacy, fused, sc = _card_engines(tiny_classifier_cfg, capacity=256, lanes=16)
    fused.warm_fused(pkt_len=8)
    b = sc.next_batch()
    counts = []
    for eng in (legacy, fused):
        dops.launches = sops.launches = 0
        eng.ingest(b["flow_ids"], b["tokens"])
        counts.append((dops.launches, sops.launches, eng.stats.rounds))
    rounds = legacy.stats.rounds
    layers = legacy.ccfg.arch.n_layers
    # per round: pkt_len tokens through every layer's decode_step, one flow_score
    assert counts[0] == counts[1] == (rounds * 8 * layers, rounds, rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("n_global", [0, 64])
def test_fused_engine_on_card_matches_per_round_cpu_and_eager(cuda, n_global):
    """chip_smoke's reference phase: the fused engine on the card against the
    per-round engine on the card and the fused engine on the CPU, and its
    graph replays against the same step run eagerly on the card."""
    _chip_smoke().phase_reference(n_global)


@pytest.mark.cuda
def test_smoke_configs_run_on_card_as_on_cpu(cuda):
    """Both smoke configs (d_head 16, m 16, L 16) through the hand-written
    kernels on the card, held to the same calls on the CPU."""
    _chip_smoke().phase_smoke_configs()
