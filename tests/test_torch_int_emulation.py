"""The port's integer score path against the JAX package's, on the CPU.

* Fixed-point primitives (``FixedPointSpec``, ``quantize``, ``dequantize``,
  ``overflow_safe_horizon``, the Eq. 19 table) identical over a hypothesis
  sweep.
* ``lower_scores`` at the tiny classifier's width and at the paper's full
  width: the same ``IntScorePlan`` (the Thm A.3 bound within 1e-6: one of
  its terms is a float32 sum taken in another order), the same int tables
  and the same ledger rows.
* ``int_flow_score_plain`` bit-identical to JAX's ``int_flow_score`` on
  random int inputs with vetoed lanes, count 0, negative sums and hits on
  every rule, with and without head biases, with a negative LUT shift, and
  at the full-width shapes (d 256, K 8, W 24, M 300);
  ``reference_flow_score`` and ``dequantize_scores`` within 1e-6.
* The int-emulation engines, per-round and fused, replay FlowScenario
  against JAX's int-emulation engine: veto bits, trust == 1.0 exactly on
  vetoed packets, signatures, the slot/eviction sequence and FlowStats
  identical.  The two backbones sum in other orders, so a decoded float
  feature within float32 rounding of a quantization boundary rounds to a
  neighbouring integer: each token moves an element of the int32
  ``hidden_sum`` by at most 1 (held: |Δ| <= the flow's token count).  A flow
  whose ``hidden_sum`` has differed from JAX's is a *boundary flow*.  Every
  packet whose quantized scores or ``pred`` differ must lie on one;
  those packets are counted and bounded by BOUNDARY_SHARE of the packets.
  Measured here: ~1.6 % of the accumulator elements differ by 1, and the
  floor-division pooling and the shifts absorb every one of them (0
  packets differ).
* The full-width int deploy raises the same ``BudgetError`` (stage
  ``int-lowering``, resource ``trust-divergence``, 0.0583731 with seed-0
  weights) in both packages.
* ``swap_tables`` under int-emulation re-lowers the rule weights as JAX's
  does (the next batches match JAX's engine after the same swap), and the
  fused engine equals the per-round one after a swap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.compile import compile_delta as j_compile_delta
from repro.compile import compile_program as j_compile_program
from repro.compile import int_lowering as jil
from repro.compile.ledger import BudgetError as JBudgetError
from repro.configs import get_config
from repro.core import quantization as jq
from repro.core import symbolic as jsym
from repro.data.pipeline import FlowScenario as JFlowScenario
from repro.serve.deploy import DeploySpec as JDeploySpec
from repro.serve.flow_engine import FlowEngineConfig as JFlowEngineConfig
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.compile import BudgetError, compile_delta, compile_program
from repro_torch.compile import int_lowering as til
from repro_torch.core import quantization as tq
from repro_torch.core import symbolic as tsym
from repro_torch.data.pipeline import FlowScenario
from repro_torch.kernels.flow_ingest import int_ops
from repro_torch.serve.deploy import DeploySpec
from repro_torch.serve.flow_engine import FlowEngineConfig
from repro_torch.train import classifier as TC

BOUNDARY_SHARE = 0.02  # packets whose scores may differ (on boundary flows); measured 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trules(r):
    return bridge.rules_from_numpy(*(np.asarray(a) for a in (r.values, r.masks, r.weights,
                                                             r.hard)), device="cpu")


def _tparams(params):
    return bridge.params_from_jax(_np(params), device="cpu")


# --------------------------------------------------------------------------
# fixed-point primitives
# --------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(bits=st.sampled_from((8, 16, 32)), log2_scale=st.integers(-20, 6),
       seed=st.integers(0, 2**16), spread=st.floats(0.5, 8.0))
def test_fixed_point_primitives_match_jax(bits, log2_scale, seed, spread):
    scale = 2.0 ** log2_scale * 1.37
    jspec, tspec = jq.FixedPointSpec(bits, scale), tq.FixedPointSpec(bits, scale)
    assert (tspec.max_int, tspec.min_int, tspec.eta_q) == (jspec.max_int, jspec.min_int,
                                                           jspec.eta_q)
    x = (np.random.default_rng(seed).standard_normal(257) * spread * jspec.max_int
         * scale / 4).astype(np.float32)
    x[:4] = [0.5 * scale, -0.5 * scale, 1.5 * scale, 2.5 * scale]  # ties: half to even
    qj = np.asarray(jq.quantize(jnp.asarray(x), jspec))
    qt = tq.quantize(torch.from_numpy(x), tspec).numpy()
    assert qt.dtype == qj.dtype
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(tq.dequantize(torch.from_numpy(qt), tspec).numpy(),
                                  np.asarray(jq.dequantize(jnp.asarray(qj), jspec)))
    b_phi, r_v = spread * 3.1, 1.0 + seed % 7
    assert tq.overflow_safe_horizon(b_phi, r_v, tspec) == jq.overflow_safe_horizon(
        b_phi, r_v, jspec)
    T = seed % 5000
    assert tq.check_overflow(T, b_phi, r_v, tspec) == jq.check_overflow(T, b_phi, r_v, jspec)
    assert tq.quantization_error_bound(T, b_phi, r_v, tspec, 16, 8) == \
        jq.quantization_error_bound(T, b_phi, r_v, jspec, 16, 8)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 64), bits=st.sampled_from((8, 16)), seed=st.integers(0, 2**16))
def test_weight_table_compile_matches_jax(n, bits, seed):
    w = (np.random.default_rng(seed).standard_normal(n) * 3).astype(np.float32)
    tj, sj = jsym.compile_weights_to_table(jnp.asarray(w), jq.FixedPointSpec(bits), 1 << 30)
    tt, st_ = tsym.compile_weights_to_table(torch.from_numpy(w), tq.FixedPointSpec(bits),
                                            1 << 30)
    assert (st_.bits, st_.scale) == (sj.bits, sj.scale)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(tsym.decompile_table(tt, st_).numpy(),
                                  np.asarray(jsym.decompile_table(tj, sj)))
    with pytest.raises(ValueError, match="Eq. 19"):
        tsym.compile_weights_to_table(torch.from_numpy(w), tq.FixedPointSpec(bits), n * bits - 1)


def test_stochastic_quantize_is_unbiased():
    spec = tq.FixedPointSpec(16, 0.25)
    x = torch.full((20000,), 0.3 * 0.25)
    q = tq.quantize(x, spec, generator=torch.Generator().manual_seed(0))
    assert set(q.unique().tolist()) == {0, 1}
    assert abs(float(q.float().mean()) - 0.3) < 0.02


# --------------------------------------------------------------------------
# lower_scores: plan, tables, ledger rows
# --------------------------------------------------------------------------

def _full_width():
    ccfg = JC.ClassifierConfig(arch=get_config("chimera-dataplane"), n_classes=8,
                               marker_base=256)
    params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(0))
    return ccfg, params


def _rows(entries):
    return [(e.stage, e.resource, e.used, e.budget, e.waived) for e in entries]


def assert_plans_equal(tp, jp):
    a, b = dataclasses.asdict(tp), dataclasses.asdict(jp)
    assert a.pop("divergence") == pytest.approx(b.pop("divergence"), abs=1e-6)
    assert a == b


def assert_rows_equal(t_entries, j_entries):
    assert len(t_entries) == len(j_entries)
    for t, j in zip(_rows(t_entries), _rows(j_entries)):
        assert t[:2] == j[:2] and t[3:] == j[3:]
        assert t[2] == pytest.approx(j[2], abs=1e-6, rel=0), t


@pytest.mark.parametrize("width", ["tiny", "full"])
@pytest.mark.parametrize("cfg", [jil.IntLoweringConfig(),
                                 jil.IntLoweringConfig(lut_bits=16, score_frac=8)],
                         ids=["default", "lut16"])
def test_lower_scores_matches_jax(tiny_classifier_cfg, width, cfg):
    if width == "tiny":
        ccfg = tiny_classifier_cfg
        params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(0))
    else:
        ccfg, params = _full_width()
    rules = JC.default_rules(ccfg, jnp.asarray(JFlowScenario(kind="mix").anomaly_signature))
    jp, jt, je = jil.lower_scores(ccfg, params, rules, cfg=cfg)
    tcfg = til.IntLoweringConfig(**dataclasses.asdict(cfg))
    tp, tt, te = til.lower_scores(bridge.classifier_config_from_reference(ccfg),
                                  _tparams(params), _trules(rules), cfg=tcfg)
    assert_plans_equal(tp, jp)
    # the plan and the config's widths lie inside the kernel's contract
    assert int_ops.contract(d=ccfg.arch.d_model, K=ccfg.n_classes, W=24, M=1, plan=tp) is None
    assert tt.keys() == jt.keys()
    for k in jt:
        assert tt[k].dtype == torch.int32, k
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]), err_msg=k)
    assert_rows_equal(te, je)
    if width == "full" and cfg == jil.IntLoweringConfig():
        # the paper's width at seed-0 weights: the head MACs sit at exactly
        # 32 of 32 bits and the Thm A.3 bound is over its budget
        row = {(e.resource): e for e in te}
        assert row["class-matmul-bits"].used == 32
        assert row["trust-divergence"].used == pytest.approx(0.0583731, abs=1e-6)


# --------------------------------------------------------------------------
# int_flow_score: plain version vs JAX, bit for bit
# --------------------------------------------------------------------------

def _int_case(ccfg, params, M, W, B, seed, cfg=jil.IntLoweringConfig(), bias=False):
    """A lowered plan and random int inputs: hits on every rule, vetoed
    lanes, count-0 lanes and negative sums."""
    rng = np.random.default_rng(seed)
    if bias:
        params = dict(params)
        K = params["cls"]["w"].shape[1]
        params["cls"] = {**params["cls"], "b": jnp.asarray(rng.standard_normal(K), jnp.float32)}
        params["anom"] = {**params["anom"], "b": jnp.asarray([0.7], jnp.float32)}
    sig = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    masks = rng.integers(0, 2**32, (M, W), dtype=np.uint64).astype(np.uint32)
    masks &= rng.integers(0, 2**32, (M, W), dtype=np.uint64).astype(np.uint32)
    src = rng.integers(0, B, M)
    values = sig[src].copy()  # rule r hits (at least) lane src[r]
    flip = np.arange(M) % 5 == 4  # these rules hit nobody (or by chance)
    values[flip] ^= masks[flip]
    rules = jsym.RuleSet(values=jnp.asarray(values), masks=jnp.asarray(masks),
                         weights=jnp.asarray(rng.standard_normal(M) * 2, jnp.float32),
                         hard=jnp.asarray(rng.random(M) < 0.3))
    plan, tables, _ = jil.lower_scores(ccfg, params, rules, cfg=cfg)
    d = ccfg.arch.d_model
    count = rng.integers(0, 300, B).astype(np.int32)
    count[:3] = 0
    lim = (2 ** 15) * np.maximum(count, 1)[:, None]
    hs = (rng.uniform(-1, 1, (B, d)) * lim).astype(np.int32)
    hs[3] = -np.abs(hs[3])
    sticky = rng.random(B) < 0.15
    return plan, tables, rules, hs, count, sig, sticky


def _both(plan, tables, rules, hs, count, sig, sticky, fn="int_flow_score"):
    jout, jst = getattr(jil, fn)(plan, tables, rules, jnp.asarray(hs), jnp.asarray(count),
                                 jnp.asarray(sig), jnp.asarray(sticky))
    tplan = til.IntScorePlan(**dataclasses.asdict(plan))
    ttab = {k: torch.from_numpy(np.array(v)) for k, v in tables.items()}
    tout, tst = getattr(til, fn)(tplan, ttab, _trules(rules), torch.from_numpy(hs),
                                 torch.from_numpy(count),
                                 torch.from_numpy(sig.view(np.int32)), torch.from_numpy(sticky))
    return (jout, jst), (tout, tst), tplan


INT_CASES = {
    "tiny-M1": dict(M=1, W=8, B=64, seed=1),
    "tiny-M37": dict(M=37, W=8, B=64, seed=2),
    "tiny-bias": dict(M=9, W=8, B=48, seed=3, bias=True),
    "tiny-lut-shift-negative": dict(M=5, W=8, B=48, seed=4,
                                    cfg=jil.IntLoweringConfig(lut_bits=16, score_frac=8)),
    "full-M300-W24": dict(M=300, W=24, B=256, seed=5, full=True),
}


@pytest.mark.parametrize("case", list(INT_CASES))
def test_int_flow_score_plain_is_bit_identical_to_jax(tiny_classifier_cfg, case):
    kw = dict(INT_CASES[case])
    if kw.pop("full", False):
        ccfg, params = _full_width()
    else:
        ccfg = tiny_classifier_cfg
        params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(0))
    plan, tables, rules, hs, count, sig, sticky = _int_case(ccfg, params, **kw)
    (jout, jst), (tout, tst), tplan = _both(plan, tables, rules, hs, count, sig, sticky)
    assert tout.keys() == jout.keys()
    for k in jout:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
        assert tout[k].dtype == (torch.bool if k == "hard_hit" else torch.int32), k
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    hits = np.asarray(jsym.ternary_match(jnp.asarray(sig), rules))
    assert hits.any(axis=0)[np.arange(rules.n_rules) % 5 != 4].all()  # every planted rule hit
    assert np.asarray(jout["hard_hit"]).any() and not np.asarray(jout["hard_hit"]).all()
    assert (np.asarray(jout["s_nn_q"]) < 0).any()
    if plan.lut_shift < 0:
        assert case == "tiny-lut-shift-negative"
    # the wrapper on CPU tensors is the plain version, and counts no launch
    before = int_ops.launches
    ttab = {k: torch.from_numpy(np.array(v)) for k, v in tables.items()}
    wout, _ = int_ops.int_flow_score(tplan, ttab, _trules(rules), torch.from_numpy(hs),
                                     torch.from_numpy(count),
                                     torch.from_numpy(sig.view(np.int32)),
                                     torch.from_numpy(sticky))
    assert int_ops.launches == before
    for k in jout:
        np.testing.assert_array_equal(wout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    # dequantized for the engine's float contract: exact 2^-f scales
    jd, td = jil.dequantize_scores(plan, jout), til.dequantize_scores(tplan, tout)
    for k in ("trust", "s_nn", "s_sym"):
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(td["trust"].numpy() == 1.0, np.asarray(jout["hard_hit"]))


@pytest.mark.parametrize("case", ["tiny-M37", "tiny-bias"])
def test_reference_flow_score_matches_jax(tiny_classifier_cfg, case):
    ccfg = tiny_classifier_cfg
    params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(0))
    plan, tables, rules, hs, count, sig, sticky = _int_case(ccfg, params, **INT_CASES[case])
    (jout, jst), (tout, tst), _ = _both(plan, tables, rules, hs, count, sig, sticky,
                                       fn="reference_flow_score")
    # the heads are float32 sums of d products taken in another order: within
    # 1e-6 of the sum of the products' magnitudes (a few float32 ulps of it)
    pooled = hs.astype(np.float64) * 2.0 ** -plan.feature_frac / np.maximum(count, 1)[:, None]
    for k, w in (("class_logits", tables["cls_w"]), ("s_nn", tables["anom_w"])):
        w = np.asarray(w, np.float64) * 2.0 ** -(plan.cls_frac if k == "class_logits"
                                                  else plan.anom_frac)
        mag = (np.abs(pooled) @ np.abs(w)).reshape(np.asarray(jout[k]).shape)
        err = np.abs(tout[k].numpy().astype(np.float64) - np.asarray(jout[k]))
        assert (err <= 1e-6 * mag + 1e-6).all(), (k, float(err.max()))
    for k in ("s_sym", "trust"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(tout["hard_hit"].numpy(), np.asarray(jout["hard_hit"]))


def test_int_wrapper_checks_shapes_and_devices(tiny_classifier_cfg):
    ccfg = tiny_classifier_cfg
    params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(0))
    plan, tables, rules, hs, count, sig, sticky = _int_case(ccfg, params, M=2, W=8, B=8, seed=6)
    tplan = til.IntScorePlan(**dataclasses.asdict(plan))
    ttab = {k: torch.from_numpy(np.array(v)) for k, v in tables.items()}
    args = [torch.from_numpy(hs), torch.from_numpy(count), torch.from_numpy(sig.view(np.int32)),
            torch.from_numpy(sticky)]
    with pytest.raises(ValueError, match="count is"):
        int_ops.int_flow_score(tplan, ttab, _trules(rules), args[0], args[1].long(), *args[2:])
    meta = [a.to("meta") for a in args]
    mtab = {k: v.to("meta") for k, v in ttab.items()}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        int_ops.int_flow_score(tplan, mtab, _trules(rules).to("meta"), *meta)
    assert int_ops.contract(d=256, K=8, W=24, M=300, plan=tplan) is None
    bad = dataclasses.replace(tplan, nn_shift=40)
    assert "out of range" in int_ops.contract(d=256, K=8, W=24, M=1, plan=bad)


N_INT_EDGES = 12  # len(chip_smoke.INT_EDGES)


def test_int_fast_path_asks_the_launcher_for_cuda_tensors_only():
    """``fast_path`` reports the C launcher's own choice, so it has nothing
    to say about CPU tensors (the plain version runs there)."""
    c = _chip_smoke()
    plan, tables, rules, hs, count, sig, sticky = c.int_adversarial_case(
        *c.INT_EDGES[0], c.SEED + 80, "cpu")
    with pytest.raises(ValueError, match="no kernel path"):
        int_ops.fast_path(tables, rules, sig)


@pytest.mark.parametrize("i", range(N_INT_EDGES))
def test_int_flow_score_adversarial_inputs_plain_is_bit_identical_to_jax(i):
    """chip_smoke's adversarial int cases (full-range int32 weights and sums,
    INT32_MIN/MAX, divisors 0 to 2^31 - 1, shifts 0 and 31, a negative LUT
    shift), which the card's kernel is held to through the plain version:
    the plain version equals JAX's int_flow_score bit for bit, and the
    wrapper on CPU tensors is the plain version."""
    c = _chip_smoke()
    assert len(c.INT_EDGES) == N_INT_EDGES and 0 < c.INT_EDGE_FAST < N_INT_EDGES
    edge = c.INT_EDGES[i]
    plan, tables, rules, hs, count, sig, sticky = c.int_adversarial_case(
        *edge, c.SEED + 80 + i, "cpu")
    B, d, K, W, M, n_lut, _ = edge
    assert int_ops.contract(d=d, K=K, W=W, M=M, plan=plan) is None
    before = int_ops.launches
    tout, tst = int_ops.int_flow_score(plan, tables, rules, hs, count, sig, sticky)
    assert int_ops.launches == before
    jrules = jsym.RuleSet(values=jnp.asarray(rules.values.numpy().view(np.uint32)),
                          masks=jnp.asarray(rules.masks.numpy().view(np.uint32)),
                          weights=jnp.asarray(rules.weights.numpy()),
                          hard=jnp.asarray(rules.hard.numpy()))
    jout, jst = jil.int_flow_score(
        jil.IntScorePlan(**dataclasses.asdict(plan)),
        {k: jnp.asarray(v.numpy()) for k, v in tables.items()}, jrules, jnp.asarray(hs.numpy()),
        jnp.asarray(count.numpy()), jnp.asarray(sig.numpy().view(np.uint32)),
        jnp.asarray(sticky.numpy()))
    for k in jout:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert (hs.numpy() == np.iinfo(np.int32).min).any() and (count.numpy() == 0).any()
    if M:
        assert tout["hard_hit"].any() and (tout["s_sym_q"] != 0).any()


# --------------------------------------------------------------------------
# the int-emulation engines against JAX's
# --------------------------------------------------------------------------

def _scenario(cls):
    return cls(kind="mix", vocab_size=512, pkt_len=8, packets_per_batch=48, seed=11)


def _programs(tiny_classifier_cfg, backend):
    ccfg = tiny_classifier_cfg
    params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(0))
    sig = _scenario(JFlowScenario).anomaly_signature
    jprog = j_compile_program(ccfg, params, rules=lambda c: JC.default_rules(c, jnp.asarray(sig)),
                              backend=backend, verify=False)
    tprog = compile_program(bridge.classifier_config_from_reference(ccfg), _tparams(params),
                            rules=lambda c: TC.default_rules(c, sig, device="cpu"),
                            backend=backend, verify=False)
    return jprog, tprog


class BoundaryTracker:
    """Flows whose int32 ``hidden_sum`` row has ever differed from JAX's;
    holds every difference to at most one LSB per token."""

    def __init__(self):
        self.flows = set()

    def update(self, jeng, teng, flow_ids):
        jhs = np.asarray(jeng.hidden_sum).astype(np.int64)
        ths = teng.hidden_sum.numpy().astype(np.int64)
        pos = teng.positions.numpy()
        for fid, slot in teng.table.slot_of.items():
            delta = np.abs(jhs[slot] - ths[slot])
            assert (delta <= pos[slot]).all(), (fid, int(delta.max()), int(pos[slot]))
            if delta.any():
                self.flows.add(fid)
        return np.array([f in self.flows for f in np.asarray(flow_ids).tolist()], bool)


def int_replay(jeng, tengs, scenario, batches, swaps=()):
    """Replay through JAX's engine and each port engine, calling the i-th
    of ``swaps`` before batch i + 1; returns the number of packets and, per
    port engine, of packets whose scores differ."""
    trackers = [BoundaryTracker() for _ in tengs]
    n = 0
    differ = [0] * len(tengs)
    for i in range(batches):
        if 0 < i <= len(swaps):
            swaps[i - 1]()
        b = scenario.next_batch()
        oj = jeng.ingest(b["flow_ids"], b["tokens"])
        n += len(b["flow_ids"])
        for k, (teng, tr) in enumerate(zip(tengs, trackers)):
            ot = teng.ingest(b["flow_ids"], b["tokens"])
            for key in ("vetoed", "sig"):
                np.testing.assert_array_equal(ot[key], oj[key], err_msg=key)
            np.testing.assert_array_equal(ot["trust"] == 1.0, ot["vetoed"])
            np.testing.assert_array_equal(oj["trust"] == 1.0, oj["vetoed"])
            assert teng.table.slot_of == jeng.table.slot_of
            assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
            edge = tr.update(jeng, teng, b["flow_ids"])
            moved = np.zeros(len(edge), bool)
            for key in ("trust", "s_nn", "s_sym", "pred"):
                moved |= ot[key] != oj[key]
            assert not (moved & ~edge).any(), "scores differ on a flow whose accumulator does not"
            differ[k] += int(moved.sum())
    return n, differ


@pytest.fixture(scope="module")
def int_programs(tiny_classifier_cfg):
    return _programs(tiny_classifier_cfg, "int-emulation")


@pytest.mark.parametrize("capacity,idle", [(512, 0), (12, 2)], ids=["roomy", "evicting"])
def test_int_engines_replay_jax_int_engine(int_programs, capacity, idle):
    jprog, tprog = int_programs
    fcfg = dict(capacity=capacity, lanes=16, idle_timeout=idle)
    jeng = jprog.deploy(JDeploySpec(flow=JFlowEngineConfig(**fcfg)))
    tengs = [tprog.deploy(DeploySpec(flow=FlowEngineConfig(fused=f, **fcfg), device="cpu"))
             for f in (False, True)]
    for t in tengs:
        assert t.backend == "int-emulation" and t.hidden_sum.dtype == torch.int32
        assert_plans_equal(t._int_plan, jeng._int_plan)
    n, differ = int_replay(jeng, tengs, _scenario(FlowScenario), batches=12)
    assert sum(int(o) for o in np.asarray(jeng.vetoed)) > 0  # the veto branch ran
    if capacity == 12:
        assert tengs[0].stats.flows_evicted > 0
    for b in differ:
        assert b <= BOUNDARY_SHARE * n, (b, n)
    for fid in tengs[0].flow_ids()[:4]:  # control-plane read path
        want = jeng.flow_scores(fid)
        for t in tengs:
            got = t.flow_scores(fid)
            assert got["vetoed"] == want["vetoed"] and got["tokens"] == want["tokens"]


def test_full_width_int_deploy_refuses_as_jax_does():
    ccfg, params = _full_width()
    sig = JFlowScenario(kind="protocol-mix").anomaly_signature
    waivers = ("state-quantization", "int-lowering")
    jrules = lambda c: JC.default_rules(c, jnp.asarray(sig))  # noqa: E731
    tccfg = bridge.classifier_config_from_reference(ccfg)
    tparams = _tparams(params)
    trules = lambda c: TC.default_rules(c, sig, device="cpu")  # noqa: E731
    # without waivers the compile refuses on the same rows
    with pytest.raises(JBudgetError) as je:
        j_compile_program(ccfg, params, rules=jrules, backend="int-emulation", verify=False)
    with pytest.raises(BudgetError) as te:
        compile_program(tccfg, tparams, rules=trules, backend="int-emulation", verify=False)
    assert_rows_equal(te.value.ledger.violations(), je.value.ledger.violations())
    assert {e.stage for e in te.value.ledger.violations()} == set(waivers)
    # with them it compiles, and the deploy re-lowers into a fresh ledger
    jprog = j_compile_program(ccfg, params, rules=jrules, backend="int-emulation",
                              waivers=waivers, verify=False)
    tprog = compile_program(tccfg, tparams, rules=trules, backend="int-emulation",
                            waivers=waivers, verify=False)
    assert tprog.ccfg.sig_words == 24
    with pytest.raises(JBudgetError) as je:
        jprog.deploy(JDeploySpec(flow=JFlowEngineConfig(capacity=4, lanes=4)))
    with pytest.raises(BudgetError) as te:
        tprog.deploy(DeploySpec(flow=FlowEngineConfig(capacity=4, lanes=4), device="cpu"))
    jv, tv = je.value.ledger.violations(), te.value.ledger.violations()
    assert_rows_equal(tv, jv)
    assert [(e.stage, e.resource) for e in tv] == [("int-lowering", "trust-divergence")]
    assert tv[0].used == pytest.approx(0.0583731, abs=1e-6)
    assert "stage 'int-lowering' exceeds trust-divergence" in str(te.value)


# --------------------------------------------------------------------------
# swaps under int-emulation
# --------------------------------------------------------------------------

def test_int_swaps_requantize_rule_weights_as_jax(int_programs):
    """Weights, a quantized table with its spec, a ruleset and a delta, one
    after the other between batches: each installed ``rule_w`` equals JAX's
    after the same swap, rewritten in place, and the batches after it
    match JAX's int engine (per-round and fused)."""
    jprog, tprog = int_programs
    fcfg = dict(capacity=512, lanes=16)
    jeng = jprog.deploy(JDeploySpec(flow=JFlowEngineConfig(**fcfg)))
    tengs = [tprog.deploy(DeploySpec(flow=FlowEngineConfig(fused=f, **fcfg), device="cpu"))
             for f in (False, True)]
    jr = jprog.rules
    soft = jsym.RuleSet(values=jr.values, masks=jr.masks,
                        weights=jnp.asarray([2.25], jnp.float32), hard=jnp.asarray([False]))
    table, wspec = jsym.compile_weights_to_table(jnp.asarray([0.6]), jq.FixedPointSpec(16),
                                                 1 << 20)
    ttable, twspec = tsym.compile_weights_to_table(torch.tensor([0.6]), tq.FixedPointSpec(16),
                                                   1 << 20)
    new_w = np.asarray([-1.3], np.float32)
    jdelta = j_compile_delta(jprog, weights=jnp.asarray(new_w), step=1)
    tdelta = compile_delta(tprog, weights=torch.from_numpy(new_w), step=1)
    np.testing.assert_array_equal(tdelta.weight_table.numpy(), np.asarray(jdelta.weight_table))
    kinds = [
        (dict(weights=jnp.asarray([1.7])), dict(weights=torch.tensor([1.7]))),
        (dict(weights=table, weight_spec=wspec), dict(weights=ttable, weight_spec=twspec)),
        (dict(ruleset=soft), dict(ruleset=_trules(soft))),
        (dict(delta=jdelta), dict(delta=tdelta)),
    ]

    def swap(jkw, tkw):
        def run():
            jeng.swap_tables(**jkw)
            for t in tengs:
                installed = t._int_tables["rule_w"]
                rec = t.swap_tables(**tkw)
                assert rec.source == ("delta" if "delta" in tkw else "manual")
                assert rec.install_s >= 0 and rec.churn_ok
                assert t._int_tables["rule_w"] is installed  # rewritten in place
                np.testing.assert_array_equal(installed.numpy(),
                                              np.asarray(jeng._int_tables["rule_w"]))
                np.testing.assert_array_equal(t.rules.hard.numpy(), np.asarray(jeng.rules.hard))
        return run

    n, differ = int_replay(jeng, tengs, _scenario(FlowScenario), batches=len(kinds) + 2,
                           swaps=[swap(*k) for k in kinds])
    assert all(b <= BOUNDARY_SHARE * n for b in differ)
    assert [len(t.swap_history) for t in tengs] == [len(kinds)] * 2


# --------------------------------------------------------------------------
# on the card (skip without a GPU)
# --------------------------------------------------------------------------

def _chip_smoke():
    import os
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: int_flow_score.cu runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 300])
def test_int_kernel_on_card_is_bit_identical_to_plain(cuda, M):
    """``int_flow_score.cu`` against its plain version at the engine's full
    width (B 256, d 256, K 8, W 24), plans from the paper classifier."""
    c = _chip_smoke()
    ccfg, params = c.paper_classifier()
    c.check_int_score(M, False, params, dataclasses.replace(ccfg, sig_words=24))


@pytest.mark.cuda
def test_int_kernel_edges_on_card_are_bit_identical_to_plain(cuda):
    """``int_flow_score.cu``'s fast and generic paths at chip_smoke's edge
    shapes, on adversarial inputs, against the plain version on the CPU."""
    _chip_smoke().check_int_score_edges()


@pytest.mark.cuda
def test_program_phase_on_card(cuda):
    """chip_smoke's program phase: compile, save, load, deploy per-round and
    fused with swaps between batches, and the int-emulation engines on the
    card beside the CPU."""
    _chip_smoke().phase_program()
