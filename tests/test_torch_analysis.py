"""The port's static verification (``repro_torch.analysis``) on the CPU, held
against the JAX package's (``repro.analysis``).

* The counterparts of ``tests/test_analysis.py``, one each: the graph walker
  (higher-order subgraphs nested in dicts and lists, ``cond``,
  ``while_loop``, an autograd Function and ``map``), the float-literal and
  constant witness, the host-sync, promotion and donation checks, the
  interval analysis and its Eq. 39 proof, the TCAM lint, the graph-capture
  sentry and the compiler's pass 6.
* Against JAX: the proof's width on the tiny classifier at horizon 1024 (31
  bits in both), the unsafe horizon and the under-claiming ledger refused in
  both, the ``static-verification`` rows of ``compile_program`` on the
  ``xla`` and ``int-emulation`` backends (the same ``(resource, used,
  budget)``), ``lint_ruleset``'s findings on the repo's rule sets and on
  planted bad ones, the rows through save and load by either package, the
  sentry's deltas against the jit cache of JAX's fused engine, and the
  gate's CLI.

The JAX side of the proof and of the verifying compiles runs under
``jax.disable_jit()``: on jax 0.9.0 the score jaxpr holds a ``jit``
equation that ``repro.analysis.intervals._nested_jaxpr`` does not enter (it
lists ``"pjit"``), so the JAX proof reads the whole accumulator's range at
the mean division and raises a false overflow.  Without the nested call the
jaxpr is flat and the JAX proof is the one it was written to be.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import intervals as JI
from repro.analysis import tcam_lint as JT
from repro.compile import DataplaneProgram as JProgram
from repro.compile import compile_program as j_compile_program
from repro.compile import int_lowering as jil
from repro.compile import passes as jpasses
from repro.compile.ledger import StageEntry as JStageEntry
from repro.core.hardware_model import DEFAULT_DATAPLANE as J_DATAPLANE
from repro.serve import flow_engine as JFE
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.analysis import (
    STAGE,
    AnalysisError,
    Interval,
    RetraceError,
    RetraceSentry,
    analyze_intervals,
    donation_safety,
    float_ops_in_graph,
    host_syncs_in_graph,
    lint_ruleset,
    promotion_hazards,
    prove_no_overflow,
    trace_graph,
    verify_program,
    walk_graph,
)
from repro_torch.analysis import gate as G
from repro_torch.analysis.graph_lint import PromotionCheck
from repro_torch.analysis.intervals import SumBound, score_input_ranges
from repro_torch.compile import DataplaneProgram, compile_program, passes
from repro_torch.compile.int_lowering import (
    IntLoweringConfig,
    assert_integer_graph,
    int_flow_score,
    lower_scores,
    score_graph,
)
from repro_torch.compile.ledger import StageEntry
from repro_torch.compile.program import _null_rules
from repro_torch.core import symbolic as tsym
from repro_torch.core.hardware_model import DEFAULT_DATAPLANE
from repro_torch.core.symbolic import rule_covers, rules_intersect
from repro_torch.serve.deploy import DeploySpec, ElasticConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.flow_engine import CaptureKeys, FlowEngine, FlowEngineConfig
from repro_torch.train import classifier as TC

SIG = [300, 301]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_ruleset(values, masks, weights=None, hard=None):
    """The port's RuleSet from uint32 words given as Python ints."""
    v = tsym.uint32_to_int32(np.asarray(values, np.uint32))
    m = tsym.uint32_to_int32(np.asarray(masks, np.uint32))
    M = v.shape[0]
    w = torch.ones((M,)) if weights is None else torch.tensor(weights, dtype=torch.float32)
    h = torch.zeros((M,), dtype=torch.bool) if hard is None else torch.tensor(hard)
    return tsym.RuleSet(values=v, masks=m, weights=w, hard=h)


def j_ruleset(rs):
    """The same table as the JAX package's RuleSet."""
    from repro.core.symbolic import RuleSet

    return RuleSet(values=jnp.asarray(rs.values.numpy().view(np.uint32)),
                   masks=jnp.asarray(rs.masks.numpy().view(np.uint32)),
                   weights=jnp.asarray(rs.weights.numpy()), hard=jnp.asarray(rs.hard.numpy()))


@pytest.fixture(scope="module")
def models(tiny_classifier_cfg):
    """The tiny classifier in both packages after the signature pass, with
    seed-0 JAX weights crossed to the port."""
    jccfg, _ = jpasses.signature_layout(tiny_classifier_cfg, None, J_DATAPLANE)
    jparams, _ = JC.init_classifier(jccfg, jax.random.PRNGKey(0))
    tccfg, _ = passes.signature_layout(bridge.classifier_config_from_reference(tiny_classifier_cfg),
                                       None, DEFAULT_DATAPLANE)
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jccfg, jparams, tccfg, tparams


@pytest.fixture(scope="module")
def lowered(models):
    _, _, ccfg, params = models
    rules = TC.default_rules(ccfg, SIG, device="cpu")
    plan, tables, entries = lower_scores(ccfg, params, rules, cfg=IntLoweringConfig(),
                                         horizon=1024)
    return ccfg, params, rules, plan, tables, entries


@pytest.fixture(scope="module")
def j_lowered(models):
    jccfg, jparams, _, _ = models
    rules = JC.default_rules(jccfg, jnp.asarray(SIG))
    plan, tables, entries = jil.lower_scores(jccfg, jparams, rules, cfg=jil.IntLoweringConfig(),
                                             horizon=1024)
    return rules, plan, tables, entries


def _score_trust(lowered, h, c, s, t):
    _, _, rules, plan, tables, _ = lowered
    out, _ = int_flow_score(plan, tables, rules, h, c, s, t)
    return out["trust_q"]


def _score_inputs(lowered, B=2):
    _, _, rules, _, tables, _ = lowered
    d, W = int(tables["cls_w"].shape[0]), rules.values.shape[1]
    return (torch.zeros((B, d), dtype=torch.int32), torch.zeros((B,), dtype=torch.int32),
            torch.zeros((B, W), dtype=torch.int32), torch.zeros((B,), dtype=torch.bool))


# --------------------------------------------------------------------------
# the walker
# --------------------------------------------------------------------------

class _FakeOuter(torch._ops.HigherOrderOperator):
    def __init__(self):
        super().__init__("fake_outer_for_walker_test")

    def __call__(self, *args, **kwargs):  # never executed: the graph is only walked
        raise NotImplementedError


class TestWalkerHardening:
    def test_dict_and_deeply_nested_params_are_recursed(self):
        """A subgraph a higher-order operator reads through a dict nested in
        a list of tuples is visited, with the operator on its path."""
        inner = trace_graph(lambda x: x * 2.5, torch.ones((2,)))
        g = torch.fx.Graph()
        x = g.placeholder("x")
        sub = g.get_attr("sub")
        outer = g.call_function(_FakeOuter(), ({"deep": {"branches": [({"graph": sub},)]}}, x))
        g.output(outer)
        root = torch.nn.Module()
        root.sub = inner
        gm = torch.fx.GraphModule(root, g)
        seen = []
        walk_graph(gm, lambda node, path, owner: seen.append((str(node.target), path)))
        assert ("aten.mul.Tensor", "fake_outer_for_walker_test") in seen, seen

    def test_cond_wrapped_score_path(self, lowered):
        """A float op in a cond branch of the score path is found; the clean
        lowered path stays clean through the nesting."""
        args = _score_inputs(lowered)

        def clean(h, c, s, t):
            return torch.cond(c[0] > 0, lambda h, c, s, t: _score_trust(lowered, h, c, s, t),
                              lambda h, c, s, t: torch.zeros((2,), dtype=torch.int32),
                              (h, c, s, t))

        def dirty(h, c, s, t):
            return torch.cond(c[0] > 0, lambda h, c, s, t: _score_trust(lowered, h, c, s, t),
                              lambda h, c, s, t: (torch.zeros((2,)) * 0.5).to(torch.int32),
                              (h, c, s, t))

        assert float_ops_in_graph(trace_graph(clean, *args)) == []
        found = float_ops_in_graph(trace_graph(dirty, *args))
        assert found and "mul.Tensor[float] literal" in found

    def test_while_loop_wrapped_score_path(self, lowered):
        """The counterpart of the scan-wrapped path: three score steps in a
        ``while_loop`` body stay integer-only."""
        h, c, s, t = _score_inputs(lowered)

        def looped(h, c, s, t):
            def body(i, c, t):
                _, _, rules, plan, tables, _ = lowered
                _, t2 = int_flow_score(plan, tables, rules, h, c, s, t)
                return i + 1, c + 1, t2

            return torch._higher_order_ops.while_loop(
                lambda i, c, t: i < 3, body, (torch.zeros((), dtype=torch.int32), c, t))

        gm = trace_graph(looped, h, c, s, t)
        assert any("while_loop" in str(n.target) for n in gm.graph.nodes)
        assert float_ops_in_graph(gm) == []

    @pytest.mark.parametrize("wrap", ["autograd.Function", "map"])
    def test_custom_function_wrapped_path(self, wrap):
        """The counterpart of the custom_vjp case: a float op inside an
        autograd Function, or inside a ``map`` body, is found."""
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return (x.float() * 1.5).to(torch.int32)

            @staticmethod
            def backward(ctx, g):
                return g

        if wrap == "map":
            fn = lambda x: torch._higher_order_ops.map(  # noqa: E731
                lambda r: (r.float() * 1.5).to(torch.int32), x.reshape(2, 2))
        else:
            fn = lambda x: F.apply(x) + 1  # noqa: E731
        found = float_ops_in_graph(trace_graph(fn, torch.ones((4,), dtype=torch.int32)))
        assert any("float32" in s for s in found), found


# --------------------------------------------------------------------------
# float-literal flagging
# --------------------------------------------------------------------------

class TestFloatLiteralWitness:
    def test_inexact_literal_operand_is_labeled(self):
        labels = float_ops_in_graph(trace_graph(lambda x: x * 2.5, torch.ones((2,))))
        assert any(label.endswith("literal") for label in labels), labels

    def test_clean_integer_graph_stays_empty(self):
        gm = trace_graph(lambda x: x * 2 + 1, torch.ones((2,), dtype=torch.int32))
        assert float_ops_in_graph(gm) == []

    def test_float_constant_still_flagged(self):
        big = torch.linspace(0.0, 1.0, 8)  # closed over -> a graph constant
        big_i = torch.arange(8, dtype=torch.int32)
        x = torch.ones((8,), dtype=torch.int32)
        assert float_ops_in_graph(trace_graph(lambda x: x + big_i, x)) == []
        assert any(lbl.startswith("constvar[") for lbl in float_ops_in_graph(
            trace_graph(lambda x: x.float() + big, x)))


# --------------------------------------------------------------------------
# host-sync, promotion and donation checks
# --------------------------------------------------------------------------

class TestLintChecks:
    @pytest.mark.parametrize("fn,prim", [
        (lambda x: x + x.sum().item(), "_local_scalar_dense.default"),
        (lambda x: torch.nonzero(x), "nonzero.default"),
    ], ids=["item", "nonzero"])
    def test_host_sync_flagged(self, fn, prim):
        found = host_syncs_in_graph(trace_graph(fn, torch.ones((4,), dtype=torch.int32)))
        assert found and found[0].primitive == prim

    def test_host_sync_found_inside_nesting(self):
        def f(x):
            return torch.cond(x.sum() > 0, lambda y: y * y.sum().item(), lambda y: y * 1, (x,))

        found = host_syncs_in_graph(trace_graph(f, torch.ones((4,), dtype=torch.int32)))
        assert found and "cond" in found[0].path

    def test_clean_path_has_no_host_sync(self):
        assert host_syncs_in_graph(trace_graph(lambda x: x * 2, torch.ones((2,)))) == []

    def test_promotion_check_flags_mixed_widening(self):
        """A Python float against an int32 path, an int64 tensor against it,
        and an int32 sum left to its int64 default are flagged; the port's
        explicit ``dtype=torch.int32`` sum is not."""
        x = torch.ones((4,), dtype=torch.int32)
        for fn, why in ((lambda x: x * 0.5, "python float"),
                        (lambda x: x + torch.ones((4,), dtype=torch.int64), "int64 tensor"),
                        (lambda x: x.sum(0), "default result dtype")):
            found = promotion_hazards(trace_graph(fn, x))
            assert found and why in found[0].message, found
        assert promotion_hazards(trace_graph(lambda x: torch.sum(x, 0, dtype=torch.int32) + 1,
                                             x)) == []
        check = PromotionCheck()
        gm = trace_graph(lambda x: x * 0.5, x)
        for node in gm.graph.nodes:
            check.on_node(node, "", gm)
        assert check.finish()

    def test_donation_safety_clean_and_violations(self):
        a = torch.empty((4, 4), device="meta")
        b = torch.empty((2,), dtype=torch.int32, device="meta")
        assert donation_safety(lambda x, y: (x * 2.0, y + 1), (a, b), (0, 1)) == []
        bad = donation_safety(lambda x, y: (torch.sum(x), y + 1), (a, b), (0,))
        assert bad and "no remaining output" in bad[0].message
        bad = donation_safety(lambda x, y: (x * 2.0, y + 1), (a, b), (5,))
        assert bad and "beyond positional arity" in bad[0].message
        assert donation_safety(lambda x, y: x + 1.0, (a, a), (0, 1))  # double donation


# --------------------------------------------------------------------------
# interval analysis + the Eq. 39 overflow proof
# --------------------------------------------------------------------------

def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


class TestIntervals:
    def test_basic_transfer_and_overflow_flagging(self):
        gm = trace_graph(lambda x, y: x * y + x, _i32(4), _i32(4))
        ok = analyze_intervals(gm, [Interval(-1000, 1000)] * 2)
        assert ok.proves_no_overflow() and ok.max_signed_bits <= 22
        bad = analyze_intervals(gm, [Interval(-(1 << 30), 1 << 30)] * 2)
        assert not bad.proves_no_overflow()
        assert any(b.primitive == "mul.Tensor" for b in bad.overflows())

    @pytest.mark.parametrize("form", ["mm", "broadcast-mul-sum"])
    def test_contraction_width(self, form):
        """``mm`` and the port's ``int_mac`` (a broadcast product summed in
        int32) both read the contracted extent."""
        from repro_torch.compile.int_lowering import int_mac

        fn = torch.mm if form == "mm" else int_mac
        rep = analyze_intervals(trace_graph(fn, _i32(2, 64), _i32(64, 3)),
                                [Interval(-100, 100)] * 2)
        top = [b for b in rep.bounds if b.primitive.split(".")[0] in ("mm", "sum")]
        assert top and top[-1].interval.hi == 100 * 100 * 64

    def test_sum_bound_relation_tightens_mean_division(self):
        def f(s, c):
            one = torch.ones((), dtype=torch.int32)
            return torch.div(s, torch.maximum(c, one), rounding_mode="floor") * 1000

        gm = trace_graph(f, _i32(4), _i32(4))
        ranges = [Interval(-100_000, 100_000), Interval(0, 1000)]
        loose = analyze_intervals(gm, ranges)
        tight = analyze_intervals(gm, ranges, (SumBound(0, 1, 100),))
        assert tight.max_signed_bits < loose.max_signed_bits
        muls = [b for b in tight.bounds if b.primitive.startswith("mul")]
        assert muls and muls[-1].interval.magnitude <= 101 * 1000

    def test_unmodeled_operator_falls_back_to_dtype_range(self):
        rep = analyze_intervals(trace_graph(lambda x: torch.cumsum(x, 0, dtype=torch.int32),
                                            _i32(4)), [Interval(0, 1)])
        assert rep.proves_no_overflow() and rep.max_signed_bits == 32

    def test_prove_no_overflow_rederives_ledger_widths(self, lowered):
        _, _, rules, plan, tables, entries = lowered
        report = prove_no_overflow(plan, tables, rules, horizon=1024, ledger_entries=entries)
        assert report.proves_no_overflow()
        hand_max = max(int(e.used) for e in entries
                       if e.resource.endswith("-bits") and e.resource != "feature-frac-bits")
        assert report.max_signed_bits <= hand_max <= 32

    def test_unsafe_horizon_rejected_statically(self, lowered):
        _, _, rules, plan, tables, _ = lowered
        with pytest.raises(AnalysisError, match="overflow"):
            prove_no_overflow(plan, tables, rules, horizon=1 << 20)

    def test_ledger_underclaim_fails_louder(self, lowered):
        _, _, rules, plan, tables, _ = lowered
        lying = [StageEntry(stage="int-lowering", resource="class-matmul-bits", used=4, budget=32)]
        with pytest.raises(AnalysisError, match="under-claim"):
            prove_no_overflow(plan, tables, rules, horizon=1024, ledger_entries=lying)

    def test_input_contract_matches_graph_arity(self, lowered):
        _, _, rules, plan, tables, _ = lowered
        gm = score_graph(plan, tables, rules, 4, int(tables["cls_w"].shape[0]))
        ranges, relations = score_input_ranges(plan, tables, rules, 1024)
        assert len(ranges) == len([n for n in gm.graph.nodes if n.op == "placeholder"])
        assert relations and relations[0].term_bound > 0
        assert_integer_graph(plan, tables, rules)


# --------------------------------------------------------------------------
# TCAM rule-table lint
# --------------------------------------------------------------------------

class TestTcamLint:
    def test_ternary_algebra_helpers(self):
        v = lambda *xs: np.asarray(xs, np.uint32)  # noqa: E731
        assert rule_covers(v(0b01), v(0b01), v(0b11), v(0b11))
        assert not rule_covers(v(0b11), v(0b11), v(0b01), v(0b01))
        assert rules_intersect(v(0b01), v(0b01), v(0b10), v(0b10))
        assert not rules_intersect(v(0b1), v(0b1), v(0b0), v(0b1))
        # int32 bit patterns with bit 31 set read as words, not negatives
        top = tsym.uint32_to_int32(np.asarray([1 << 31], np.uint32))
        assert rule_covers(top, top, top | 1, top | 1)

    def test_shadowed_hard_rule_is_error(self):
        rs = make_ruleset([[0b01], [0b11]], [[0b01], [0b11]], hard=[False, True])
        shadowed = [f for f in lint_ruleset(rs, achievable_bits=8) if f.kind == "shadowed"]
        assert shadowed and shadowed[0].severity == "error"
        assert shadowed[0].rule == 1 and shadowed[0].other == 0

    def test_shadowed_same_tier_is_warning(self):
        rs = make_ruleset([[0b01], [0b11]], [[0b01], [0b11]], hard=[False, False])
        f = [x for x in lint_ruleset(rs) if x.kind == "shadowed"]
        assert f and f[0].severity == "warning"

    def test_ambiguous_hard_soft_overlap(self):
        rs = make_ruleset([[0b01], [0b10]], [[0b01], [0b10]], hard=[True, False])
        assert [x for x in lint_ruleset(rs) if x.kind == "ambiguous-overlap"]

    def test_unreachable_hard_rule_is_error(self):
        rs = make_ruleset([[1 << 31]], [[1 << 31]], hard=[True])
        f = [x for x in lint_ruleset(rs, achievable_bits=8) if x.kind == "unreachable"]
        assert f and f[0].severity == "error" and "31" in f[0].message

    def test_always_firing_hard_rule_is_error(self):
        rs = make_ruleset([[0]], [[0]], hard=[True])
        f = [x for x in lint_ruleset(rs) if x.kind == "always-fires"]
        assert f and f[0].severity == "error"

    def test_repo_default_rulesets_pass(self, lowered):
        ccfg, _, rules, _, _, _ = lowered
        achievable = ccfg.arch.vocab_size - ccfg.marker_base
        assert lint_ruleset(rules, achievable_bits=achievable) == []
        null = _null_rules(dataclasses.replace(ccfg, sig_words=8), "cpu")
        assert lint_ruleset(null, achievable_bits=achievable) == []


# --------------------------------------------------------------------------
# the graph-capture sentry
# --------------------------------------------------------------------------

def _engine(lowered, **kw):
    ccfg, params, rules, _, _, _ = lowered
    return FlowEngine(ccfg, params, rules, FlowEngineConfig(capacity=32, **kw), device="cpu")


def _flows(n, pkt_len=4, first=0):
    return np.arange(first, first + n, dtype=np.int64), np.full((n, pkt_len), 7, np.int32)


class TestRetraceSentry:
    def test_detects_capture_and_passes_stable_region(self, lowered):
        eng = _engine(lowered, lanes=8, fused=True, min_chunk_lanes=2)
        sentry = RetraceSentry.for_engine(eng)
        eng.ingest(*_flows(8))  # warm-up: width 8
        sentry.snapshot()
        with sentry.expect_no_retrace():
            eng.ingest(*_flows(8, first=8))  # width 8 again: stable
        with pytest.raises(RetraceError, match="fused: \\+1"):
            with sentry.expect_no_retrace():
                eng.ingest(*_flows(2, first=16))  # a new width

    def test_rejects_a_target_with_nothing_to_count(self):
        with pytest.raises(TypeError, match="not a capture entry point"):
            RetraceSentry({"f": lambda x: x})
        assert RetraceSentry({"k": CaptureKeys(lambda: {(8, 4)})}).counts() == {"k": 1}

    def test_total_capture_budget(self, lowered):
        eng = _engine(lowered, lanes=8, fused=True, min_chunk_lanes=2)
        sentry = RetraceSentry.for_engine(eng)
        assert eng.warm_fused(4) == 3  # widths 2, 4, 8
        sentry.assert_total_traces(3)
        with pytest.raises(RetraceError, match="trace budget"):
            sentry.assert_total_traces(2)

    def test_for_engine_discovers_entry_points(self, lowered):
        eng = _engine(lowered, lanes=8)
        sentry = RetraceSentry.for_engine(eng)
        assert set(sentry.counts()) == {"step"}
        eng.ingest(*_flows(8))
        sentry.snapshot()
        with sentry.expect_no_retrace():
            eng.ingest(*_flows(8))
        assert set(RetraceSentry.for_engine(_engine(lowered, lanes=8, fused=True)).counts()) \
            == {"step", "fused"}
        with pytest.raises(ValueError, match="exposes no entry points"):
            RetraceSentry.for_engine(ServeEngine.__new__(ServeEngine))


# --------------------------------------------------------------------------
# the verify pass + compile wiring
# --------------------------------------------------------------------------

def _shadowing(ccfg):
    pad = [0] * (ccfg.sig_words - 1)
    return make_ruleset([[0b01] + pad, [0b11] + pad], [[0b01] + pad, [0b11] + pad],
                        hard=[False, True])


class TestVerifyPass:
    @pytest.fixture(scope="class")
    def compiled(self, lowered):
        ccfg, params, rules, _, _, _ = lowered
        return compile_program(ccfg, params, rules, backend="int-emulation")

    def test_findings_land_as_ledger_entries(self, compiled):
        sv = [e for e in compiled.ledger.entries if e.stage == STAGE]
        assert {"tcam-lint-errors", "hot-path-host-callbacks", "int-path-float-ops",
                "int32-overflow-proof"} <= {e.resource for e in sv}
        assert all(e.ok for e in sv)

    def test_overflow_proof_cross_references_hand_widths(self, compiled):
        proof = [e for e in compiled.ledger.entries if e.resource == "int32-overflow-proof"]
        assert proof and proof[0].used <= 32 and "hand-derived" in proof[0].detail

    def test_verify_opt_out(self, lowered):
        ccfg, params, rules, _, _, _ = lowered
        prog = compile_program(ccfg, params, rules, verify=False)
        assert not [e for e in prog.ledger.entries if e.stage == STAGE]

    def test_bad_ruleset_fails_compile_with_analysis_error(self, lowered):
        ccfg, params, _, _, _, _ = lowered
        with pytest.raises(AnalysisError, match="tcam"):
            compile_program(ccfg, params, _shadowing(ccfg))

    def test_waiver_records_instead_of_raising(self, lowered):
        ccfg, params, _, _, _, _ = lowered
        prog = compile_program(ccfg, params, _shadowing(ccfg), waivers=("static-verification",))
        assert [e for e in prog.ledger.entries if e.stage == STAGE and e.waived]

    def test_unsafe_horizon_fails_before_any_execution(self, lowered):
        ccfg, params, rules, _, _, _ = lowered
        with pytest.raises(AnalysisError):
            compile_program(ccfg, params, rules, backend="int-emulation", horizon=1 << 28)

    def test_verify_program_strict_false_never_raises(self, lowered):
        ccfg, params, _, _, _, _ = lowered
        prog = compile_program(ccfg, params, _shadowing(ccfg), verify=False)
        over = [e for e in verify_program(prog, strict=False) if not e.ok]
        assert over and over[0].resource == "tcam-lint-errors"
        with pytest.raises(AnalysisError, match="tcam_lint"):
            verify_program(prog)


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

def test_overflow_proof_width_matches_jax(lowered, j_lowered):
    _, _, rules, plan, tables, entries = lowered
    jrules, jplan, jtables, jentries = j_lowered
    with jax.disable_jit():  # the "jit"/"pjit" hazard: see the module docstring
        jrep = JI.prove_no_overflow(jplan, jtables, jrules, horizon=1024,
                                    ledger_entries=jentries)
    rep = prove_no_overflow(plan, tables, rules, horizon=1024, ledger_entries=entries)
    assert rep.max_signed_bits == jrep.max_signed_bits == 31
    assert ([(r.dtype, r.interval.lo, r.interval.hi) for r in rep.inputs]
            == [(r.dtype, r.interval.lo, r.interval.hi) for r in jrep.inputs])


@pytest.mark.parametrize("case", ["horizon-2^20", "under-claim"])
def test_refusals_match_jax(lowered, j_lowered, case):
    """Both packages refuse before anything executes."""
    _, _, rules, plan, tables, _ = lowered
    jrules, jplan, jtables, _ = j_lowered
    if case == "horizon-2^20":
        kw, jkw, match = {"horizon": 1 << 20}, {"horizon": 1 << 20}, "overflow"
    else:
        kw = {"horizon": 1024, "ledger_entries": [StageEntry(
            stage="int-lowering", resource="class-matmul-bits", used=4, budget=32)]}
        jkw = {"horizon": 1024, "ledger_entries": [JStageEntry(
            stage="int-lowering", resource="class-matmul-bits", used=4, budget=32)]}
        match = "under-claim"
    with jax.disable_jit():  # the "jit"/"pjit" hazard: see the module docstring
        with pytest.raises(JI.AnalysisError, match=match):
            JI.prove_no_overflow(jplan, jtables, jrules, **jkw)
    with pytest.raises(AnalysisError, match=match):
        prove_no_overflow(plan, tables, rules, **kw)


def _compile_both(models, backend, rules=None, **kw):
    jccfg, jparams, tccfg, tparams = models
    jrules = (lambda c: JC.default_rules(c, jnp.asarray(SIG))) if rules is None \
        else (lambda c: j_ruleset(rules(c)))
    trules = (lambda c: TC.default_rules(c, SIG, device="cpu")) if rules is None else rules
    with jax.disable_jit():  # the "jit"/"pjit" hazard: see the module docstring
        jprog = j_compile_program(jccfg, jparams, rules=jrules, backend=backend, **kw)
    tprog = compile_program(tccfg, tparams, rules=trules, backend=backend, **kw)
    return jprog, tprog


def _sv(entries):
    return [(e.resource, e.used, e.budget, e.waived) for e in entries if e.stage == STAGE]


@pytest.mark.parametrize("backend", ["xla", "int-emulation"])
def test_compile_rows_match_jax(models, backend):
    jprog, tprog = _compile_both(models, backend)
    want = {"xla": 4, "int-emulation": 6}[backend]
    assert len(_sv(tprog.ledger.entries)) == want
    assert _sv(tprog.ledger.entries) == _sv(jprog.ledger.entries)
    if backend == "int-emulation":
        assert ("int32-overflow-proof", 31.0, 32.0, False) in _sv(tprog.ledger.entries)


RULESETS = {
    "shadowed-veto": ([[0b01], [0b11]], [[0b01], [0b11]], [False, True]),
    "shadowed-same-tier": ([[0b01], [0b11]], [[0b01], [0b11]], [False, False]),
    "ambiguous": ([[0b01], [0b10]], [[0b01], [0b10]], [True, False]),
    "unreachable-bit31": ([[1 << 31], [1 << 3]], [[1 << 31], [1 << 3]], [True, False]),
    "always-fires": ([[0], [0b100]], [[0], [0b100]], [True, True]),
}


@pytest.mark.parametrize("name", ["default", "null"] + list(RULESETS))
@pytest.mark.parametrize("achievable", [None, 8, 256])
def test_lint_findings_match_jax(lowered, name, achievable):
    ccfg = lowered[0]
    if name == "default":
        rs = lowered[2]
    elif name == "null":
        rs = _null_rules(ccfg, "cpu")
    else:
        v, m, h = RULESETS[name]
        rs = make_ruleset(v, m, hard=h)
    key = lambda f: (f.kind, f.severity, f.rule, f.other, f.message)  # noqa: E731
    got = [key(f) for f in lint_ruleset(rs, achievable_bits=achievable)]
    want = [key(f) for f in JT.lint_ruleset(j_ruleset(rs), achievable_bits=achievable)]
    assert got == want
    if name in RULESETS:
        assert got
    elif achievable != 8:  # the default rules demand marker bits past 8
        assert got == []


@pytest.mark.parametrize("name", ["default"] + list(RULESETS))
def test_verify_ruleset_rows_match_jax(models, lowered, name):
    """The standalone TCAM audit's two rows, against the marker layout."""
    from repro.analysis.verify import verify_ruleset as j_verify_ruleset
    from repro_torch.analysis.verify import verify_ruleset

    rs = lowered[2] if name == "default" else make_ruleset(*RULESETS[name][:2],
                                                           hard=RULESETS[name][2])
    rows = [(e.resource, e.used, e.budget, e.ok) for e in verify_ruleset(rs, lowered[0])]
    want = [(e.resource, e.used, e.budget, e.ok)
            for e in j_verify_ruleset(j_ruleset(rs), models[0])]
    assert rows == want and [r[0] for r in rows] == ["tcam-lint-errors", "tcam-lint-warnings"]


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_verified_rows_survive_save_and_load(models, tmp_path, saver):
    jprog, tprog = _compile_both(models, "int-emulation")
    (jprog if saver == "jax" else tprog).save(str(tmp_path))
    rows = _sv(tprog.ledger.entries)
    assert len(rows) == 6
    assert _sv(DataplaneProgram.load(str(tmp_path), device="cpu").ledger.entries) == rows
    assert _sv(JProgram.load(str(tmp_path)).ledger.entries) == rows


def test_sentry_deltas_match_jax_fused_engine(models):
    """One new key for a new chunk width, none for a repeat: the port's
    fused entry point and the jit cache of JAX's fused engine move alike."""
    jccfg, jparams, tccfg, tparams = models
    jrules = JC.default_rules(jccfg, jnp.asarray(SIG))
    trules = TC.default_rules(tccfg, SIG, device="cpu")
    fcfg = dict(capacity=32, lanes=8, min_chunk_lanes=2)
    jeng = JFE.FlowEngine(jccfg, jparams, jrules,
                          JFE.FlowEngineConfig(fused=True, backend="xla", **fcfg))
    teng = FlowEngine(tccfg, tparams, trules, FlowEngineConfig(fused=True, **fcfg), device="cpu")
    jfused = jeng.jit_entry_points()["fused"]
    tsentry = RetraceSentry.for_engine(teng)
    deltas = []
    for n, first in ((8, 0), (8, 8), (2, 16), (2, 18), (8, 20)):
        before = (jfused._cache_size(), tsentry.counts()["fused"])
        ids, toks = _flows(n, first=first)
        jeng.ingest(ids, toks)
        teng.ingest(ids, toks)
        deltas.append((jfused._cache_size() - before[0], tsentry.counts()["fused"] - before[1]))
    assert [j for j, _ in deltas] == [t for _, t in deltas] == [1, 0, 1, 0, 0]


def test_sentry_sees_no_key_across_the_elastic_cycle(lowered):
    """The gate's audit: after both topologies are warm, a 1 -> 2 -> 1 cycle
    with ingest between the installs brings no new step key."""
    ccfg, params, rules, _, _, _ = lowered
    prog = compile_program(ccfg, params, rules, verify=False)
    svc = prog.deploy(DeploySpec(engine="elastic", num_shards=1,
                                 flow=FlowEngineConfig(capacity=32, lanes=8),
                                 elastic=ElasticConfig(keep_topologies=True), device="cpu"))
    svc.ingest(*_flows(8))
    svc.reshard(2)
    svc.ingest(*_flows(8))
    svc.reshard(1)
    sentry = RetraceSentry.for_engine(svc)
    assert set(sentry.counts()) == {"shards1.step", "shards2.step"}
    with sentry.expect_no_retrace():
        svc.ingest(*_flows(8))
        svc.reshard(2)
        svc.ingest(*_flows(8))
        svc.reshard(1)
        svc.ingest(*_flows(8))
    assert sentry.counts() == {"shards1.step": 1, "shards2.step": 1}


@pytest.mark.parametrize("planted", [False, True], ids=["default-rules", "shadowed-veto"])
def test_gate_cli_on_the_cpu(tmp_path, capsys, planted):
    out = tmp_path / "verdict.json"
    rules_fn = _shadowing if planted else None
    rc = G.main(["--device", "cpu", "--out", str(out)], rules_fn=rules_fn)
    verdict = json.loads(out.read_text())
    assert all(c["ok"] for c in verdict["canaries"])
    assert verdict["elastic"]["ok"]
    assert [b["backend"] for b in verdict["backends"]] == ["xla", "int-emulation"]
    if planted:
        assert rc != 0 and not verdict["ok"]
        assert all(not b["ok"] for b in verdict["backends"])
    else:
        assert rc == 0 and verdict["ok"]
        assert "verdict ok" in capsys.readouterr().out
