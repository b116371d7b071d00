"""Integer-only lowering of the dataplane score path (port of
``repro.compile.int_lowering`` lines 59-480).

A switch pipeline has integer ALUs only, so the trust guarantees are
auditable only if the arithmetic that produces them is integer end to end.
This pass lowers the score path of a compiled program to fixed point:

  feature map      h_q  = clip(round(h · 2^f_h))          (the Map boundary)
  (S, Z) updates   hidden_sum_q += h_q ; count += 1       (int32 adds)
  pooling          pooled_q = hidden_sum_q // max(count,1)
  class head       logits_q = pooled_q · W_cls_q          (int32 MACs)
  anomaly head     s_nn_q   = (pooled_q · W_anom_q) >> k  (rounding shift)
  ternary match    TCAM over packed 32-bit words          (already integer)
  HL-MRF table     s_sym_q  = Σ hits · W_rule_q >> k      (SRAM gather)
  cascade fusion   u_q = (α_q·s_nn_q + β_q·s_sym_q) >> k  (Eq. 15)
                   S_q = hard ? 2^f_t : σ_LUT[u_q]        (sigmoid LUT)

Every scale is a power of two, so requantization is a rounding arithmetic
shift.  Fractional widths are derived: the feature LSB from the Eq. 39
no-overflow condition over the flow horizon, weight LSBs from per-tensor
absmax, and every intermediate's worst-case width is a ledger row against
the 32-bit ALU.  The LUT is clamped to ``2^f_t - 1``, so the lowered trust
equals 1.0 exactly when a hard rule fired.

The plan and tables are bit-identical to the JAX package's: every absmax
and ``log2`` is taken on Python floats from the same float32 values,
``torch.round`` rounds half to even as ``jnp.round`` does, and the pooling
is floor division.  :func:`int_flow_score` is the plain version of the
``int_flow_score`` kernel (``kernels/flow_ingest/int_ops.py``).

The audits of the JAX package's ``score_jaxpr`` / ``assert_integer_jaxpr``
(:482-536) are :func:`score_graph` (the plain version traced on fake
tensors: an aten graph, nothing executes), :func:`float_ops_in_graph` and
:func:`assert_integer_graph`; the interval proof
(:mod:`repro_torch.analysis.intervals`) reads the same graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compile.ledger import StageEntry
from repro_torch.core import symbolic
from repro_torch.core.quantization import FixedPointSpec, overflow_safe_horizon, to_int

STAGE = "int-lowering"  # ledger stage name (waiver key)
ALU_BITS = 32  # the dataplane ALU word


@dataclasses.dataclass(frozen=True)
class IntLoweringConfig:
    """Quantization policy knobs; everything else is derived per-program."""

    feature_bits: int = 16  # logical width of one quantized feature h_q
    min_feature_frac: int = 6  # refuse to lower below this feature LSB
    feature_range: float = 8.0  # assumed |h| bound after final norm (B_h)
    weight_bits: int = 12  # logical width of head/rule weight entries
    weight_frac_cap: int = 20  # absmax-derived weight LSBs never exceed this
    score_frac: int = 10  # target LSB of s_nn / s_sym / u (2^-f_s)
    fusion_bits: int = 16  # alpha/beta fixed-point width
    fusion_frac: int = 12  # alpha/beta LSB (2^-f_ab)
    trust_frac: int = 14  # trust LSB: S = 1.0 is exactly 2^f_t
    lut_bits: int = 10  # sigmoid LUT entries = 2^lut_bits
    lut_range: float = 8.0  # LUT covers u in [-R, R]; power of two
    max_divergence: float = 0.05  # budget for the Thm A.3 trust bound


@dataclasses.dataclass(frozen=True)
class IntScorePlan:
    """The static shape of one lowered score program: every fractional
    width, shift count and LUT constant.  A pure function of (ccfg, params,
    rules, cfg, horizon), re-derived at every deploy."""

    feature_bits: int
    feature_frac: int  # f_h: h_q = round(h * 2^f_h)
    feature_range: float  # B_h the derivation assumed
    weight_bits: int
    cls_frac: int  # f_wc
    anom_frac: int  # f_wa
    rule_frac: int  # f_wr
    score_frac: int  # f_s: LSB of s_nn_q, s_sym_q, u_q
    nn_shift: int  # (f_h + f_wa) - f_s >= 0
    sym_shift: int  # f_wr - f_s >= 0
    fusion_frac: int  # f_ab: alpha_q/beta_q LSB
    trust_frac: int  # f_t
    one_q: int  # 2^f_t — the pinned S = 1.0 in quantized units
    n_lut: int
    lut_shift: int  # u-to-index shift (may be negative: finer-than-LSB)
    lut_range: float
    u_min_q: int  # -R * 2^f_s
    horizon: int  # Eq. 39 flow-length the feature LSB covers
    has_cls_bias: bool
    has_anom_bias: bool
    divergence: float  # Thm A.3 composed float<->int trust bound


# The int tables are a plain dict of int32 tensors:
#   cls_w (d, C), anom_w (d, 1), [cls_b (C,), anom_b (1,)],
#   rule_w (M,), alpha (), beta (), lut (n_lut,)


def _pow2_frac(absmax: float, bits: int, cap: int) -> int:
    """Largest f with absmax * 2^f <= 2^(bits-1)-1 (power-of-two absmax
    scaling), capped; an all-zero tensor gets the cap."""
    max_int = 2 ** (bits - 1) - 1
    if absmax <= 0.0:
        return cap
    return min(int(math.floor(math.log2(max_int / absmax))), cap)


def _q(x, frac: int, bits: int) -> torch.Tensor:
    """Round-to-nearest fixed-point image at scale 2^-frac, stored int32."""
    max_int = 2 ** (bits - 1) - 1
    x = torch.as_tensor(x, dtype=torch.float32)
    return to_int(torch.round(x * (2.0 ** frac)), -max_int - 1, max_int, torch.int32)


def _signed_bits(bound: float) -> int:
    """Bits needed to hold a signed value with |x| <= bound."""
    return int(math.ceil(math.log2(max(bound, 1.0)))) + 1


def _rshift_round(x: torch.Tensor, k: int) -> torch.Tensor:
    """Requantize by 2^-k with round-half-up — the switch-ALU idiom
    ``(x + (1 << (k-1))) >> k``, an arithmetic shift on int32.  k = 0 is
    the identity."""
    if k == 0:
        return x
    return torch.bitwise_right_shift(x + (1 << (k - 1)), k)


def _absmax(x: torch.Tensor) -> float:
    return float(torch.max(torch.abs(x.float())))


# --------------------------------------------------------------------------
# the lowering pass
# --------------------------------------------------------------------------

def lower_scores(
    ccfg,
    params,
    rules: symbolic.RuleSet,
    *,
    cfg: IntLoweringConfig = IntLoweringConfig(),
    horizon: int = 1024,
) -> Tuple[IntScorePlan, Dict[str, torch.Tensor], List[StageEntry]]:
    """Lower the streaming score path to fixed point.

    Returns ``(plan, tables, entries)``, the tables on the device of the
    parameters; the caller assembles the entries into a
    :class:`ResourceLedger`, whose ``raise_if_over()`` turns any >32-bit
    intermediate into a :class:`BudgetError` naming this stage.
    """
    if cfg.lut_range <= 0 or 2 ** round(math.log2(cfg.lut_range)) != cfg.lut_range:
        raise ValueError(f"lut_range must be a power of two, got {cfg.lut_range}")
    d = ccfg.arch.d_model
    b_h = cfg.feature_range
    max_int_f = 2 ** (cfg.feature_bits - 1) - 1

    # ---- feature LSB: the Eq. 39 derivation -------------------------------
    # (a) fit: B_h real units must fit the feature word;
    # (b) Eq. 39: `horizon` quantized features must accumulate in the 32-bit
    #     (S, Z) analog (hidden_sum_q, count) without overflow;
    # (c) ALU: the head MACs over the pooled feature must fit 32 bits.
    f_fit = int(math.floor(math.log2(max_int_f / b_h)))
    f_eq39 = f_fit
    while f_eq39 > 0 and overflow_safe_horizon(
        b_h, 1.0, FixedPointSpec(bits=ALU_BITS, scale=2.0 ** -f_eq39)
    ) < horizon:
        f_eq39 -= 1
    max_int_w = 2 ** (cfg.weight_bits - 1) - 1
    alu_max = 2 ** (ALU_BITS - 1) - 1
    f_mac = int(math.floor(math.log2(alu_max / (d * b_h * max_int_w))))
    f_h = min(f_fit, f_eq39, f_mac)

    # ---- weight tables ----------------------------------------------------
    cap = cfg.weight_frac_cap
    cls_w, anom_w = params["cls"]["w"], params["anom"]["w"]
    f_wc = _pow2_frac(_absmax(cls_w), cfg.weight_bits, cap)
    f_wa = _pow2_frac(_absmax(anom_w), cfg.weight_bits, cap)
    f_wr = _pow2_frac(_absmax(rules.weights), cfg.weight_bits, cap)
    f_s = min(cfg.score_frac, f_h + f_wa, f_wr)
    f_ab = cfg.fusion_frac
    f_t = cfg.trust_frac
    one_q = 1 << f_t

    tables: Dict[str, torch.Tensor] = {
        "cls_w": _q(cls_w, f_wc, cfg.weight_bits),
        "anom_w": _q(anom_w, f_wa, cfg.weight_bits),
        "rule_w": _q(rules.weights, f_wr, cfg.weight_bits),
        "alpha": _q(params["fusion"]["alpha"], f_ab, cfg.fusion_bits),
        "beta": _q(params["fusion"]["beta"], f_ab, cfg.fusion_bits),
    }
    has_cls_bias = "b" in params["cls"]
    has_anom_bias = "b" in params["anom"]
    if has_cls_bias:  # biases live at the accumulator LSB (f_h + f_wc)
        tables["cls_b"] = _q(params["cls"]["b"], f_h + f_wc, ALU_BITS)
    if has_anom_bias:
        tables["anom_b"] = _q(params["anom"]["b"], f_h + f_wa, ALU_BITS)

    # ---- sigmoid LUT (Eq. 15 soft branch) ---------------------------------
    # u_q at LSB 2^-f_s indexes 2^lut_bits buckets over [-R, R]; values are
    # clamped to one_q - 1 so S_q == one_q <=> hard veto, structurally.
    n_lut = 1 << cfg.lut_bits
    lut_shift = f_s + 1 + int(round(math.log2(cfg.lut_range))) - cfg.lut_bits
    u_min_q = -int(cfg.lut_range * (1 << f_s))
    centers = -cfg.lut_range + (np.arange(n_lut) + 0.5) * (2.0 * cfg.lut_range / n_lut)
    soft = np.clip(np.round(1.0 / (1.0 + np.exp(-centers)) * one_q), 0, one_q - 1)
    tables["lut"] = torch.from_numpy(soft.astype(np.int32)).to(cls_w.device)

    # ---- worst-case bit-width accounting (the ledger audit) ---------------
    M = rules.n_rules
    pooled_bound = min(max_int_f, b_h * 2.0 ** f_h)  # |pooled_q| per scalar
    acc_bound = horizon * (b_h * 2.0 ** f_h + 0.5)  # Eq. 39 numerator
    cls_bound = d * pooled_bound * _absmax(tables["cls_w"])
    if has_cls_bias:
        cls_bound += _absmax(tables["cls_b"])
    nn_shift = f_h + f_wa - f_s
    anom_bound = d * pooled_bound * _absmax(tables["anom_w"])
    if has_anom_bias:
        anom_bound += _absmax(tables["anom_b"])
    anom_acc_bound = anom_bound + (2.0 ** (nn_shift - 1) if nn_shift else 0.0)
    sym_shift = f_wr - f_s
    sym_bound = M * _absmax(tables["rule_w"])
    sym_acc_bound = sym_bound + (2.0 ** (sym_shift - 1) if sym_shift else 0.0)
    nn_q_bound = anom_bound / max(2.0 ** nn_shift, 1.0)
    sym_q_bound = sym_bound / max(2.0 ** sym_shift, 1.0)
    a_q = _absmax(tables["alpha"])
    b_q = _absmax(tables["beta"])
    fusion_bound = a_q * nn_q_bound + b_q * sym_q_bound + 2.0 ** (f_ab - 1)

    eta = divergence_bound(
        cfg, f_h=f_h, f_wa=f_wa, f_wr=f_wr, f_s=f_s, d=d, n_rules=M,
        sum_abs_anom_w=float(torch.sum(torch.abs(anom_w.float()))),
        nn_bound=anom_bound / 2.0 ** (f_h + f_wa),
        sym_bound=sym_bound / 2.0 ** f_wr,
    )

    spec_h = FixedPointSpec(bits=ALU_BITS, scale=2.0 ** -f_h)
    entries = [
        StageEntry(
            # over budget iff the derived feature LSB had to be crushed
            # below the precision floor to keep every intermediate <= 32-bit
            stage=STAGE, resource="feature-frac-bits",
            used=cfg.min_feature_frac, budget=f_h,
            detail=f"f_h={f_h} = min(fit {f_fit}, Eq.39 {f_eq39}, "
                   f"ALU {f_mac}) at B_h={b_h:g}; floor {cfg.min_feature_frac}",
        ),
        StageEntry(
            stage=STAGE, resource="feature-acc-bits",
            used=_signed_bits(acc_bound), budget=ALU_BITS,
            detail=f"Eq. 39: horizon={horizon} tokens of {cfg.feature_bits}-bit "
                   f"features at scale 2^-{f_h} into the int32 (S, Z) analog",
        ),
        StageEntry(
            stage=STAGE, resource="overflow-horizon",
            used=horizon,
            budget=overflow_safe_horizon(b_h, 1.0, spec_h),
            detail=f"Eq. 39 safe horizon at scale 2^-{f_h}, B_phi={b_h:g}, R_v=1",
        ),
        StageEntry(
            stage=STAGE, resource="class-matmul-bits",
            used=_signed_bits(cls_bound), budget=ALU_BITS,
            detail=f"d={d} MACs of {cfg.feature_bits}x{cfg.weight_bits}-bit "
                   f"(fracs {f_h}+{f_wc})",
        ),
        StageEntry(
            stage=STAGE, resource="anom-matmul-bits",
            used=_signed_bits(anom_acc_bound), budget=ALU_BITS,
            detail=f"d={d} MACs + round-half constant, >>{nn_shift} to f_s={f_s}",
        ),
        StageEntry(
            stage=STAGE, resource="sym-acc-bits",
            used=_signed_bits(sym_acc_bound), budget=ALU_BITS,
            detail=f"{M} rule-table gathers at frac {f_wr}, >>{sym_shift}",
        ),
        StageEntry(
            stage=STAGE, resource="fusion-preact-bits",
            used=_signed_bits(fusion_bound), budget=ALU_BITS,
            detail=f"alpha_q*s_nn_q + beta_q*s_sym_q at frac {f_s}+{f_ab}, "
                   f"LUT over [-{cfg.lut_range:g}, {cfg.lut_range:g}]",
        ),
        StageEntry(
            stage=STAGE, resource="trust-divergence",
            used=eta, budget=cfg.max_divergence,
            detail=f"Thm A.3 composed float<->int bound (f_h={f_h}, f_s={f_s}, "
                   f"LUT {n_lut} buckets, trust LSB 2^-{f_t})",
        ),
    ]

    plan = IntScorePlan(
        feature_bits=cfg.feature_bits, feature_frac=f_h, feature_range=b_h,
        weight_bits=cfg.weight_bits, cls_frac=f_wc, anom_frac=f_wa,
        rule_frac=f_wr, score_frac=f_s, nn_shift=nn_shift, sym_shift=sym_shift,
        fusion_frac=f_ab, trust_frac=f_t, one_q=one_q, n_lut=n_lut,
        lut_shift=lut_shift, lut_range=cfg.lut_range, u_min_q=u_min_q,
        horizon=horizon, has_cls_bias=has_cls_bias, has_anom_bias=has_anom_bias,
        divergence=eta,
    )
    return plan, tables, entries


def divergence_bound(
    cfg: IntLoweringConfig,
    *,
    f_h: int,
    f_wa: int,
    f_wr: int,
    f_s: int,
    d: int,
    n_rules: int,
    sum_abs_anom_w: float,
    nn_bound: float,
    sym_bound: float,
) -> float:
    """Thm A.3 composition: worst-case |trust_float - trust_int| on the
    soft branch (the hard branch is exactly 1.0 on both sides): pooled-feature
    rounding (0.5 LSB per token, + 1 LSB from the floor-div pooling), weight
    rounding against the worst-case pooled magnitude, the three half-LSB
    requantization shifts, alpha/beta rounding against the score bounds, the
    LUT bucket width, trust-LSB rounding and the sigmoid tail beyond the
    LUT's range, composed through the 1/4-Lipschitz sigmoid."""
    s_h, s_wa, s_wr = 2.0 ** -f_h, 2.0 ** -f_wa, 2.0 ** -f_wr
    s_s, s_ab, s_t = 2.0 ** -f_s, 2.0 ** -cfg.fusion_frac, 2.0 ** -cfg.trust_frac
    e_pool = 1.5 * s_h  # per-scalar: token rounding + floor-div pooling
    e_nn = (e_pool * sum_abs_anom_w
            + 0.5 * s_wa * d * cfg.feature_range
            + 0.5 * s_s)
    e_sym = 0.5 * s_wr * n_rules + 0.5 * s_s
    # alpha/beta ~ 1 at fusion_frac; their rounding scales the score bounds
    e_u = ((1.0 + 0.5 * s_ab) * (e_nn + e_sym)
           + 0.5 * s_ab * (nn_bound + sym_bound)
           + 0.5 * s_s)
    bucket = 2.0 * cfg.lut_range / (1 << cfg.lut_bits)
    tail = 1.0 / (1.0 + math.exp(cfg.lut_range))
    return 0.25 * e_u + 0.25 * bucket + 0.5 * s_t + tail


# --------------------------------------------------------------------------
# the lowered program: int32 tensors only
# --------------------------------------------------------------------------

def quantize_features(plan: IntScorePlan, h: torch.Tensor) -> torch.Tensor:
    """The Map-stage boundary: float hidden state -> fixed-point feature.
    The one float->int crossing; everything downstream of it is integer."""
    max_int = 2 ** (plan.feature_bits - 1) - 1
    return to_int(torch.round(h.float() * (2.0 ** plan.feature_frac)), -max_int - 1, max_int,
                  torch.int32)


def int_mac(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (B, d) @ w (d, K)`` in int32 with two's-complement wrap, as XLA's
    int32 dot: a broadcast product summed in int32 (the card's matrix
    product has no int32 path)."""
    return torch.sum(x[:, :, None] * w[None, :, :], dim=1, dtype=torch.int32)


def int_flow_score(
    plan: IntScorePlan,
    tables: Dict[str, torch.Tensor],
    rules: symbolic.RuleSet,
    hidden_sum: torch.Tensor,  # (B, d) int32 — Σ h_q (the streaming S analog)
    count: torch.Tensor,  # (B,) int32 token counts (the Z analog)
    sig: torch.Tensor,  # (B, W) int32 cumulative signature bit patterns
    sticky_hard: torch.Tensor,  # (B,) bool
):
    """The integer score path (the ``int-emulation`` backend of the score
    stage): :func:`repro_torch.train.classifier.streaming_scores` over the
    lowered tables, int32 arithmetic only.  Returns ``(outputs,
    new_sticky)`` with quantized scores; :func:`dequantize_scores` widens
    them for the engine's float contract."""
    one = torch.ones((), dtype=torch.int32, device=count.device)
    pooled = torch.div(hidden_sum, torch.maximum(count, one)[:, None], rounding_mode="floor")
    logits_q = int_mac(pooled, tables["cls_w"])
    if plan.has_cls_bias:
        logits_q = logits_q + tables["cls_b"]
    nn_acc = int_mac(pooled, tables["anom_w"])[:, 0]
    if plan.has_anom_bias:
        nn_acc = nn_acc + tables["anom_b"][0]
    s_nn_q = _rshift_round(nn_acc, plan.nn_shift)

    hits = symbolic.ternary_match(sig, rules)  # bit-exact TCAM
    hard = symbolic.hard_hit(hits, rules) | sticky_hard
    zero = torch.zeros((), dtype=torch.int32, device=count.device)
    sym_acc = torch.sum(torch.where(hits, tables["rule_w"], zero), dim=-1, dtype=torch.int32)
    s_sym_q = _rshift_round(sym_acc, plan.sym_shift)

    u_acc = tables["alpha"] * s_nn_q + tables["beta"] * s_sym_q
    u_q = _rshift_round(u_acc, plan.fusion_frac)
    off = u_q - plan.u_min_q
    if plan.lut_shift >= 0:
        idx = torch.bitwise_right_shift(off, plan.lut_shift)
    else:
        idx = torch.bitwise_left_shift(off, -plan.lut_shift)
    idx = torch.clamp(idx, 0, plan.n_lut - 1)
    soft_q = tables["lut"][idx.long()]
    trust_q = torch.where(hard, torch.full_like(soft_q, plan.one_q), soft_q)  # Eq. 15 pin
    return {
        "class_logits": logits_q,  # int32; argmax is quantization-monotone
        "s_nn_q": s_nn_q,
        "s_sym_q": s_sym_q,
        "trust_q": trust_q,
        "hard_hit": hard,
    }, hard


def reference_flow_score(
    plan: IntScorePlan,
    tables: Dict[str, torch.Tensor],
    rules: symbolic.RuleSet,
    hidden_sum: torch.Tensor,
    count: torch.Tensor,
    sig: torch.Tensor,
    sticky_hard: torch.Tensor,
):
    """Float oracle of the lowered program: dequantize the compiled tables
    and the int accumulator, then run the exact float score path."""
    pooled = (hidden_sum.float() * 2.0 ** -plan.feature_frac
              / torch.clamp(count, min=1)[:, None].float())
    cls_w = tables["cls_w"].float() * 2.0 ** -plan.cls_frac
    anom_w = tables["anom_w"].float() * 2.0 ** -plan.anom_frac
    logits = pooled @ cls_w
    if plan.has_cls_bias:
        logits = logits + tables["cls_b"].float() * 2.0 ** -(plan.feature_frac + plan.cls_frac)
    s_nn = (pooled @ anom_w)[:, 0]
    if plan.has_anom_bias:
        s_nn = s_nn + (tables["anom_b"].float()
                       * 2.0 ** -(plan.feature_frac + plan.anom_frac))[0]
    hits = symbolic.ternary_match(sig, rules)
    hard = symbolic.hard_hit(hits, rules) | sticky_hard
    rule_w = tables["rule_w"].float() * 2.0 ** -plan.rule_frac
    s_sym = torch.sum(hits.float() * rule_w, dim=-1)
    alpha = tables["alpha"].float() * 2.0 ** -plan.fusion_frac
    beta = tables["beta"].float() * 2.0 ** -plan.fusion_frac
    soft = torch.sigmoid(alpha * s_nn + beta * s_sym)
    trust = torch.where(hard, torch.ones_like(soft), soft)
    return {
        "class_logits": logits,
        "s_nn": s_nn,
        "s_sym": s_sym,
        "trust": trust,
        "hard_hit": hard,
    }, hard


def dequantize_scores(plan: IntScorePlan, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Widen the quantized outputs to the engine's float contract.  2^-f
    scales are exact in fp32, so ``trust == 1.0`` iff ``trust_q == one_q``
    iff the hard veto fired."""
    s = dict(out)
    s["trust"] = out["trust_q"].float() * 2.0 ** -plan.trust_frac
    s["s_nn"] = out["s_nn_q"].float() * 2.0 ** -plan.score_frac
    s["s_sym"] = out["s_sym_q"].float() * 2.0 ** -plan.score_frac
    return s


def requantize_rule_weights(plan: IntScorePlan, weights: torch.Tensor) -> torch.Tensor:
    """Re-lower a swapped-in HL-MRF weight column at the installed plan's
    LSB — shape- and dtype-stable, so a swap rewrites the installed table."""
    return _q(weights, plan.rule_frac, plan.weight_bits)


# --------------------------------------------------------------------------
# graph audit: no float op may appear in the int score path
# --------------------------------------------------------------------------

def score_graph_inputs(tables: Dict[str, torch.Tensor], rules: symbolic.RuleSet
                       ) -> List[torch.Tensor]:
    """The leading inputs of :func:`score_graph`, in the JAX package's
    flatten order of ``(tables, rules)``: the tables by sorted key, then
    ``rules.tensors()``."""
    return [tables[k] for k in sorted(tables)] + list(rules.tensors())


def score_graph(plan: IntScorePlan, tables, rules: symbolic.RuleSet, batch: int,
                d_model: int) -> torch.fx.GraphModule:
    """:func:`int_flow_score` traced at the given shapes on fake tensors
    (nothing executes; the counterpart of ``score_jaxpr``).  Its inputs are
    flat, in the order ``(tables, rules, hidden_sum, count, sig, sticky)``
    with ``(tables, rules)`` as :func:`score_graph_inputs` gives them."""
    from repro_torch.analysis.graph_lint import trace_graph

    keys = sorted(tables)
    n = len(keys)
    W = rules.values.shape[1]
    flat = [t.detach().cpu() for t in score_graph_inputs(tables, rules)] + [
        torch.zeros((batch, d_model), dtype=torch.int32),
        torch.zeros((batch,), dtype=torch.int32),
        torch.zeros((batch, W), dtype=torch.int32),
        torch.zeros((batch,), dtype=torch.bool),
    ]

    def score(*xs):
        t = dict(zip(keys, xs[:n]))
        r = symbolic.RuleSet(*xs[n : n + 4])
        return int_flow_score(plan, t, r, *xs[n + 4 :])

    return trace_graph(score, *flat)


def float_ops_in_graph(gm) -> List[str]:
    """Labels of every float operand, result, literal or constant of a
    traced graph (:func:`repro_torch.analysis.graph_lint.float_ops_in_graph`)."""
    from repro_torch.analysis.graph_lint import float_ops_in_graph as _impl

    return _impl(gm)


def assert_integer_graph(plan: IntScorePlan, tables, rules: symbolic.RuleSet,
                         batch: int = 4, d_model: Optional[int] = None) -> None:
    """Raise if the lowered score program contains ANY float op."""
    d = d_model if d_model is not None else int(tables["cls_w"].shape[0])
    bad = float_ops_in_graph(score_graph(plan, tables, rules, batch, d))
    if bad:
        raise AssertionError(f"int-emulation score path contains float ops: {sorted(set(bad))}")
