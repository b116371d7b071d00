"""Integer score stage of flow ingest (the ``int-emulation`` backend): the
CUDA kernel's wrapper and its plain version.

Replaces ``repro/compile/int_lowering.py::int_flow_score`` (:367, jnp
int32, no ``pallas_call``) with ``csrc/int_flow_score.cu``: floor-division
pooling, the class and anomaly MACs with their biases, the rounding-shift
requantization, the TCAM match with the sticky hard veto and the rule-weight
sum, the Eq. 15 fusion, the sigmoid LUT and the pin of ``trust_q`` to
``one_q``, for one arrival round of lanes, all in int32 (two's-complement
wrap, as XLA computes it).  Same contract as the plain version
:func:`repro_torch.compile.int_lowering.int_flow_score`: returns
``({class_logits, s_nn_q, s_sym_q, trust_q, hard_hit}, new_sticky)``.

:func:`int_flow_score` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; any other device raises.  ``launches``
counts kernel launches (never plain calls).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.compile import int_lowering as il
from repro_torch.core import symbolic
from repro_torch.kernels import _build

launches = 0

int_flow_score_plain = il.int_flow_score


def contract(*, d: int, K: int, W: int, M: int, plan: il.IntScorePlan) -> Optional[str]:
    """``None`` if the kernel takes these widths and this plan, else what it
    refuses (the launcher's checks, csrc/int_flow_score.cu): any widths with
    d and W positive, shifts in 0..31, |lut_shift| < 32."""
    if d <= 0 or K < 0 or W <= 0 or M < 0:
        return f"d {d}, K {K}, W {W}, M {M}: d and W positive, K and M not negative"
    shifts = {"nn_shift": plan.nn_shift, "sym_shift": plan.sym_shift,
              "fusion_frac": plan.fusion_frac}
    bad = {k: v for k, v in shifts.items() if not 0 <= v < 32}
    if bad or not -32 < plan.lut_shift < 32 or plan.n_lut <= 0:
        return f"shifts {shifts}, lut_shift {plan.lut_shift}, n_lut {plan.n_lut} out of range"
    return None


def fast_path(tables: Dict[str, torch.Tensor], rules: symbolic.RuleSet,
              sig: torch.Tensor) -> bool:
    """Whether the kernel's launcher takes its fast path (every load issued
    before the first use) for these CUDA tensors, as the launcher itself
    decides (csrc/int_flow_score.cu), or else its generic loops."""
    if sig.device.type != "cuda":
        raise ValueError(f"int_flow_score: no kernel path for device {sig.device}")
    d, K = tables["cls_w"].shape
    M, W = rules.values.shape
    return bool(_build.load_library().int_flow_score_fast_path(
        *map(_build.ptr, (tables["cls_w"], sig, rules.values, rules.masks)), d, K, W, M))


Outputs = Dict[str, torch.Tensor]


def _check(plan, tables, rules, hidden_sum, count, sig, sticky):
    B, d = hidden_sum.shape
    W = sig.shape[-1]
    M = rules.values.shape[0]
    K = tables["cls_w"].shape[-1]
    i32 = torch.int32
    want = [
        ("hidden_sum", hidden_sum, (B, d), i32), ("count", count, (B,), i32),
        ("sig", sig, (B, W), i32), ("sticky", sticky, (B,), torch.bool),
        ("cls_w", tables["cls_w"], (d, K), i32), ("anom_w", tables["anom_w"], (d, 1), i32),
        ("values", rules.values, (M, W), i32), ("masks", rules.masks, (M, W), i32),
        ("rule_w", tables["rule_w"], (M,), i32), ("hard", rules.hard, (M,), torch.bool),
        ("alpha", tables["alpha"], (), i32), ("beta", tables["beta"], (), i32),
        ("lut", tables["lut"], (plan.n_lut,), i32),
    ]
    if plan.has_cls_bias:
        want.append(("cls_b", tables["cls_b"], (K,), i32))
    if plan.has_anom_bias:
        want.append(("anom_b", tables["anom_b"], (1,), i32))
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"int_flow_score: {name} is {tuple(t.shape)}/{t.dtype}, want {shape}/{dtype}"
            )
        if t.device != hidden_sum.device:
            raise ValueError(
                f"int_flow_score: {name} on {t.device}, hidden_sum on {hidden_sum.device}"
            )
    return [t for _, t, _, _ in want], (B, d, K, W, M)


def int_flow_score(
    plan: il.IntScorePlan,
    tables: Dict[str, torch.Tensor],
    rules: symbolic.RuleSet,
    hidden_sum: torch.Tensor,  # (B, d) int32 — Σ h_q
    count: torch.Tensor,  # (B,) int32 token counts
    sig: torch.Tensor,  # (B, W) int32 cumulative signature bit patterns
    sticky: torch.Tensor,  # (B,) bool lifetime veto bit
) -> Tuple[Outputs, torch.Tensor]:
    global launches
    tensors, (B, d, K, W, M) = _check(plan, tables, rules, hidden_sum, count, sig, sticky)
    if hidden_sum.device.type == "cpu":
        return int_flow_score_plain(plan, tables, rules, hidden_sum, count, sig, sticky)
    if hidden_sum.device.type != "cuda":
        raise RuntimeError(f"int_flow_score: no kernel for device {hidden_sum.device}")
    refused = contract(d=d, K=K, W=W, M=M, plan=plan)
    if refused:
        raise ValueError(f"int_flow_score: outside the kernel's contract: {refused}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("int_flow_score: the kernel takes contiguous tensors only")
    lib = _build.load_library()
    dev = hidden_sum.device
    logits = torch.empty((B, K), dtype=torch.int32, device=dev)
    s_nn_q, s_sym_q, trust_q = (torch.empty((B,), dtype=torch.int32, device=dev)
                                for _ in range(3))
    hard = torch.empty((B,), dtype=torch.bool, device=dev)
    err = lib.int_flow_score_launch(
        *map(_build.ptr, (
            hidden_sum, count, sig, sticky, tables["cls_w"], tables.get("cls_b"),
            tables["anom_w"], tables.get("anom_b"), rules.values, rules.masks,
            tables["rule_w"], rules.hard, tables["alpha"], tables["beta"], tables["lut"],
            logits, s_nn_q, s_sym_q, trust_q, hard,
        )),
        B, d, K, W, M, plan.nn_shift, plan.sym_shift, plan.fusion_frac, plan.u_min_q,
        plan.lut_shift, plan.n_lut, plan.one_q,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "int_flow_score")
    launches += 1
    return {
        "class_logits": logits,
        "s_nn_q": s_nn_q,
        "s_sym_q": s_sym_q,
        "trust_q": trust_q,
        "hard_hit": hard,
    }, hard
