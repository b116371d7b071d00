"""Streaming-score stage of flow ingest: the CUDA kernel's wrapper and its
plain version.

Replaces ``repro/kernels/flow_ingest/kernel.py::flow_ingest_scores_pallas``
with ``csrc/flow_score.cu``: class and anomaly heads, TCAM ternary match,
sticky hard veto, soft score and Eq. 15 cascade fusion for one arrival
round of lanes.  Same contract as ``repro.train.classifier
.streaming_scores``: returns ``({class_logits, s_nn, s_sym, hard_hit,
trust}, new_sticky)``.  Signatures are int32 bit patterns.

:func:`flow_score` launches the kernel for CUDA tensors and runs
:func:`flow_score_plain` for CPU tensors; any other device raises.
``launches`` counts kernel launches (never plain calls).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import fusion as fusion_mod
from repro_torch.core import symbolic
from repro_torch.kernels import _build

launches = 0


def contract(*, d: int, K: int, W: int, M: int) -> Optional[str]:
    """``None`` if the kernel takes these widths, else what it refuses.  It
    takes any: K = 8, W = 8, d a multiple of 32 up to 256 run its fast path,
    every other shape its generic loops (csrc/flow_score.cu)."""
    if d <= 0 or K < 0 or W <= 0 or M < 0:
        return f"d {d}, K {K}, W {W}, M {M}: d and W positive, K and M not negative"
    return None


Outputs = Dict[str, torch.Tensor]


def _dense(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def flow_score_plain(
    params, rules: symbolic.RuleSet, pooled, sig, sticky, *, lambda_h: bool = True
) -> Tuple[Outputs, torch.Tensor]:
    """Plain PyTorch version with the kernel's contract (see :func:`flow_score`)."""
    class_logits = _dense(params["cls"], pooled)
    s_nn = _dense(params["anom"], pooled)[..., 0]
    hits = symbolic.ternary_match(sig, rules)
    hard = symbolic.hard_hit(hits, rules) | sticky
    s_sym = symbolic.soft_score(hits, rules)
    trust = fusion_mod.cascade_fusion(params["fusion"], s_nn, s_sym, hard, lambda_h=lambda_h)
    return {
        "class_logits": class_logits,
        "s_nn": s_nn,
        "s_sym": s_sym,
        "hard_hit": hard,
        "trust": trust,
    }, hard


def _check(params, rules, pooled, sig, sticky):
    B, d = pooled.shape
    W = sig.shape[-1]
    M = rules.values.shape[0]
    K = params["cls"]["w"].shape[-1]
    want = [
        ("pooled", pooled, (B, d), torch.float32), ("sig", sig, (B, W), torch.int32),
        ("sticky", sticky, (B,), torch.bool),
        ("cls.w", params["cls"]["w"], (d, K), torch.float32),
        ("anom.w", params["anom"]["w"], (d, 1), torch.float32),
        ("values", rules.values, (M, W), torch.int32),
        ("masks", rules.masks, (M, W), torch.int32),
        ("weights", rules.weights, (M,), torch.float32),
        ("hard", rules.hard, (M,), torch.bool),
        ("alpha", params["fusion"]["alpha"], (), torch.float32),
        ("beta", params["fusion"]["beta"], (), torch.float32),
    ]
    if "b" in params["cls"]:
        want.append(("cls.b", params["cls"]["b"], (K,), torch.float32))
    if "b" in params["anom"]:
        want.append(("anom.b", params["anom"]["b"], (1,), torch.float32))
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"flow_score: {name} is {tuple(t.shape)}/{t.dtype}, want {shape}/{dtype}"
            )
        if t.device != pooled.device:
            raise ValueError(f"flow_score: {name} on {t.device}, pooled on {pooled.device}")
    return [t for _, t, _, _ in want], (B, d, K, W, M)


def flow_score(
    params,  # {"cls": {"w"[, "b"]}, "anom": {"w"[, "b"]}, "fusion": {"alpha", "beta"}}
    rules: symbolic.RuleSet,
    pooled: torch.Tensor,  # (B, d) running mean of decoded features
    sig: torch.Tensor,  # (B, W) int32 cumulative packed marker signature
    sticky: torch.Tensor,  # (B,) bool lifetime veto bit
    *,
    lambda_h: bool = True,
) -> Tuple[Outputs, torch.Tensor]:
    global launches
    tensors, (B, d, K, W, M) = _check(params, rules, pooled, sig, sticky)
    if pooled.device.type == "cpu":
        return flow_score_plain(params, rules, pooled, sig, sticky, lambda_h=lambda_h)
    if pooled.device.type != "cuda":
        raise RuntimeError(f"flow_score: no kernel for device {pooled.device}")
    refused = contract(d=d, K=K, W=W, M=M)
    if refused:
        raise ValueError(f"flow_score: outside the kernel's contract: {refused}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("flow_score: the kernel takes contiguous tensors only")
    lib = _build.load_library()
    dev = pooled.device
    logits = torch.empty((B, K), dtype=torch.float32, device=dev)
    s_nn, s_sym, trust = (torch.empty((B,), dtype=torch.float32, device=dev) for _ in range(3))
    hard = torch.empty((B,), dtype=torch.bool, device=dev)
    err = lib.flow_score_launch(
        *map(_build.ptr, (
            pooled, sig, sticky, params["cls"]["w"], params["cls"].get("b"),
            params["anom"]["w"], params["anom"].get("b"), rules.values, rules.masks,
            rules.weights, rules.hard, params["fusion"]["alpha"], params["fusion"]["beta"],
            logits, s_nn, s_sym, trust, hard,
        )),
        B, d, K, W, M, int(bool(lambda_h)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "flow_score")
    launches += 1
    return {
        "class_logits": logits,
        "s_nn": s_nn,
        "s_sym": s_sym,
        "hard_hit": hard,
        "trust": trust,
    }, hard
