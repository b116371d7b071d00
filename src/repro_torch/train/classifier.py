"""The paper's task head: neuro-symbolic traffic classification (port of
``repro.train.classifier``: ``ClassifierConfig`` :30, ``init_classifier``
:49, ``packet_signature`` :61, ``streaming_scores`` :76, ``default_rules``
:182).

``streaming_scores`` is the ``flow_score`` kernel's wrapper: on a CUDA
tensor every call launches ``csrc/flow_score.cu``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import fusion as fusion_mod
from repro_torch.core import symbolic
from repro_torch.kernels.flow_ingest import ops as score_ops
from repro_torch.models import model as M
from repro_torch.models.layers import init_dense


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    arch: ArchConfig
    n_classes: int = 8
    marker_base: int = 256  # tokens >= marker_base are field markers
    sig_words: int = 8  # 256 marker bits -> 8 packed 32-bit words
    lambda_h: bool = True


def init_classifier(ccfg: ClassifierConfig, g: torch.Generator, device="cpu"):
    return {
        "backbone": M.init_model(ccfg.arch, g, device),
        "cls": init_dense(g, ccfg.arch.d_model, ccfg.n_classes, device=device),
        "anom": init_dense(g, ccfg.arch.d_model, 1, device=device),
        "fusion": fusion_mod.init_fusion(fusion_mod.FusionConfig(), device),
    }


def packet_signature(ccfg: ClassifierConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Presence bitmap of marker tokens → packed int32 signature (B, W)."""
    marker = tokens.long() - ccfg.marker_base  # (B, T); <0 for body bytes
    n_bits = 32 * ccfg.sig_words
    onehot = torch.nn.functional.one_hot(torch.clamp(marker, 0, n_bits - 1), n_bits)
    onehot = onehot * (marker >= 0)[..., None]
    bits = torch.clamp(torch.sum(onehot, dim=1), max=1)  # (B, n_bits)
    return symbolic.pack_bits(bits)


def streaming_scores(
    ccfg: ClassifierConfig,
    params,
    rules: symbolic.RuleSet,
    pooled: torch.Tensor,  # (B, d) running mean of final-norm hidden states
    sig: torch.Tensor,  # (B, W) int32 cumulative packed marker signature
    sticky_hard: torch.Tensor,  # (B,) bool — flows already vetoed by TCAM
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Score flows from streaming aggregates (the FlowEngine hot path): class
    head, anomaly head, TCAM match, sticky hard veto, soft score and Eq. 15
    fusion.  Returns (outputs, new_sticky)."""
    return score_ops.flow_score(
        params, rules, pooled, sig, sticky_hard, lambda_h=ccfg.lambda_h
    )


def default_rules(ccfg: ClassifierConfig, anomaly_tokens, device="cpu") -> symbolic.RuleSet:
    """One hard rule matching the known-bad signature tokens."""
    n_bits = 32 * ccfg.sig_words
    toks = torch.as_tensor(anomaly_tokens, dtype=torch.long)
    bits = torch.zeros((1, n_bits), dtype=torch.long)
    bits[0, torch.clamp(toks - ccfg.marker_base, 0, n_bits - 1)] = 1
    value = symbolic.pack_bits(bits)
    return symbolic.RuleSet(
        values=value,
        masks=value.clone(),  # care exactly about the anomaly marker bits
        weights=torch.tensor([4.0]),
        hard=torch.tensor([True]),
    ).to(device)
