"""The paper's task head: neuro-symbolic traffic classification (port of
``repro.train.classifier``: ``ClassifierConfig`` :30, ``hidden_states``
:39, ``init_classifier`` :49, ``packet_signature`` :61,
``streaming_scores`` :76, ``classifier_forward`` :109, ``classifier_loss``
:135, ``accuracy_metrics`` :163, ``default_rules`` :182), and the repo's
training loop for it (``train_classifier`` and ``eval_classifier``, the
counterparts of ``benchmarks/common.py:42-82``).

``streaming_scores`` is the ``flow_score`` kernel's wrapper: on a CUDA
tensor every call launches ``csrc/flow_score.cu``.  ``classifier_forward``
runs the backbone through the ``chimera_attention`` kernel and computes the
heads in plain PyTorch, where gradients flow.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import fusion as fusion_mod
from repro_torch.core import symbolic
from repro_torch.kernels.flow_ingest import ops as score_ops
from repro_torch.models import model as M
from repro_torch.models.layers import apply_norm, dense, embed, init_dense
from repro_torch.optim.optimizer import AdamWConfig, adamw_update, init_optimizer
from repro_torch.train.train_step import value_and_grad


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    arch: ArchConfig
    n_classes: int = 8
    marker_base: int = 256  # tokens >= marker_base are field markers
    sig_words: int = 8  # 256 marker bits -> 8 packed 32-bit words
    lambda_h: bool = True


def hidden_states(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Backbone final-norm hidden states (B, T, d)."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = embed(params["embed"], tokens)
    x, _ = M._scan_groups(cfg, params["blocks"], x, positions)
    return apply_norm(params["final_norm"], x, cfg.norm_type)


def init_classifier(ccfg: ClassifierConfig, g: torch.Generator, device=None):
    """Random weights with the JAX package's layout.  ``device=None`` means
    ``"cuda"``; without a GPU it raises."""
    device = resolve_device(device, "init_classifier")
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


def classifier_forward(
    ccfg: ClassifierConfig, params, rules: symbolic.RuleSet, batch: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    h = hidden_states(ccfg.arch, params["backbone"], batch)
    pooled = torch.mean(h, dim=1)  # (B, d)
    class_logits = dense(params["cls"], pooled)
    s_nn = dense(params["anom"], pooled)[..., 0]
    sig = packet_signature(ccfg, batch["tokens"])
    hits = symbolic.ternary_match(sig, rules)  # (B, M)
    hard = symbolic.hard_hit(hits, rules)
    s_sym = symbolic.soft_score(hits, rules)
    trust = fusion_mod.cascade_fusion(
        params["fusion"], s_nn, s_sym, hard, lambda_h=ccfg.lambda_h
    )
    return {
        "class_logits": class_logits,
        "s_nn": s_nn,
        "s_sym": s_sym,
        "hard_hit": hard,
        "trust": trust,
    }


def classifier_loss(
    ccfg: ClassifierConfig, params, rules: symbolic.RuleSet, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy of the class head, plus BCE of the soft fusion branch
    when the batch carries ``anomalous`` labels."""
    out = classifier_forward(ccfg, params, rules, batch)
    logits = out["class_logits"]
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    ce = torch.mean(logz - torch.gather(logits, 1, labels[:, None])[:, 0])
    loss = ce
    metrics = {"ce": ce}
    if "anomalous" in batch:
        y = batch["anomalous"].to(torch.float32)
        # the soft branch only: the hard veto is constant (Eq. 15's cascade)
        soft = fusion_mod.cascade_fusion(
            params["fusion"], out["s_nn"], out["s_sym"], out["hard_hit"], lambda_h=False
        )
        bce = -torch.mean(y * torch.log(soft + 1e-7) + (1 - y) * torch.log(1 - soft + 1e-7))
        loss = loss + bce
        metrics["bce"] = bce
    return loss, metrics


def accuracy_metrics(preds: torch.Tensor, labels: torch.Tensor, n_classes: int):
    """Macro precision / recall / F1 (paper's Table 1 metrics)."""
    pr, rc, f1 = [], [], []
    for c in range(n_classes):
        tp = torch.sum((preds == c) & (labels == c))
        fp = torch.sum((preds == c) & (labels != c))
        fn = torch.sum((preds != c) & (labels == c))
        p = tp / torch.clamp(tp + fp, min=1)
        r = tp / torch.clamp(tp + fn, min=1)
        pr.append(p)
        rc.append(r)
        f1.append(2 * p * r / torch.clamp(p + r, min=1e-9))
    return tuple(float(torch.mean(torch.stack(x))) for x in (pr, rc, f1))


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A stream's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def train_classifier(ccfg: ClassifierConfig, stream, params, steps: int = 50, lr: float = 3e-3):
    """The repo's training loop for the classifier objective
    (``benchmarks/common.py:42``): AdamW, warmup 3, on ``stream`` batches,
    starting from ``params`` on their device.  Returns ``(params, rules,
    losses)`` with the loss of every step, as one tensor."""
    device = params["cls"]["w"].device
    rules = default_rules(ccfg, stream._anomaly_sig, device=device)
    ocfg = AdamWConfig(lr=lr, warmup_steps=3, total_steps=steps)
    opt = init_optimizer(params, ocfg)
    losses = []
    for _ in range(steps):
        batch = batch_to_device(stream.next_batch(), device)
        (loss, _), grads = value_and_grad(
            lambda p: classifier_loss(ccfg, p, rules, batch), params
        )
        params, opt, _ = adamw_update(ocfg, params, grads, opt)
        losses.append(loss)
    return params, rules, torch.stack(losses)


def eval_classifier(ccfg: ClassifierConfig, params, rules, stream, batches: int = 4):
    """Macro precision, recall and F1 over ``batches`` batches of ``stream``
    (``benchmarks/common.py:69``), plus the trust scores and anomaly labels."""
    device = params["cls"]["w"].device
    preds, labels, trusts, anoms = [], [], [], []
    with torch.no_grad():
        for _ in range(batches):
            b = stream.next_batch()
            out = classifier_forward(ccfg, params, rules, batch_to_device(b, device))
            preds.append(torch.argmax(out["class_logits"], -1).cpu())
            labels.append(torch.from_numpy(b["labels"]))
            trusts.append(out["trust"].cpu().numpy())
            anoms.append(b["anomalous"])
    pr, rc, f1 = accuracy_metrics(torch.cat(preds), torch.cat(labels), ccfg.n_classes)
    return {"pr": pr, "rc": rc, "f1": f1,
            "trust": np.concatenate(trusts), "anom": np.concatenate(anoms)}


def default_rules(ccfg: ClassifierConfig, anomaly_tokens, device=None) -> symbolic.RuleSet:
    """One hard rule matching the known-bad signature tokens.  ``device=None``
    means ``"cuda"``; without a GPU it raises."""
    device = resolve_device(device, "default_rules")
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
