"""Model assembly for the dense Chimera stack (port of
``repro.models.model``: ``_block_forward`` :89, ``_group_forward`` :176,
``init_model`` :188, ``_scan_groups`` :205, ``forward`` :221, ``_head``
:241, ``loss_fn`` :264, ``init_caches`` :300, ``_block_decode`` :309 and
``decode_hidden_step`` :335).

The parameter layout is the JAX package's: per-group block parameters are
stacked on a leading "layers" axis under ``params["blocks"]["b<j>"]``, and
the caches likewise.  The JAX ``scan`` over groups becomes a Python loop
over that axis; the caches are updated in place.  Only the dense Chimera
stack (pattern ``("attn",)``, SwiGLU MLP) is ported.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.chimera_attention import ChimeraState
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_norm,
    dense,
    embed,
    init_dense,
    init_embedding,
    init_mlp,
    init_norm,
    mlp,
)

Params = Dict[str, Any]


def _require_dense(cfg: ArchConfig) -> None:
    if any(kind != "attn" for kind in cfg.pattern) or cfg.family != "dense":
        raise NotImplementedError("only the dense Chimera stack is ported")


def _init_block(cfg: ArchConfig, g: torch.Generator, device) -> Params:
    p = {"ln1": init_norm(cfg.d_model, device), "attn": attn.init_attention(cfg, g, device)}
    if cfg.d_ff:
        p["ln2"] = init_norm(cfg.d_model, device)
        p["mlp"] = init_mlp(g, cfg.d_model, cfg.d_ff, device)
    return p


def stack_params(trees: list) -> Params:
    """Stack identical dict trees along a new leading 'layers' axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_params([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=0)


def index_params(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: index_params(v, i) for k, v in tree.items()}
    return tree[i]


def init_model(cfg: ArchConfig, g: torch.Generator, device=None) -> Params:
    """Random weights with the JAX package's layout.  ``device=None`` means
    ``"cuda"``; without a GPU it raises."""
    _require_dense(cfg)
    device = resolve_device(device, "init_model")
    p: Params = {"embed": init_embedding(g, cfg.padded_vocab, cfg.d_model, device)}
    groups = [
        {f"b{j}": _init_block(cfg, g, device) for j in range(len(cfg.pattern))}
        for _ in range(cfg.n_groups)
    ]
    p["blocks"] = stack_params(groups)
    p["final_norm"] = init_norm(cfg.d_model, device)
    if not cfg.tie_embeddings:
        p["head"] = init_dense(g, cfg.d_model, cfg.padded_vocab, device=device)
    return p


def _block_forward(cfg: ArchConfig, bp: Params, x, positions, causal: bool = True):
    h = apply_norm(bp["ln1"], x, cfg.norm_type)
    x = x + attn.attention_layer(cfg, bp["attn"], h, positions, causal=causal)
    if "ln2" in bp:
        h = apply_norm(bp["ln2"], x, cfg.norm_type)
        x = x + mlp(bp["mlp"], h)
    return x


def _group_forward(cfg: ArchConfig, gp: Params, x, positions, causal: bool = True):
    for j in range(len(cfg.pattern)):
        x = _block_forward(cfg, gp[f"b{j}"], x, positions, causal)
    return x


def _scan_groups(cfg: ArchConfig, stacked: Params, x, positions, causal: bool = True):
    """The JAX scan over groups as a loop over the stacked layer axis.
    Returns ``(x, aux)``; the dense stack has no auxiliary loss."""
    for gi in range(cfg.n_groups):
        x = _group_forward(cfg, index_params(stacked, gi), x, positions, causal)
    return x, torch.zeros((), device=x.device)


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """batch: {"tokens": (B,T) int[, "positions"]}.  Returns
    (logits (B,T,V_padded), aux_loss)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = embed(params["embed"], tokens)
    x, aux = _scan_groups(cfg, params["blocks"], x, positions)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return _head(cfg, params, x), aux


def _head(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return dense(params["head"], x)


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Next-token cross-entropy with the 1e-4 z-loss.  Returns
    (total, {"nll", "aux", "zloss"})."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    zloss = 1e-4 * torch.mean(torch.square(logz))
    total = loss + zloss + 1e-2 * aux
    return total, {"nll": loss, "aux": aux, "zloss": zloss}


def init_caches(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None):
    """Zero decode caches.  ``device=None`` means ``"cuda"``; without a GPU
    it raises."""
    _require_dense(cfg)
    device = resolve_device(device, "init_caches")
    return {
        f"b{j}": attn.init_attention_cache(cfg, batch, dtype, device, lead=(cfg.n_groups,))
        for j in range(len(cfg.pattern))
    }


def _block_decode(cfg: ArchConfig, bp: Params, x_t, position, cache: ChimeraState):
    h = apply_norm(bp["ln1"], x_t, cfg.norm_type)
    x_t = x_t + attn.attention_decode(cfg, bp["attn"], h, position, cache)
    if "ln2" in bp:
        h = apply_norm(bp["ln2"], x_t, cfg.norm_type)
        x_t = x_t + mlp(bp["mlp"], h)
    return x_t


def decode_hidden_step(
    cfg: ArchConfig,
    params: Params,
    token: torch.Tensor,  # (B,) int
    position: torch.Tensor,  # (B,) int
    caches,  # from init_caches, updated in place
) -> torch.Tensor:
    """One streaming step to the final-norm hidden state: (B,) -> (B, d)."""
    x = embed(params["embed"], token[:, None])
    for gi in range(cfg.n_groups):
        for j in range(len(cfg.pattern)):
            c = caches[f"b{j}"]
            layer = ChimeraState(c.S[gi], c.Z[gi], c.k_buf[gi], c.v_buf[gi], c.count[gi])
            bp = index_params(params["blocks"][f"b{j}"], gi)
            x = _block_decode(cfg, bp, x, position, layer)
            c.count[gi] = layer.count
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return x[:, 0]
