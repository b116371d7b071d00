"""Model assembly for the decode path (port of ``repro.models.model``:
``init_model`` :188, ``init_caches`` :300, ``_block_decode`` :309 and
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

from repro_torch.configs.base import ArchConfig
from repro_torch.core.chimera_attention import ChimeraState
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_norm,
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


def init_model(cfg: ArchConfig, g: torch.Generator, device="cpu") -> Params:
    """Random weights with the JAX package's layout (``head`` is the LM head,
    carried for layout parity; the classifier's decode path does not read it)."""
    _require_dense(cfg)
    p: Params = {"embed": init_embedding(g, cfg.padded_vocab, cfg.d_model, device)}
    groups = [
        {f"b{j}": _init_block(cfg, g, device) for j in range(len(cfg.pattern))}
        for _ in range(cfg.n_groups)
    ]
    p["blocks"] = stack_params(groups)
    p["final_norm"] = init_norm(cfg.d_model, device)
    p["head"] = init_dense(g, cfg.d_model, cfg.padded_vocab, device=device)
    return p


def init_caches(cfg: ArchConfig, batch: int, dtype=torch.float32, device="cpu"):
    _require_dense(cfg)
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
