"""Mixture-of-Experts layer (port of ``repro.models.moe``: ``init_moe`` :29
and ``moe_layer`` :49).

Group-limited capacity-factor einsum dispatch: tokens are split into groups
of ``MOE_GROUP_SIZE``, each group sends every token to its top-k experts
with a per-expert capacity C = max(1, int(group·top_k·cf/E)); a selection
past its expert's capacity is dropped (that token keeps only the residual
stream for that expert).  Positions in an expert's buffer follow the
token-major, then choice, order of the reference's cumsum.  Returns the
Switch load-balancing loss beside the output.

The expert products are plain large products, left to ``torch.einsum`` as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import init_dense, init_mlp, mlp, normal, promote

Params = dict

MOE_GROUP_SIZE = 512


def init_moe(cfg: ArchConfig, g: torch.Generator, device="cpu") -> Params:
    d = cfg.d_model
    e_ff = cfg.moe_d_ff or cfg.d_ff
    E = cfg.moe_experts
    p = {"router": init_dense(g, d, E, device=device)}
    p["wi"] = normal(g, (E, d, e_ff), 1.0 / math.sqrt(d), device)
    p["wg"] = normal(g, (E, d, e_ff), 1.0 / math.sqrt(d), device)
    p["wo"] = normal(g, (E, e_ff, d), 1.0 / math.sqrt(e_ff), device)
    if cfg.moe_shared_experts:
        p["shared"] = init_mlp(g, d, e_ff * cfg.moe_shared_experts, device)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties to the lower index (a stable sort)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_layer(cfg: ArchConfig, params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d), aux_loss ()).  ``out`` is in the
    promoted type of x and the (float32) expert weights."""
    B, T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    g = min(MOE_GROUP_SIZE, T)
    N = B * T
    if N % g:
        raise ValueError(f"moe_layer: {N} tokens do not split into groups of {g}")
    G = N // g
    C = max(1, int(g * k * cfg.capacity_factor / E))
    xg = x.reshape(G, g, d)

    xr, wr = promote(xg, params["router"]["w"])
    logits = torch.einsum("sgd,de->sge", xr, wr)
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = _top_k(probs, k)  # (G, g, k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)

    # position of each selection within its expert's capacity buffer
    onehot = F.one_hot(ids, E).float()  # (G, g, k, E)
    flat = onehot.reshape(G, g * k, E)
    pos = torch.cumsum(flat, dim=1) - 1.0
    pos = torch.sum(pos * flat, dim=-1).reshape(G, g, k)
    keep = (pos < C).float()
    # one_hot of a position past the capacity is a zero row in jax; here it
    # is clamped into range and then zeroed by `keep`
    pos_oh = F.one_hot(pos.long().clamp(max=C - 1), C).float() * keep[..., None]
    disp = torch.einsum("sgke,sgkc->sgec", onehot, pos_oh)
    comb = torch.einsum("sgke,sgkc,sgk->sgec", onehot, pos_oh, gates)

    disp, xd = promote(disp, xg)
    expert_in = torch.einsum("sgec,sgd->secd", disp, xd)  # (G, E, C, d)
    ei, wg, wi, wo = promote(expert_in, params["wg"], params["wi"], params["wo"])
    h = F.silu(torch.einsum("secd,edf->secf", ei, wg))
    h = h * torch.einsum("secd,edf->secf", ei, wi)
    y = torch.einsum("secf,efd->secd", h, wo)
    comb, y = promote(comb, y)
    out = torch.einsum("sgec,secd->sgd", comb, y).reshape(B, T, d)

    if cfg.moe_shared_experts:
        out = out + mlp(params["shared"], x)

    # Switch load-balance loss: E·Σ_e f_e·P_e
    f_e = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))  # fraction routed
    p_e = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(f_e / k * p_e)
    return out, aux
