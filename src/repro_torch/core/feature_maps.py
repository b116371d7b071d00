"""Kernel feature maps φ for linearized attention (paper Eq. 5, Thm A.1).

Port of ``repro.core.feature_maps`` for the maps the decode path uses:

* ``elu1``    — φ(x) = elu(x)+1 (optionally after a fixed projection to m);
* ``relu``    — φ(x) = relu(x) + 1e-6 (same projection rule);
* ``exp_prf`` — Performer-style positive random features, unbiased for the
  exp kernel (Thm A.1), with block-orthogonal rows.

Inputs are L2-normalized and rescaled to ``input_scale`` before the map, so
the exp-kernel local window is numerically safe without a running max.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FeatureMapConfig:
    kind: str = "elu1"  # elu1 | relu | exp_prf
    m: int = 0  # feature dim; 0 means "same as input d" (elu1/relu only)
    input_scale: float = 2.0  # R: post-normalization norm (R² = max logit)
    orthogonal: bool = True  # orthogonalize random-feature rows (exp_prf)

    def feature_dim(self, d: int) -> int:
        return self.m if self.m > 0 else d


def _normalize(x: torch.Tensor, scale: float) -> torch.Tensor:
    n = torch.sqrt(torch.sum(torch.square(x.float()), dim=-1, keepdim=True))
    return x * (scale / torch.clamp(n, min=1e-6)).to(x.dtype)


def _orthogonal_gaussian(g: torch.Generator, m: int, d: int) -> np.ndarray:
    """Block-orthogonal Gaussian matrix (Performer's ORF construction):
    QR of a Gaussian block, rows rescaled to chi(d) norms."""
    def gauss():  # drawn on the generator's device
        return torch.randn((d, d), generator=g, dtype=torch.float64, device=g.device).cpu()

    blocks = []
    for _ in range(math.ceil(m / d)):
        q, _ = np.linalg.qr(gauss().numpy())
        norms = np.linalg.norm(gauss().numpy(), axis=-1)
        blocks.append(q * norms[:, None])
    return np.concatenate(blocks, axis=0)[:m]


def init_feature_map(
    cfg: FeatureMapConfig, d: int, g: torch.Generator, device="cpu"
) -> Params:
    m = cfg.feature_dim(d)
    if cfg.kind in ("elu1", "relu"):
        if m == d:
            return {}
        proj = torch.randn((d, m), generator=g, device=g.device) / math.sqrt(d)
        return {"proj": proj.to(device)}
    if cfg.kind == "exp_prf":
        if cfg.orthogonal:
            w = torch.from_numpy(_orthogonal_gaussian(g, m, d)).float()
        else:
            w = torch.randn((m, d), generator=g, device=g.device)
        return {"w": w.to(device)}
    raise ValueError(f"unknown or unported feature map kind {cfg.kind!r}")


def apply_feature_map(cfg: FeatureMapConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> φ(x): (..., m).  Always strictly positive outputs."""
    xh = _normalize(x, cfg.input_scale)
    if cfg.kind in ("elu1", "relu"):
        z = _matmul(xh, params["proj"]) if "proj" in params else xh
        if cfg.kind == "elu1":
            return torch.nn.functional.elu(z) + 1.0
        return torch.relu(z) + 1e-6
    if cfg.kind == "exp_prf":
        w = params["w"]
        m = w.shape[0]
        # approximate exp(qᵀk/√d): feed x / d^{1/4} so <q',k'> = qᵀk/√d
        d = x.shape[-1]
        xs = xh / (d ** 0.25)
        sq = 0.5 * torch.sum(xs * xs, dim=-1, keepdim=True)
        return torch.exp(_matmul(xs, w.T) - sq) / math.sqrt(m)
    raise ValueError(f"unknown or unported feature map kind {cfg.kind!r}")


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the operands' common type, as jnp promotes it: bfloat16
    activations against the float32 map give float32 features."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def phi_norm_bound(cfg: FeatureMapConfig, d: int) -> float:
    """Analytic B_φ (Eq. 21) for overflow sizing (Thm A.3); the codebook
    map's branch is left out with the map."""
    m = cfg.feature_dim(d)
    r = cfg.input_scale
    if cfg.kind == "elu1":
        return math.sqrt(m) * (r + 1.0)
    if cfg.kind == "relu":
        return r + 1e-6
    if cfg.kind == "exp_prf":
        # per-feature exp(‖w_i‖ r / d^{1/4}) / sqrt(m); use 3σ row norm
        wnorm = math.sqrt(d) + 3.0
        return math.exp(wnorm * r / d ** 0.25)
    raise ValueError(f"unknown or unported feature map kind {cfg.kind!r}")
