"""Kernel feature maps φ for linearized attention (paper Eq. 5, Thm A.1).

Port of ``repro.core.feature_maps``:

* ``elu1``    — φ(x) = elu(x)+1 (optionally after a fixed projection to m);
* ``relu``    — φ(x) = relu(x) + 1e-6 (same projection rule);
* ``exp_prf`` — Performer-style positive random features, unbiased for the
  exp kernel (Thm A.1), with block-orthogonal rows;
* ``codebook`` — the dataplane's "fuzzy Map table": inputs are assigned to
  the nearest of ``codebook_size`` centroids and φ is a gather from a
  (optionally fixed-point) table.  :func:`compile_codebook` builds it from
  a base map (the control plane's table construction); the trainer's
  two-timescale loop reclusters its centroids.

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
    kind: str = "elu1"  # elu1 | relu | exp_prf | codebook
    m: int = 0  # feature dim; 0 means "same as input d" (elu1/relu only)
    input_scale: float = 2.0  # R: post-normalization norm (R² = max logit)
    codebook_size: int = 256
    codebook_bits: int = 0  # 0 = fp32 table; 8/16 = fixed-point table
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
    if cfg.kind == "codebook":
        centroids = torch.randn((cfg.codebook_size, d), generator=g, device=g.device)
        table = torch.nn.functional.elu(
            torch.randn((cfg.codebook_size, m), generator=g, device=g.device)) + 1.0
        return {"centroids": centroids.to(device), "table": table.to(device),
                "table_scale": torch.ones((), device=device)}
    raise ValueError(f"unknown feature map kind {cfg.kind!r}")


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
    if cfg.kind == "codebook":
        codes = assign_codes(params["centroids"], xh)
        table = params["table"]
        if cfg.codebook_bits:
            table = table.float() * params["table_scale"]
        return table[codes]
    raise ValueError(f"unknown feature map kind {cfg.kind!r}")


def assign_codes(centroids: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment (the dataplane's fuzzy-index Map lookup):
    argmin of ‖c‖² − 2xᵀc (‖x‖² is constant per row); ties go to the lower
    index, as ``jnp.argmin``'s do."""
    dots = _matmul(x, centroids.T)
    c2 = torch.sum(centroids * centroids, dim=-1)
    return torch.argmin(c2 - 2.0 * dots, dim=-1)


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the operands' common type, as jnp promotes it: bfloat16
    activations against the float32 map give float32 features."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def phi_norm_bound(cfg: FeatureMapConfig, d: int) -> float:
    """Analytic B_φ (Eq. 21) for overflow sizing (Thm A.3)."""
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
    if cfg.kind == "codebook":
        return math.sqrt(m) * (r + 1.0)
    raise ValueError(f"unknown feature map kind {cfg.kind!r}")


def compile_codebook(
    cfg: FeatureMapConfig,
    base_cfg: FeatureMapConfig,
    base_params: Params,
    samples: torch.Tensor,
    key,
    kmeans_iters: int = 10,
) -> Params:
    """Compile a smooth feature map into a codebook table (control-plane op):
    cluster the normalized samples with k-means on the samples' device
    (``key`` a :func:`~repro_torch.core.two_timescale.prng_key`, whose first
    centroid is drawn on the host as JAX's ``randint`` draws it), evaluate
    the base φ at each centroid, and store the results as the Map table,
    fixed-point with one scale when ``cfg.codebook_bits`` is set.  The
    result lies on the samples' device, as in the JAX package."""
    from repro_torch.core.quantization import quantize_per_channel
    from repro_torch.core.two_timescale import kmeans  # no cycle at import

    device = samples.device
    xh = _normalize(samples.reshape(-1, samples.shape[-1]), cfg.input_scale)
    centroids, _ = kmeans(xh.float(), cfg.codebook_size, kmeans_iters, key)
    table = apply_feature_map(base_cfg, base_params, centroids)
    table_scale = torch.ones((), device=device)
    if cfg.codebook_bits:
        qt = quantize_per_channel(table, cfg.codebook_bits, axis=None)
        table, table_scale = qt.values, qt.scale
    return {"centroids": centroids, "table": table, "table_scale": table_scale}
