"""Cascade neuro-symbolic fusion (paper Eq. 15).

S = 1                          if 𝕀_sym = 1 and λ_h = 1   (hard veto)
    σ(α·s_nn + β·s_sym)        otherwise                   (soft blend)
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    lambda_h: bool = True
    alpha_init: float = 1.0
    beta_init: float = 1.0


def init_fusion(cfg: FusionConfig, device="cpu"):
    return {
        "alpha": torch.tensor(cfg.alpha_init, dtype=torch.float32, device=device),
        "beta": torch.tensor(cfg.beta_init, dtype=torch.float32, device=device),
    }


def cascade_fusion(params, s_nn, s_sym, hard, lambda_h: bool = True):
    """Eq. 15, vectorized and branch-free."""
    soft = torch.sigmoid(params["alpha"] * s_nn + params["beta"] * s_sym)
    if not lambda_h:
        return soft
    return torch.where(hard, torch.ones_like(soft), soft)
