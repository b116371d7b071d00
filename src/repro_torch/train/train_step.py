"""Training step of the language-model objective (port of
``repro.train.train_step``: ``cast_for_compute`` :22, ``make_train_step``
:35 and ``make_train_state`` :54).

``jax.value_and_grad`` becomes :func:`value_and_grad`: every parameter
leaf gets a gradient, and a leaf with no path to the loss gets zeros (JAX's
behaviour), so that AdamW still decays it.  A tree with an integer leaf (a
fixed-point codebook table) raises ``TypeError``, as ``jax.value_and_grad``
does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim.optimizer import (
    AdamWConfig,
    adamw_update,
    init_optimizer,
    tree_flatten,
    tree_map,
)


def value_and_grad(fn: Callable[[Any], Tuple[torch.Tensor, Any]], params: Any):
    """``((loss, aux), grads)`` of ``fn(params) -> (loss, aux)`` with respect
    to every leaf of ``params``; the outputs are detached."""
    leaves, unflatten = tree_flatten(params)
    for p in leaves:
        if not (p.dtype.is_floating_point or p.dtype.is_complex):
            raise TypeError(f"grad requires real- or complex-valued inputs, but got {p.dtype}")
    xs = [p.detach().requires_grad_(True) for p in leaves]
    loss, aux = fn(unflatten(xs))
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    aux = tree_map(lambda a: a.detach(), aux)
    return (loss.detach(), aux), unflatten(grads)


def cast_for_compute(cfg: ArchConfig, params: Any) -> Any:
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    if dtype == torch.float32:
        return params
    return tree_map(
        lambda p: p.to(dtype) if p.dtype == torch.float32 and p.ndim >= 2 else p, params
    )


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, donate: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the LM loss (:func:`repro_torch.models.model.loss_fn`), its
    gradients and one AdamW update.  With ``donate`` the step takes over
    ``params`` and ``opt_state`` (see :func:`adamw_update`): the caller
    keeps only what the step returns."""

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        (loss, metrics), grads = value_and_grad(
            lambda p: M.loss_fn(cfg, cast_for_compute(cfg, p), batch), params
        )
        new_params, new_opt, om = adamw_update(opt_cfg, params, grads, opt_state, donate=donate)
        return new_params, new_opt, {**metrics, **om, "loss": loss}

    return train_step


def make_train_state(cfg: ArchConfig, g: torch.Generator, device=None):
    """``(params, opt_state)`` from a seeded generator; ``device=None`` means
    ``"cuda"`` and raises without a GPU.  (The JAX version also returns the
    sharding axes, which the port has no use for.)"""
    params = M.init_model(cfg, g, device)
    return params, init_optimizer(params)
