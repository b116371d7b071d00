"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
``repro.optim.optimizer``).

Parameters are nested dicts of tensors; the optimizer state mirrors them
(m, v in fp32) plus an int32 step counter.  Updates are functional, as in
the JAX package: :func:`adamw_update` returns new trees and leaves its
inputs untouched, unless the caller donates them (``donate=True``, the
Trainer's step).  Leaves are visited in sorted-key order, the order of
``jax.tree_util`` for dicts, so that sums over leaves add in the same order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch


def tree_flatten(tree: Any) -> Tuple[List[torch.Tensor], Callable[[List[Any]], Any]]:
    """Leaves of a nested dict in sorted-key order, and the function that
    rebuilds the same nesting from a list of new leaves."""
    if not isinstance(tree, dict):
        return [tree], lambda xs: xs[0]
    keys = sorted(tree)
    parts = [tree_flatten(tree[k]) for k in keys]
    leaves = [leaf for ls, _ in parts for leaf in ls]
    # the rebuilder keeps the nesting, not the leaves (a donated tree's
    # leaves must be free to go)
    sizes, uns = [len(ls) for ls, _ in parts], [un for _, un in parts]

    def unflatten(xs):
        out, i = {}, 0
        for k, n, un in zip(keys, sizes, uns):
            out[k] = un(xs[i:i + n])
            i += n
        return out

    return leaves, unflatten


def _clear(tree: Any) -> None:
    """Empty a nested dict in place, so that it no longer holds its leaves."""
    if isinstance(tree, dict):
        for sub in tree.values():
            _clear(sub)
        tree.clear()


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, unflatten = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return unflatten([fn(*xs) for xs in zip(leaves, *others)])


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "float32"

    @property
    def _mdt(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.moments_dtype]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_optimizer(params: Any, cfg: AdamWConfig = AdamWConfig()) -> Dict[str, Any]:
    def zeros(t):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=cfg._mdt, device=p.device), t)

    leaves = tree_flatten(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return {"m": zeros(params), "v": zeros(params), "step": step}


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_flatten(tree)[0]
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def adamw_update(
    cfg: AdamWConfig, params: Any, grads: Any, state: Dict[str, Any], donate: bool = False
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: clip by global norm, decoupled weight decay on
    matrices only (``ndim >= 2``).  Every leaf needs a gradient (zeros for
    leaves with no path to the loss, which are still decayed).

    ``donate`` hands the input trees over, as ``jax.jit``'s buffer donation
    does: ``params``, ``grads`` and the moments are emptied, and each old
    leaf is released as soon as its new value is made, so the old and the
    new trees never coexist whole (at Mixtral's full width they would take
    2 x 38 GB).  The caller must hold no other reference to those leaves."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m32.to(cfg._mdt), v32.to(cfg._mdt)

    flat_p, unflatten = tree_flatten(params)
    flat_g, flat_m, flat_v = (tree_flatten(t)[0] for t in (grads, state["m"], state["v"]))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("adamw_update: params, grads and moments differ in structure")
    if donate:
        for t in (params, grads, state["m"], state["v"]):
            _clear(t)
    out = []
    for i in range(len(flat_p)):
        out.append(upd(flat_p[i], flat_g[i], flat_m[i], flat_v[i]))
        if donate:
            flat_p[i] = flat_g[i] = flat_m[i] = flat_v[i] = None
    new_p, new_m, new_v = (unflatten([o[i] for o in out]) for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
