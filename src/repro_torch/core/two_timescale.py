"""The table install of the two-timescale loop (port of
``repro.core.two_timescale`` :329 ``atomic_swap`` and :340
``measure_install_time``).  The controller is not ported yet.

The JAX package's install returns a new pytree.  Here the installed tensors
are rewritten in place: the fused engine's CUDA graphs captured their
addresses, so a new tensor would never be read.  The copies go on the
current stream, behind every replay already launched on it, which is what
"between ticks" means on the card.  Eq. 18's "device-ready" semantics is a
``torch.cuda.synchronize()`` at the end.
"""

from __future__ import annotations

import time
from typing import List

import torch


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    if hasattr(tree, "tensors"):  # RuleSet
        return list(tree.tensors())
    raise TypeError(f"atomic_swap: no tensors in a {type(tree).__name__}")


def _sync(tensors: List[torch.Tensor]) -> None:
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def atomic_swap(installed, new):
    """Copy every tensor of ``new`` into the matching tensor of ``installed``
    (same structure, shapes and dtypes) in place; returns ``installed`` once
    the copies are device-ready."""
    dst, src = _leaves(installed), _leaves(new)
    if len(dst) != len(src):
        raise ValueError(f"atomic_swap: {len(src)} tensors for {len(dst)} installed ones")
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"atomic_swap: {tuple(s.shape)}/{s.dtype} into an installed "
                             f"{tuple(d.shape)}/{d.dtype}")
        if d is not s:
            d.copy_(s)
    _sync(dst)
    return installed


def measure_install_time(fn, *args) -> float:
    """Wall-clock seconds of ``fn(*args)`` until its tensors are device-ready."""
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(_leaves(out))
    return time.perf_counter() - t0
