"""Dataplane execution primitives: Partition / Map / SumReduce (paper Eqs.
1-3); port of ``repro.core.primitives``.

The paper's (and Pegasus') three dataplane-native primitives.  On a
programmable switch they are field extraction, fuzzy table lookup and
staged addition; on the card, blocking (Partition), per-block elementwise or
table compute (Map) and reductions (SumReduce).  Plain tensor code: the
JAX package has no kernel for them.  ``jax.vmap`` of a single Map function
becomes ``torch.vmap``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

SegmentFn = Callable[[torch.Tensor], torch.Tensor]


def partition(x: torch.Tensor, num_segments: int, axis: int = 0) -> torch.Tensor:
    """Partition(X) = {X_1, ..., X_k} (Eq. 1).

    Splits ``x`` along ``axis`` into ``num_segments`` equal segments, stacked
    on a new leading axis so that Map and SumReduce stay vectorized.
    """
    if x.shape[axis] % num_segments != 0:
        raise ValueError(
            f"axis {axis} of length {x.shape[axis]} not divisible into "
            f"{num_segments} segments"
        )
    seg = x.shape[axis] // num_segments
    moved = torch.movedim(x, axis, 0)
    parts = moved.reshape((num_segments, seg) + tuple(moved.shape[1:]))
    # put the original axis back (now within each segment)
    return torch.movedim(parts, 1, axis + 1 if axis >= 0 else axis)


def map_segments(fn: Union[SegmentFn, Sequence[SegmentFn]], segments: torch.Tensor) -> torch.Tensor:
    """Map(F, {X_i}) = {F_i(X_i)} (Eq. 2).

    ``fn`` is either a single function applied to every segment (vmapped: the
    homogeneous "fuzzy table" case) or a sequence of per-segment functions
    (heterogeneous MAT stages).
    """
    if callable(fn):
        return torch.vmap(fn)(segments)
    fns = list(fn)
    if len(fns) != segments.shape[0]:
        raise ValueError(f"{len(fns)} functions for {segments.shape[0]} segments")
    return torch.stack([f(segments[i]) for i, f in enumerate(fns)], dim=0)


def sum_reduce(ys: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """SumReduce({Y_i}) = sum_i Y_i (Eq. 3)."""
    return torch.sum(ys, dim=axis)


def partition_map_sumreduce(x: torch.Tensor, fn: SegmentFn, num_segments: int,
                            axis: int = 0) -> torch.Tensor:
    """The whole Partition -> Map -> SumReduce chain, the canonical dataplane
    program: how the linearized-attention aggregates phi(K)^T V and
    phi(K)^T 1 (Eq. 6) are tiled to fit dataplane memory."""
    return sum_reduce(map_segments(fn, partition(x, num_segments, axis)))
