"""Fused ingest on the card: one CUDA graph of the flow step per chunk width.

Counterpart of ``repro/kernels/flow_ingest/kernel.py:230
make_pallas_score_fn`` (:func:`make_score_fn`) and ``:246
fused_ingest_pallas`` (:class:`FlowStepGraphs`; its int-emulation branch
is :func:`make_int_score_fn`, the ``int_flow_score`` kernel as the graphed
step's score stage).  The JAX package compiles
one launch per width group, whose on-device loop runs the flow step once
per chunk.  In PyTorch the step is ~17,000 operator calls at the paper's
configuration (16 tokens x ~1,085 per decode token), each dispatched from
Python, so here the whole step — gather, the tokens through every layer's
``decode_step`` kernel, the signature, the ``flow_score`` kernel, scatter —
is captured once per width as a CUDA graph and replayed once per chunk:

* the graph reads a static ``(width, pkt_len + 2)`` int64 input (slots,
  fresh flags, tokens) and writes a static packed int32 output; the table
  tensors are updated in place, so their addresses are fixed;
* per chunk the host copies the chunk's row of the device-side stack into
  the static input, replays, and copies the static output into the batch's
  result tensor: three calls, all on the card's stream;
* every width shares one graph memory pool; replays are serial on one
  stream, and each graph's intermediates are dead when it ends.

Launch counts: a wrapper counts its launch in Python, which under capture
runs once, when nothing launches.  So a capture records how many launches
of each kernel its graph holds and takes them back off the counters, and
every replay adds them: the counters go on saying how many times each
kernel ran.

There is no eager route on the card: a failed capture or replay raises.
On the CPU the engine runs the same structure eagerly
(:func:`repro_torch.serve.flow_engine.make_fused_ingest`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.chimera_attention import ops as chimera_ops
from repro_torch.kernels.decode_step import ops as decode_ops
from repro_torch.kernels.flow_ingest import int_ops
from repro_torch.kernels.flow_ingest import ops as score_ops
from repro_torch.kernels.window_attention import ops as window_ops

# the kernels' wrappers, each with its ``launches`` counter
COUNTED = {
    "decode_step": decode_ops,
    "flow_score": score_ops,
    "int_flow_score": int_ops,
    "chimera_attention": chimera_ops,
    "window_attention": window_ops,
}


def make_score_fn(ccfg):
    """The ``flow_score`` kernel's wrapper as the flow step's score-stage hook
    ``(params, rules, pooled, sig, sticky) -> (outputs, new_sticky)``: the
    kernel on CUDA tensors, its plain version on CPU tensors."""

    def score_fn(params, rules, pooled, sig, sticky):
        return score_ops.flow_score(params, rules, pooled, sig, sticky, lambda_h=ccfg.lambda_h)

    return score_fn


def make_int_score_fn(plan):
    """The ``int_flow_score`` kernel's wrapper as the score-stage hook of the
    flow step under int-emulation, ``(int_tables, rules, hidden_sum, count,
    sig, sticky) -> (quantized outputs, new_sticky)``: the kernel on CUDA
    tensors, its plain version on CPU tensors."""

    def score_fn(tables, rules, hidden_sum, count, sig, sticky):
        return int_ops.int_flow_score(plan, tables, rules, hidden_sum, count, sig, sticky)

    return score_fn


def step_inputs(stack: torch.Tensor):
    """``(idx, tokens, fresh)`` of a chunk stack ``(..., w, pkt_len + 2)``
    int64: column 0 the slots, column 1 the fresh flags, then the tokens."""
    return stack[..., 0], stack[..., 2:], stack[..., 1] != 0


@dataclasses.dataclass
class StepGraph:
    """One captured width of the flow step."""

    graph: torch.cuda.CUDAGraph
    inp: torch.Tensor  # (width, pkt_len + 2) int64, the static input
    out: torch.Tensor  # (width, cols) int32, the static packed output
    launches: Dict[str, int]  # launches of each kernel the graph holds
    capture_s: float  # host seconds of the warm-up and the capture


class FlowStepGraphs:
    """The flow step as one CUDA graph per ``(width, pkt_len)``.

    ``body(*args, idx, tokens, fresh) -> (width, cols) int32`` is the step
    with its outputs packed; ``args`` are its weights, rules and the table
    tensors, which it updates in place; padding lanes point at ``scratch``.
    """

    def __init__(self, body: Callable, args: Tuple, *, scratch: int, device):
        self._body = body
        self._args = args
        self._scratch = scratch
        self._device = torch.device(device)
        self._pool = None  # one memory pool for every width
        self.graphs: Dict[Tuple[int, int], StepGraph] = {}
        self.replays = 0

    def _run_body(self, inp: torch.Tensor) -> torch.Tensor:
        return self._body(*self._args, *step_inputs(inp))

    def capture(self, width: int, pkt_len: int) -> StepGraph:
        """The graph of this width, captured first if need be."""
        key = (width, pkt_len)
        if key in self.graphs:
            return self.graphs[key]
        dev = self._device
        t0 = time.perf_counter()
        inp = torch.zeros((width, pkt_len + 2), dtype=torch.int64, device=dev)
        inp[:, 0] = self._scratch  # every lane on the scratch row
        # one eager run on a side stream first, as torch.cuda.graph asks (it
        # initialises the libraries' lazy state); scratch lanes change only
        # the scratch row, and its launches are real and stay counted
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run_body(inp)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = {name: mod.launches for name, mod in COUNTED.items()}
        with torch.cuda.graph(graph, pool=self._pool):
            out = self._run_body(inp)
        held = {}
        for name, mod in COUNTED.items():
            held[name] = mod.launches - before[name]
            mod.launches = before[name]  # recorded, not launched
        g = StepGraph(graph, inp, out, held, time.perf_counter() - t0)
        self.graphs[key] = g
        return g

    def run(self, width: int, stack: torch.Tensor, res: torch.Tensor) -> None:
        """Replay the width's graph once per chunk of ``stack (C, width,
        pkt_len + 2)``, in order, the packed outputs into ``res (C * width,
        cols)``."""
        g = self.capture(width, stack.shape[-1] - 2)
        n = stack.shape[0]
        for j in range(n):
            g.inp.copy_(stack[j])
            g.graph.replay()
            res[j * width : (j + 1) * width].copy_(g.out)
        self.replays += n
        for name, k in g.launches.items():
            COUNTED[name].launches += n * k
