"""LM-serving launcher (port of ``repro.launch.serve``): batched requests
against a model deployed through the compiled DataplaneProgram artifact
(``program.deploy(DeploySpec(engine="lm"))``), on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chimera-dataplane \\
        --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The flags are the JAX launcher's (``--arch``, ``--smoke``, ``--requests``,
``--slots``, ``--prompt-len``, ``--max-new``, ``--backend``) and
``--device`` (``cuda`` unless ``cpu`` is asked for; without a GPU it
raises).  As there, the prompts go through ``submit``/``step`` (teacher
forcing) and the engine's length cap is 512 tokens; ``--prefill`` ingests
each group of ``--slots`` prompts with ``prefill_batch`` instead (one
chunk-parallel forward; Chimera configs run the ``chimera_attention``
kernel there), and ``--max-len`` raises the cap for long prompts.  The
model zoo's full-width configs exceed the DataplaneSpec's shared SRAM in
the compiler's ``resource-ledger`` stage, in both packages (1.10769e9 bits
against 1.00663e9 for Mixtral-8x7B): ``--waive resource-ledger`` records
the violation in the ledger and deploys.  The
weights are random, drawn from a ``torch.Generator`` seeded 0; the prompts
from numpy's ``default_rng(0)``, as the JAX launcher draws them.

:func:`build` and :func:`serve` are the CLI's body, callable in-process
with another config (a model cut in depth) or weights; :func:`main`
parses, builds, serves and prints the JAX launcher's summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, List, Optional


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="chimera-dataplane")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--backend", default=None,
                    help="score backend of the compiled program: None/xla | int-emulation")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default) or cpu")
    ap.add_argument("--prefill", action="store_true",
                    help="ingest each group of --slots prompts with prefill_batch")
    ap.add_argument("--max-len", type=int, default=512,
                    help="the engine's length cap per slot")
    ap.add_argument("--waive", action="append", default=[], metavar="STAGE",
                    help="a ledger stage to waive (recorded, not dropped); repeatable")
    return ap


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return make_parser().parse_args(argv)


@dataclasses.dataclass
class Deployment:
    """What :func:`build` made: the compiled program and its LM engine."""

    args: argparse.Namespace
    program: Any
    engine: Any


@dataclasses.dataclass
class ServeResult:
    requests: List[Any]  # the served Requests, with their generations
    seconds: float  # host wall clock around serving, ending in a synchronize
    ticks: int
    prefill_seconds: float = 0.0  # of which in prefill_batch (--prefill)


def build(args: argparse.Namespace, params=None, arch=None) -> Deployment:
    """Compile and deploy as the CLI does.  ``arch`` replaces the registry's
    config (for example one cut in depth); ``params`` the seed-0 random
    classifier weights of that config, on ``args.device``."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.compile import compile_program
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.train import classifier as C

    device = resolve_device(args.device, "serve")
    if arch is None:
        arch = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    M.refuse_encdec(arch, "the LM launcher")
    # LM serving has no field-marker alphabet: marker_base = vocab keeps the
    # signature tier to its minimal one-word layout, and the full-size arch's
    # per-flow state is amortized over shared SRAM (waived, audited)
    ccfg = C.ClassifierConfig(arch=arch, n_classes=2, marker_base=arch.vocab_size)
    if params is None:
        params = C.init_classifier(ccfg, torch.Generator().manual_seed(0), device=device)
    program = compile_program(
        ccfg, params, backend=args.backend,
        waivers=(() if args.smoke else ("state-quantization",)) + tuple(args.waive),
    )
    engine = program.deploy(DeploySpec(engine="lm", batch_slots=args.slots,
                                       max_len=args.max_len, device=device))
    return Deployment(args=args, program=program, engine=engine)


def _sync(engine) -> None:
    import torch

    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def serve(dep: Deployment) -> ServeResult:
    """Serve ``--requests`` random prompts; with ``--prefill``, in groups of
    ``--slots`` through ``prefill_batch`` and ``step``."""
    import numpy as np

    from repro_torch.serve.engine import Request

    args, engine = dep.args, dep.engine
    vocab = dep.program.ccfg.arch.vocab_size
    rng = np.random.default_rng(0)
    reqs = [Request(rid=rid, prompt=rng.integers(0, vocab, size=(args.prompt_len,)).tolist(),
                    max_new_tokens=args.max_new) for rid in range(args.requests)]
    ticks0 = engine.stats.ticks
    prefill_s = 0.0
    _sync(engine)
    t0 = time.perf_counter()
    if args.prefill:
        for i in range(0, len(reqs), args.slots):
            t1 = time.perf_counter()
            engine.prefill_batch(reqs[i:i + args.slots])
            _sync(engine)
            prefill_s += time.perf_counter() - t1
            engine.run_until_done()
    else:
        for r in reqs:
            engine.submit(r)
        while engine.pending or any(r is not None for r in engine.active):
            engine.step()
    _sync(engine)
    return ServeResult(reqs, time.perf_counter() - t0, engine.stats.ticks - ticks0, prefill_s)


def summary(dep: Deployment, res: ServeResult) -> str:
    """The JAX launcher's summary line."""
    args = dep.args
    total = args.requests * (args.prompt_len + args.max_new)
    return (f"served {args.requests} requests, {total} tokens in {res.seconds:.2f}s "
            f"({total / res.seconds:.0f} tok/s, {res.ticks} engine ticks, "
            f"{args.slots} slots, backend={dep.program.backend})")


def main(argv: Optional[List[str]] = None) -> int:
    dep = build(parse_args(argv))
    print(summary(dep, serve(dep)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
