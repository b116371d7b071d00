"""Traffic-serving launcher (port of ``repro.launch.flow_serve``): compile the
classifier into a DataplaneProgram, deploy it on a ``FlowEngine`` on the
card, stream FlowScenario packets through it.

    PYTHONPATH=src python -m repro_torch.launch.flow_serve --scenario port-scan \\
        --batches 8 --capacity 2048 [--backend int-emulation] [--ledger]

``--fused`` serves through the fused path: one CUDA graph of the flow step
per chunk width, captured up front by ``warm_fused`` and fed through the
:class:`~repro_torch.serve.ingest_pipeline.AsyncIngestPipeline` staging
ring (or straight from the adaptation loop under ``--adapt``).

``--adapt`` streams a non-stationary :class:`~repro_torch.data.pipeline
.DriftScenario` (``--drift-phases``; the default ends in an adversarial
signature surge) through an :class:`~repro_torch.serve.adaptive_loop
.AdaptiveLoop`, which recompiles and installs the symbolic tables when its
drift policy fires, on a background thread unless ``--adapt-sync``.
``--drift-phases`` without ``--adapt`` serves the same schedule with no
loop (the baseline).  ``--campaign NAME`` replays a registered campaign
(its geometry, schedule and policy) under the loop; ``--trace PATH`` (or
``--trace sample``) replays a recorded chimera-trace-v1 file.  The full
arch's flow table exceeds the switch budget: give it
``--state-budget-bytes``.

    PYTHONPATH=src python -m repro_torch.launch.flow_serve --adapt --fused
    PYTHONPATH=src python -m repro_torch.launch.flow_serve --smoke --campaign scan-evasion
    PYTHONPATH=src python -m repro_torch.launch.flow_serve --smoke --trace sample --device cpu

The weights are random, drawn from a ``torch.Generator`` seeded 0.  The
engine runs on ``--device`` (``cuda`` unless ``cpu`` is asked for; without
a GPU it raises).  ``--num-shards``, ``--elastic``, ``--reshard``,
``--checkpoint-dir``, ``--checkpoint-every`` and ``--host-devices`` raise:
sharded and elastic serving wait for ROADMAP Queue 1 item 10.

:func:`build` and :func:`serve` are the CLI's body, callable in-process
(``chip_smoke.py`` and the tests drive them); :func:`main` parses, builds,
serves and prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

NOT_PORTED = (
    "{flag}: sharded and elastic serving are not ported yet (ROADMAP Queue 1, "
    "item 10 'Sharding on one H100'); serve one FlowEngine instead"
)
# flag -> argparse destination of the options that wait for the sharded engines
SHARDING_FLAGS = {
    "--num-shards": "num_shards", "--elastic": "elastic", "--reshard": "reshard",
    "--checkpoint-dir": "checkpoint_dir", "--checkpoint-every": "checkpoint_every",
    "--host-devices": "host_devices",
}
DEFAULT_DRIFT = "protocol-mix:6,rule-violating:8:1:0.6,heavy-churn:6:1"


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.flow_serve")
    ap.add_argument("--arch", default="chimera-dataplane")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (default: the full arch)")
    ap.add_argument("--scenario", default="mix",
                    help="mix | protocol-mix | port-scan | burst | "
                         "heavy-churn | rule-violating")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--packets", type=int, default=256, help="packets/batch")
    ap.add_argument("--pkt-len", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--idle-timeout", type=int, default=0)
    ap.add_argument("--state-budget-bytes", type=int, default=0,
                    help="flow-table byte budget (0: the DataplaneSpec's shared "
                         "SRAM, which the full arch's table exceeds)")
    ap.add_argument("--fused", action="store_true",
                    help="fused ingest: one CUDA graph of the flow step per "
                         "chunk width, behind the async staging ring")
    ap.add_argument("--backend", default=None,
                    help="score backend: None/xla (float) | int-emulation")
    ap.add_argument("--save-program", default=None, metavar="DIR",
                    help="serialize the compiled program")
    ap.add_argument("--ledger", action="store_true",
                    help="print the per-stage resource ledger")
    ap.add_argument("--adapt", action="store_true",
                    help="serve a DriftScenario under the closed-loop "
                         "AdaptiveLoop (drift detect -> delta -> install)")
    ap.add_argument("--adapt-sync", action="store_true",
                    help="run the control plane inline at the triggering "
                         "tick instead of on a background thread")
    ap.add_argument("--drift-phases", default=None,
                    help="DriftScenario schedule: comma-separated "
                         "kind:batches[:sig_rotation[:anomaly_rate]] (default "
                         f"under --adapt: {DEFAULT_DRIFT}); without --adapt the "
                         "schedule is served with no loop")
    ap.add_argument("--campaign", default=None, metavar="NAME",
                    help="replay a registered adversarial campaign under the "
                         "AdaptiveLoop with its pinned geometry and policy; "
                         "implies --adapt")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="replay a recorded chimera-trace-v1 file ('sample' "
                         "= the committed fixture) instead of a generator")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default) or cpu")
    # the sharded and elastic options of the JAX package's launcher: they raise
    ap.add_argument("--num-shards", type=int, default=0)
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--reshard", default="")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--host-devices", type=int, default=0)
    return ap


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = make_parser()
    args = ap.parse_args(argv)
    for flag, dest in SHARDING_FLAGS.items():
        if getattr(args, dest) != ap.get_default(dest):
            raise NotImplementedError(NOT_PORTED.format(flag=flag))
    if args.campaign and args.trace:
        ap.error("--campaign and --trace are mutually exclusive")
    args.batches_given = args.batches != ap.get_default("batches")
    return args


@dataclasses.dataclass
class Deployment:
    """What :func:`build` made: the compiled program, its engine on the
    device, the traffic source and, under ``--adapt``, the loop."""

    args: argparse.Namespace
    program: Any
    engine: Any
    scenario: Any
    loop: Any = None  # AdaptiveLoop under --adapt / --campaign
    pipe: Any = None  # AsyncIngestPipeline under --fused without --adapt
    label: str = ""
    warmed: int = 0  # widths whose graphs warm_fused captured


@dataclasses.dataclass
class ServeResult:
    packets: int
    seconds: float  # host wall clock around the batches, generation included
    batches: Optional[List[Dict[str, np.ndarray]]] = None  # kept inputs
    outputs: Optional[List[Dict[str, np.ndarray]]] = None  # kept outputs

    @property
    def packets_per_s(self) -> float:
        return self.packets / self.seconds


def build(args: argparse.Namespace, params=None) -> Deployment:
    """Compile and deploy as the CLI does.  ``params`` replaces the seed-0
    random weights (same config); they must be on ``args.device``."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.compile import compile_program
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.data.pipeline import DriftScenario, FlowScenario, parse_phases
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig
    from repro_torch.train import classifier as C

    device = resolve_device(args.device, "flow_serve")
    arch = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    vocab = max(arch.vocab_size, 512)  # byte + marker alphabet
    arch = dataclasses.replace(arch, vocab_size=vocab)
    ccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256)
    if params is None:
        params = C.init_classifier(ccfg, torch.Generator().manual_seed(0), device=device)

    campaign = None
    if args.campaign:
        from repro_torch.data.campaigns import get_campaign

        campaign = get_campaign(args.campaign)
        # the campaign pins its own geometry so scorecards stay comparable
        args.pkt_len = campaign.pkt_len
        args.packets = campaign.packets_per_batch
        args.adapt = True
        scenario = campaign.scenario(vocab_size=vocab)
        if not args.batches_given:
            args.batches = campaign.batches
        label = f"campaign:{campaign.name}"
        print(f"campaign {campaign.name!r}: {campaign.goal}")
    elif args.trace:
        from repro_torch.data import traces as TR

        path = None if args.trace == "sample" else args.trace
        trace = TR.load_trace(path or TR.SAMPLE_TRACE)
        args.pkt_len = trace.meta.pkt_len
        scenario = TR.TraceReplayScenario(trace, packets_per_batch=args.packets)
        if not args.batches_given:
            args.batches = scenario.batches_per_cycle
        args.batches = min(args.batches, scenario.batches_per_cycle)
        label = f"trace:{args.trace}"
        print(f"trace {args.trace!r}: {len(trace.flow_ids)} packets / "
              f"{scenario.batches_per_cycle} batches")
    elif args.adapt or args.drift_phases:
        scenario = DriftScenario(
            phases=parse_phases(args.drift_phases or DEFAULT_DRIFT), vocab_size=vocab,
            pkt_len=args.pkt_len, packets_per_batch=args.packets, seed=0,
        )
        label = "drift"
    else:
        scenario = FlowScenario(kind=args.scenario, vocab_size=vocab, pkt_len=args.pkt_len,
                                packets_per_batch=args.packets, seed=0)
        label = args.scenario
    # the signature-layout pass sizes sig_words so every marker owns a TCAM
    # bit; the rules callable sees the finalized layout.  The full arch
    # exceeds the 1 KB/flow switch budget, so its per-flow stage is waived
    # (recorded in the ledger, not dropped), as in the JAX package.
    program = compile_program(
        ccfg, params,
        rules=lambda c: C.default_rules(c, scenario.anomaly_signature, device=device),
        backend=args.backend,
        waivers=() if args.smoke else ("state-quantization",),
        verify=False,
    )
    if args.ledger:
        print(program.ledger.as_table())
    if args.save_program:
        program.save(args.save_program)
        print(f"program saved to {args.save_program}")
    fcfg = FlowEngineConfig(capacity=args.capacity, lanes=args.lanes,
                            idle_timeout=args.idle_timeout, fused=args.fused,
                            state_budget_bytes=args.state_budget_bytes)
    engine = program.deploy(DeploySpec(flow=fcfg, device=device))
    dep = Deployment(args=args, program=program, engine=engine, scenario=scenario,
                     label=label)
    if args.adapt:
        from repro_torch.serve.adaptive_loop import (
            AdaptiveLoop, AdaptiveLoopConfig, DriftPolicy,
        )

        policy, loop_cfg = None, {}
        if campaign is not None:
            from repro_torch.serve.redteam import split_policy

            drift, loop_cfg = split_policy(campaign.policy)
            policy = DriftPolicy(**drift)
        dep.loop = AdaptiveLoop(engine, policy=policy,
                                cfg=AdaptiveLoopConfig(sync=args.adapt_sync, **loop_cfg))
    if args.fused:
        dep.warmed = engine.warm_fused(args.pkt_len)  # captured outside the timer
        print(f"fused: warmed {dep.warmed} width(s), ring depth {fcfg.ring_slots}")
        if dep.loop is None:
            from repro_torch.serve.ingest_pipeline import AsyncIngestPipeline

            dep.pipe = AsyncIngestPipeline(engine)
    return dep


def serve(dep: Deployment, keep: bool = False) -> ServeResult:
    """Stream ``args.batches`` scenario batches through the deployment and
    close the loop (an in-flight control-plane epoch is installed).  With
    ``keep`` the batches and their outputs come back too."""
    args, engine, loop, pipe = dep.args, dep.engine, dep.loop, dep.pipe
    sink = loop if loop is not None else engine
    batches, outputs = [], []
    t0 = time.perf_counter()
    pkts = 0
    for _ in range(args.batches):
        batch = dep.scenario.next_batch()
        if pipe is not None:
            pipe.submit(batch["flow_ids"], batch["tokens"])
        else:
            out = sink.ingest(batch["flow_ids"], batch["tokens"])
            if keep:
                outputs.append(out)
        if keep:
            batches.append(batch)
        pkts += len(batch["flow_ids"])
    if pipe is not None:
        drained = pipe.drain()
        if keep:
            outputs = drained
    if loop is not None:
        loop.close()  # drain any in-flight control-plane epoch
    if engine.device.type == "cuda":
        import torch

        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    return ServeResult(pkts, dt, batches if keep else None, outputs if keep else None)


def report(dep: Deployment, res: ServeResult) -> List[str]:
    """The CLI's summary lines."""
    args, engine, loop = dep.args, dep.engine, dep.loop
    s = engine.stats
    lines = [
        f"{dep.label}: {res.packets} packets / {s.flows_created} flows in "
        f"{res.seconds:.2f}s = {res.packets_per_s:.0f} pkt/s "
        f"({res.packets * args.pkt_len / res.seconds:.0f} tok/s) | "
        f"backend={engine.backend} device={engine.device} "
        f"resident={engine.resident_flows}/{args.capacity} evicted={s.flows_evicted} "
        f"(rate {s.eviction_rate:.2f}/tick) | "
        f"state={engine.resident_state_bytes() / 2**20:.1f}MiB "
        f"of {engine.state_budget_bytes / 2**20:.0f}MiB budget"
    ]
    if loop is not None:
        h = loop.history
        mode = "sync" if args.adapt_sync else "async"
        lines.append(
            f"adaptation ({mode}): {len(h)} trigger(s) at ticks "
            f"{loop.trigger_ticks}, {loop.installs} install(s), "
            f"{loop.installs_within_budget}/{max(loop.installs, 1)} within "
            f"the Eq. 18 t_cp budget ({loop.t_cp_s:g}s), "
            f"{sum(r.rolled_back for r in h)} rollback(s)"
        )
        for r in h:
            verdict = (
                "installed" if r.installed
                else ("ROLLED BACK" if r.rolled_back else f"held ({r.error})")
            )
            lines.append(
                f"  tick {r.tick}: fired {','.join(r.fired_on) or '-'} "
                f"-> {verdict} (install {r.install_s * 1e3:.2f}ms at tick "
                f"{r.install_tick}, epoch {r.epoch_s * 1e3:.1f}ms)"
            )
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    dep = build(parse_args(argv))
    res = serve(dep)
    for line in report(dep, res):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
