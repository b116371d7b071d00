"""The static-verification gate (port of ``repro.analysis.gate``).

Compiles the smoke classifier for each of the port's score paths (the float
path, which every float backend name selects, and ``int-emulation``), runs
the static battery (:func:`repro_torch.analysis.verify.verify_program`) over
each program, deploys it fused and audits the hot path with the
graph-capture sentry, runs the elastic reshard cycle (1 -> 2 -> 1 logical
shards) under the sentry, and fires two canaries that prove the battery
still has teeth (a constructed overflow must be caught; a hard rule buried
under a broader soft rule must be flagged).  Writes a JSON verdict and
exits nonzero on any error::

    PYTHONPATH=src python -m repro_torch.analysis.gate [--out verdict.json] [--device cpu]

It runs on the card unless ``--device cpu`` is given.  The port's shards
are logical shards on one device, so the elastic audit needs no second
device, unlike the JAX package's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List

BACKENDS = ("xla", "int-emulation")  # the port's two score paths


def _verify_backend(backend, ccfg, params, rules_fn, scenario, device) -> Dict:
    import numpy as np

    from repro_torch.analysis.retrace_sentry import RetraceError, RetraceSentry
    from repro_torch.analysis.verify import verify_program
    from repro_torch.compile import compile_program
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig

    program = compile_program(ccfg, params, rules=rules_fn, backend=backend, verify=False)
    entries = verify_program(program, strict=False)
    errors = [e for e in entries if not e.ok]

    # capture audit of the deployed fused hot path: after warm-up (every
    # width captured, one tick), a tick must capture nothing
    engine = program.deploy(DeploySpec(
        flow=FlowEngineConfig(capacity=256, lanes=64, fused=True), device=device))
    sentry = RetraceSentry.for_engine(engine)
    engine.warm_fused(scenario.pkt_len)
    batch = scenario.next_batch()
    engine.ingest(batch["flow_ids"], batch["tokens"])
    warm = sum(sentry.counts().values())
    sentry.snapshot()
    batch = scenario.next_batch()
    retrace_ok, detail = True, f"no capture after warm-up ({warm} key(s) at warm-up)"
    try:
        with sentry.expect_no_retrace():
            engine.ingest(np.asarray(batch["flow_ids"]), np.asarray(batch["tokens"]))
    except RetraceError as e:
        retrace_ok, detail = False, str(e)
    return {
        "backend": program.backend,
        "entries": [e.as_dict() for e in entries],
        "retrace": {"ok": retrace_ok, "detail": detail},
        "ok": not errors and retrace_ok,
    }


def elastic_reshard_audit(program, scenario, device, fcfg=None) -> Dict:
    """A live reshard must not bring a new step key into steady-state
    ingest: ``program`` deployed elastic, and after both topologies are
    warm, a 1 -> 2 -> 1 cycle with ingest between the installs runs under
    ``expect_no_retrace`` over every cached topology's entry points
    (``shards<N>.step``).  ``fcfg`` defaults to capacity 256, lanes 64 per
    shard."""
    import numpy as np

    from repro_torch.analysis.retrace_sentry import RetraceError, RetraceSentry
    from repro_torch.serve.deploy import DeploySpec, ElasticConfig
    from repro_torch.serve.flow_engine import FlowEngineConfig

    name = "elastic-reshard-no-retrace"
    fcfg = fcfg if fcfg is not None else FlowEngineConfig(capacity=256, lanes=64)
    svc = program.deploy(DeploySpec(
        engine="elastic", num_shards=1, flow=fcfg,
        elastic=ElasticConfig(keep_topologies=True), device=device))

    def tick():
        b = scenario.next_batch()
        svc.ingest(np.asarray(b["flow_ids"]), np.asarray(b["tokens"]))

    tick()  # warm shards1.step
    svc.reshard(2)
    tick()  # warm shards2.step
    svc.reshard(1)  # back onto the cached topology
    sentry = RetraceSentry.for_engine(svc)
    try:
        with sentry.expect_no_retrace():
            tick()
            svc.reshard(2)
            tick()  # steady-state ingest straight after the install
            svc.reshard(1)
            tick()
    except RetraceError as e:
        return {"name": name, "ok": False, "detail": str(e)}
    return {
        "name": name, "ok": True,
        "detail": (f"reshard 1->2->1 cycle captured nothing across "
                   f"{len(svc.capture_entry_points())} namespaced entry point(s); "
                   f"{len(svc.reshard_history)} installs recorded"),
    }


def canaries() -> List[Dict]:
    """The battery must still catch known-bad constructions."""
    import torch

    from repro_torch.analysis.graph_lint import trace_graph
    from repro_torch.analysis.intervals import Interval, analyze_intervals
    from repro_torch.analysis.tcam_lint import lint_ruleset
    from repro_torch.core.symbolic import RuleSet

    out: List[Dict] = []
    # 1. a 2^30-scale int32 multiply must be proven overflowing
    gm = trace_graph(lambda x: x * x, torch.zeros((2,), dtype=torch.int32))
    rep = analyze_intervals(gm, [Interval(-(1 << 30), 1 << 30)])
    out.append({"name": "interval-catches-overflow", "ok": not rep.proves_no_overflow(),
                "detail": f"{len(rep.overflows())} overflow node(s) flagged"})

    # 2. a hard rule buried under a broader soft rule must be flagged
    rs = RuleSet(values=torch.tensor([[0b01], [0b11]], dtype=torch.int32),
                 masks=torch.tensor([[0b01], [0b11]], dtype=torch.int32),
                 weights=torch.zeros((2,)), hard=torch.tensor([False, True]))
    shadowed = [f for f in lint_ruleset(rs, achievable_bits=8)
                if f.kind == "shadowed" and f.severity == "error"]
    out.append({"name": "tcam-catches-shadowed-veto", "ok": bool(shadowed),
                "detail": shadowed[0].message if shadowed else "NOT FLAGGED"})
    return out


def main(argv=None, rules_fn=None) -> int:
    """The CLI's body, on the smoke classifier (weights from seed 0).
    ``rules_fn`` replaces the repo's default rules (a test plants a bad
    table through it)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default="analysis-verdict.json", help="JSON verdict path")
    parser.add_argument("--device", default=None,
                        help="where the engines run (default: the card)")
    args = parser.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.compile import compile_program
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.train import classifier as C

    device = resolve_device(args.device, "repro_torch.analysis.gate")
    arch = dataclasses.replace(smoke_config("chimera-dataplane"), vocab_size=512)
    ccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256)
    params = C.init_classifier(ccfg, torch.Generator().manual_seed(0), device=device)
    scenario = FlowScenario(kind="mix", pkt_len=16, packets_per_batch=128, seed=0)
    if rules_fn is None:
        def rules_fn(c):
            return C.default_rules(c, scenario.anomaly_signature, device=device)

    verdict = {"device": str(device), "backends": [], "canaries": canaries()}
    for backend in BACKENDS:
        result = _verify_backend(backend, ccfg, params, rules_fn, scenario, device)
        verdict["backends"].append(result)
        print(f"[{'ok' if result['ok'] else 'FAIL'}] backend={result['backend']}: "
              f"{len(result['entries'])} static-verification entries, "
              f"capture {'ok' if result['retrace']['ok'] else 'FAIL'}")
        for row in result["entries"]:
            print(f"    {row['resource']:26} used={row['used']:g} "
                  f"budget={row['budget']:g} {'ok' if row['ok'] else 'OVER'}")
    program = compile_program(ccfg, params, rules=rules_fn, backend="xla", verify=False)
    verdict["elastic"] = elastic_reshard_audit(program, scenario, device)
    for c in verdict["canaries"]:
        print(f"[{'ok' if c['ok'] else 'FAIL'}] canary {c['name']}: {c['detail']}")
    el = verdict["elastic"]
    print(f"[{'ok' if el['ok'] else 'FAIL'}] {el['name']}: {el['detail']}")

    verdict["ok"] = (all(b["ok"] for b in verdict["backends"])
                     and all(c["ok"] for c in verdict["canaries"]) and el["ok"])
    with open(args.out, "w") as f:
        json.dump(verdict, f, indent=2)
    print(f"verdict {'ok' if verdict['ok'] else 'FAIL'} -> {args.out}")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
