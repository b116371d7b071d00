"""The compile → audit → deploy → serve gate (port of ``repro.compile.gate``).

Compiles the smoke classifier through every ported pass, asserts that the
resource ledger fits ``DEFAULT_DATAPLANE`` with no waivers, deploys it with
``program.deploy(DeploySpec(...))`` and ingests one FlowScenario batch,
failing (nonzero exit) if any link breaks::

    PYTHONPATH=src python -m repro_torch.compile.gate

It runs on the card; on a host without a GPU it raises.  The compile runs
the static-verification pass, as the JAX gate's does.
"""

from __future__ import annotations

import dataclasses
import sys


def main(device=None) -> int:
    import torch

    from repro_torch import resolve_device
    from repro_torch.compile import compile_program
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig
    from repro_torch.train import classifier as C

    device = resolve_device(device, "repro_torch.compile.gate")
    # vocab 512: packet bytes 0..255 + field markers 256..511 (the
    # FlowScenario alphabet); the signature-layout pass sizes the TCAM
    # signature from this
    arch = dataclasses.replace(smoke_config("chimera-dataplane"), vocab_size=512)
    ccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256)
    params = C.init_classifier(ccfg, torch.Generator().manual_seed(0), device=device)
    scenario = FlowScenario(kind="mix", pkt_len=16, packets_per_batch=128, seed=0)

    program = compile_program(
        ccfg, params,
        rules=lambda c: C.default_rules(c, scenario.anomaly_signature, device=device),
    )
    print(program.ledger.as_table())
    if not program.ledger.fits():
        print("GATE FAIL: ledger reports a budget violation", file=sys.stderr)
        return 1
    if program.ledger.waived():
        print("GATE FAIL: smoke config must fit without waivers", file=sys.stderr)
        return 1

    engine = program.deploy(
        DeploySpec(flow=FlowEngineConfig(capacity=256, lanes=64), device=device)
    )
    batch = scenario.next_batch()
    out = engine.ingest(batch["flow_ids"], batch["tokens"])
    if not (out["trust"][out["vetoed"]] == 1.0).all():
        print("GATE FAIL: Eq. 15 veto invariant broken", file=sys.stderr)
        return 1
    rep = program.ledger.report.as_dict()
    print(
        f"gate ok: {len(batch['flow_ids'])} packets through "
        f"{engine.resident_flows} flows on {device} | backend={engine.backend} | "
        f"sig_words={program.ccfg.sig_words} | "
        f"SRAM={rep['sram_fraction']:.4f} TCAM={rep['tcam_fraction']:.4f} "
        f"Bus={rep['bus_fraction']:.4f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
