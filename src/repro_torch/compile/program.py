"""DataplaneProgram: the deployable artifact (port of
``repro.compile.program``).

``compile_program`` runs the passes of :mod:`repro_torch.compile.passes`
over a trained classifier and returns a :class:`DataplaneProgram`: the
parameters, the packed TCAM rules, the quantized HL-MRF SRAM weight table,
the streaming-state fixed-point format, the score backend, and the
per-stage :class:`ResourceLedger` that proves it fits the
:class:`DataplaneSpec` budget (or records which stages were waived).

``program.deploy(DeploySpec(...))`` puts it on a serving runtime
(:mod:`repro_torch.serve.deploy`); slow-timescale updates are
:class:`ProgramDelta` objects from :func:`compile_delta`, which
``FlowEngine.swap_tables`` installs.  Programs save and load through the
numpy :class:`~repro_torch.checkpoint.Checkpointer` in the JAX package's
layout, so a program saved by either package loads in the other.

Pass 6, static verification (:func:`repro_torch.analysis.verify
.verify_program`: TCAM lint, the hot path's graph lint, and under
int-emulation the float lint and the interval overflow proof), runs by
default and lands its findings as ``static-verification`` ledger rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import bridge, resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.compile import passes
from repro_torch.compile.ledger import ResourceLedger
from repro_torch.configs.base import ArchConfig
from repro_torch.core import symbolic
from repro_torch.core.chimera_attention import ChimeraAttentionConfig
from repro_torch.core.feature_maps import FeatureMapConfig
from repro_torch.core.hardware_model import DEFAULT_DATAPLANE, DataplaneSpec
from repro_torch.core.quantization import FixedPointSpec
from repro_torch.core.state_quant import StateQuantConfig
from repro_torch.train.classifier import ClassifierConfig

RulesLike = Union[symbolic.RuleSet, Callable[[ClassifierConfig], symbolic.RuleSet], None]

@dataclasses.dataclass
class DataplaneProgram:
    """Everything a deployment needs, with its audit trail attached."""

    ccfg: ClassifierConfig  # sig_words finalized by the signature pass
    params: Any  # classifier params {"backbone", "cls", "anom", "fusion"}
    rules: symbolic.RuleSet  # packed to the compiled signature width
    weight_table: torch.Tensor  # Eq. 19 fixed-point SRAM image of rules.weights
    weight_spec: FixedPointSpec
    state_quant: StateQuantConfig  # (S, Z) at-rest bit widths
    s_scale: float  # S-accumulator LSB (overflow-safe at `horizon`)
    horizon: int  # Eq. 39 flow-length horizon the format covers
    backend: Optional[str]  # score backend ("xla" | ... | "int-emulation")
    tiles: Optional[Dict[str, int]]  # None in the port; kept for the manifest
    ledger: ResourceLedger
    spec: DataplaneSpec
    # a loaded program's manifest ``ccfg`` as it was read (the JAX package's
    # fields included), written back unchanged while it still reads as ccfg
    ccfg_source: Optional[Dict] = None

    @property
    def arch(self) -> ArchConfig:
        return self.ccfg.arch

    def deploy(self, spec=None):
        """Deploy onto a serving runtime: ``deploy(DeploySpec(...))``, or
        ``deploy()`` for a ``FlowEngine`` with the default knobs on the card."""
        from repro_torch.serve.deploy import DeploySpec, deploy_program

        return deploy_program(self, spec if spec is not None else DeploySpec())

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def _array_tree(self) -> Dict[str, Any]:
        """The checkpoint's tree: signature words as the JAX package keeps
        them (uint32), every other leaf with its own dtype."""
        r = self.rules
        return {
            "params": self.params,
            "rules": symbolic.RuleSet(
                values=r.values.cpu().numpy().view(np.uint32),
                masks=r.masks.cpu().numpy().view(np.uint32),
                weights=r.weights, hard=r.hard,
            ),
            "weight_table": self.weight_table,
        }

    def _ccfg_dict(self) -> Dict:
        src = self.ccfg_source
        if src is not None and _ccfg_from_dict(src) == self.ccfg:
            return src
        return _ccfg_to_dict(self.ccfg)

    def save(self, directory: str, step: int = 0) -> None:
        ckpt = Checkpointer(directory, keep=3)
        extra = {
            "program": {
                "ccfg": self._ccfg_dict(),
                "n_rules": int(self.rules.n_rules),
                "weight_spec": {"bits": self.weight_spec.bits, "scale": self.weight_spec.scale},
                "state_quant": dataclasses.asdict(self.state_quant),
                "s_scale": self.s_scale,
                "horizon": self.horizon,
                "backend": self.backend,
                "tiles": self.tiles,
                "ledger": self.ledger.as_dict(),
                "spec": dataclasses.asdict(self.spec),
            }
        }
        ckpt.save(step, self._array_tree(), extra=extra, blocking=True)

    @classmethod
    def load(cls, directory: str, step: Optional[int] = None, device=None) -> "DataplaneProgram":
        """Load a program saved by either package onto ``device`` (``None``
        means ``"cuda"``; without a GPU it raises).  Shapes and dtypes come
        from the manifest: no initializer runs."""
        device = resolve_device(device, "DataplaneProgram.load")
        tree, extra, step = Checkpointer(directory).restore(step=step)
        meta = extra["program"]
        ccfg = _ccfg_from_dict(meta["ccfg"])
        wspec = FixedPointSpec(**meta["weight_spec"])
        if set(tree) != {"params", "rules", "weight_table"} or set(tree["rules"]) != {0, 1, 2, 3}:
            raise ValueError(f"{directory} step {step}: not a DataplaneProgram checkpoint "
                             f"(top-level leaves {sorted(map(str, tree))})")
        r = tree["rules"]
        rules = bridge.rules_from_numpy(r[0], r[1], r[2], r[3], device=device)
        if rules.n_rules != meta["n_rules"] or rules.values.shape[1] != ccfg.sig_words:
            raise ValueError(f"{directory}: rules {tuple(rules.values.shape)} against the "
                             f"manifest's {meta['n_rules']} rules x {ccfg.sig_words} words")
        table = tree["weight_table"]
        if table.dtype != np.dtype(f"int{wspec.bits}"):
            raise ValueError(f"{directory}: weight table of dtype {table.dtype} for a "
                             f"{wspec.bits}-bit spec")
        return cls(
            ccfg=ccfg,
            params=bridge.params_from_jax(tree["params"], device=device),
            rules=rules,
            weight_table=torch.from_numpy(np.array(table)).to(device),
            weight_spec=wspec,
            state_quant=StateQuantConfig(**meta["state_quant"]),
            s_scale=meta["s_scale"],
            horizon=meta["horizon"],
            backend=meta["backend"],
            tiles=meta["tiles"],
            ledger=ResourceLedger.from_dict(meta["ledger"]),
            spec=DataplaneSpec(**meta["spec"]),
            ccfg_source=meta["ccfg"],
        )


@dataclasses.dataclass(frozen=True)
class ProgramDelta:
    """A slow-timescale table update, compiled through the same audited
    passes as the program it amends; ``FlowEngine.swap_tables(delta=...)``
    installs it between ticks."""

    step: int
    weight_table: torch.Tensor  # quantized Eq. 19 SRAM image
    weight_spec: FixedPointSpec
    ruleset: Optional[symbolic.RuleSet]  # None = weights-only delta
    ledger: ResourceLedger


# --------------------------------------------------------------------------
# the compiler
# --------------------------------------------------------------------------

def _null_rules(ccfg: ClassifierConfig, device) -> symbolic.RuleSet:
    """A single all-don't-care soft rule with zero weight: matches every
    signature but contributes nothing (the rule-free case)."""
    z = torch.zeros((1, ccfg.sig_words), dtype=torch.int32, device=device)
    return symbolic.RuleSet(values=z, masks=z.clone(),
                            weights=torch.zeros((1,), device=device),
                            hard=torch.zeros((1,), dtype=torch.bool, device=device))


def compile_program(
    ccfg: ClassifierConfig,
    params: Any,
    rules: RulesLike = None,
    *,
    spec: DataplaneSpec = DEFAULT_DATAPLANE,
    backend: Optional[str] = None,
    qcfg: StateQuantConfig = StateQuantConfig(),
    weight_bits: int = 16,
    horizon: int = 1024,
    flows: int = 8192,
    waivers: Tuple[str, ...] = (),
    int_cfg=None,
    verify: bool = True,
) -> DataplaneProgram:
    """Lower (config, params, rules) into a deployable DataplaneProgram.

    ``rules`` may be a RuleSet, ``None`` (a no-op ruleset is compiled), or a
    callable ``ccfg -> RuleSet`` invoked after the signature-layout pass, so
    that rules built from marker tokens see the final ``sig_words``.  The
    passes run on the device of ``params``.

    Raises :class:`BudgetError` naming the offending stage when any pass
    exceeds ``spec``, unless that stage is listed in ``waivers`` (the
    violation is then recorded in the ledger instead).  ``verify`` (pass 6)
    records the static-verification rows; an error among them raises
    :class:`~repro_torch.analysis.intervals.AnalysisError` unless the
    ``static-verification`` stage is waived.
    """
    device = params["cls"]["w"].device
    ledger = ResourceLedger()

    # pass 1 — signature/TCAM layout
    pre_rules = rules if isinstance(rules, symbolic.RuleSet) else None
    ccfg, entries = passes.signature_layout(ccfg, pre_rules, spec)
    ledger.extend(entries)
    if rules is None:
        rules = _null_rules(ccfg, device)
    elif callable(rules) and not isinstance(rules, symbolic.RuleSet):
        rules = rules(ccfg)

    # pass 2 — rule packing + HL-MRF weight table (Eq. 16/19)
    rules, weight_table, weight_spec, entries = passes.pack_rules(ccfg, rules, spec, weight_bits)
    ledger.extend(entries)

    # pass 3 — streaming-state fixed point (Eq. 7/11/13/39)
    s_scale, entries = passes.quantize_state(ccfg, qcfg, spec, horizon)
    ledger.extend(entries)

    # pass 4 — score backend + the decode kernel's working set
    effective, tiles, entries = passes.select_backend(ccfg, backend)
    ledger.extend(entries)

    # pass 4b — integer score lowering (int-emulation only): a program that
    # cannot run in int32 fails here, not at deploy.  The plan and tables
    # are re-derived by the engine, so nothing of them is serialized.
    if effective == passes.INT_BACKEND:
        from repro_torch.compile.int_lowering import IntLoweringConfig, lower_scores

        _, _, entries = lower_scores(
            ccfg, params, rules,
            cfg=int_cfg if int_cfg is not None else IntLoweringConfig(),
            horizon=horizon,
        )
        ledger.extend(entries)

    # pass 5 — aggregate shared-resource report (Table 2)
    report, entries = passes.assemble_ledger(ccfg, rules, qcfg, weight_bits, flows, spec)
    ledger.extend(entries)
    ledger.report = report

    program = DataplaneProgram(
        ccfg=ccfg,
        params=params,
        rules=rules,
        weight_table=weight_table,
        weight_spec=weight_spec,
        state_quant=qcfg,
        s_scale=s_scale,
        horizon=horizon,
        backend=effective,
        tiles=tiles,
        ledger=ledger,
        spec=spec,
    )

    # pass 6 — static verification.  Findings are ledger rows either way;
    # an error fails the compile louder than a budget line (AnalysisError)
    # unless the stage is waived
    if verify:
        from repro_torch.analysis.intervals import AnalysisError
        from repro_torch.analysis.verify import STAGE as VERIFY_STAGE
        from repro_torch.analysis.verify import verify_program

        ledger.extend(verify_program(program, int_cfg=int_cfg, strict=False))
        ledger.apply_waivers(tuple(waivers))
        bad = [e for e in ledger.violations() if e.stage == VERIFY_STAGE]
        if bad:
            lines = "; ".join(f"{e.resource}: {e.detail}" for e in bad)
            raise AnalysisError(
                f"static verification failed — {lines}. Pass "
                f"waivers=('static-verification',) to record-and-accept, "
                f"or verify=False to skip the pass.",
                report=ledger,
            )
    else:
        ledger.apply_waivers(tuple(waivers))
    ledger.raise_if_over()
    return program


def compile_delta(
    program: DataplaneProgram,
    *,
    weights=None,
    ruleset: Optional[symbolic.RuleSet] = None,
    step: int = 0,
    weight_bits: Optional[int] = None,
    waivers: Optional[Tuple[str, ...]] = None,
) -> ProgramDelta:
    """Compile a slow-timescale table update against an installed program.

    Re-runs the rule-packing pass (budget checks included) on the new
    tables, so a delta carries the same audit as a full compile.  Raises
    :class:`BudgetError` if the update no longer fits.  ``waivers`` defaults
    to the stages already waived at program compile time.
    """
    base = ruleset if ruleset is not None else program.rules
    if weights is not None:
        base = symbolic.RuleSet(
            values=base.values,
            masks=base.masks,
            weights=torch.as_tensor(weights, dtype=torch.float32, device=base.weights.device),
            hard=base.hard,
        )
    bits = weight_bits if weight_bits is not None else program.weight_spec.bits
    ledger = ResourceLedger()
    packed, table, wspec, entries = passes.pack_rules(program.ccfg, base, program.spec, bits)
    ledger.extend(entries)
    if waivers is None:
        waivers = tuple({e.stage for e in program.ledger.waived()})
    ledger.apply_waivers(tuple(w for w in waivers if w in ledger.stages()))
    ledger.raise_if_over()
    return ProgramDelta(
        step=step,
        weight_table=table,
        weight_spec=wspec,
        ruleset=packed if ruleset is not None else None,
        ledger=ledger,
    )


# --------------------------------------------------------------------------
# config (de)serialization — plain dicts, JSON-safe
# --------------------------------------------------------------------------

# Fields of the JAX package's configs that the port's lack, or that a
# program cannot use.  An execution choice is honoured whatever its value
# (the device of the tensors picks a kernel or its plain version; the port
# has no scan or remat switch):
_EXECUTION = {
    "arch": ("swa_backend", "scan_layers", "remat"),
    "chimera": ("use_pallas", "backend"),
    "feature_map": (),
}
# a feature that a program cannot use is honoured only at the value that
# leaves it off: an encoder (the flow step's decode_hidden_step is
# decoder-only in both packages), and Chimera ablations the port does not
# have:
_OFF = {
    "arch": {"encoder_layers": 0},
    "chimera": {"use_local": True, "use_stream": True, "expand_kv": False},
    "feature_map": {},
}
# and the knobs of such a feature are inert while it is off (the encoder's
# sequence split):
_INERT = {
    "arch": ("encoder_seq_fraction",),
    "chimera": (),
    "feature_map": (),
}


def _take(level: str, d: Dict, cls) -> Dict:
    """``d``'s fields of dataclass ``cls``; every other field must be one of
    the JAX package's that the port honours (see above), else this raises."""
    names = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for k, v in d.items():
        if k in _OFF[level] and v != _OFF[level][k]:
            why = (": the flow step's decode_hidden_step is decoder-only in both packages"
                   if k == "encoder_layers" else "")
            raise ValueError(f"program config: {level}.{k} = {v!r} is not supported by "
                             f"the port (it takes {_OFF[level][k]!r}){why}")
        if k in names:
            out[k] = v
        elif k not in _OFF[level] and k not in _EXECUTION[level] and k not in _INERT[level]:
            raise ValueError(f"program config: unknown field {level}.{k} = {v!r}")
    return out


def _ccfg_to_dict(ccfg: ClassifierConfig) -> Dict:
    return dataclasses.asdict(ccfg)


def _ccfg_from_dict(d: Dict) -> ClassifierConfig:
    """The port's ClassifierConfig from a manifest's ``ccfg``, written by
    either package."""
    d = dict(d)
    arch = dict(d.pop("arch"))
    chim = dict(arch.pop("chimera"))
    fm = _take("feature_map", chim.pop("feature_map"), FeatureMapConfig)
    chimera = ChimeraAttentionConfig(feature_map=FeatureMapConfig(**fm),
                                     **_take("chimera", chim, ChimeraAttentionConfig))
    arch = _take("arch", arch, ArchConfig)
    arch["block_pattern"] = tuple(arch["block_pattern"])
    if set(arch["block_pattern"]) - {"attn", "mamba", "mlstm", "slstm"}:
        raise ValueError(f"program config: block pattern {arch['block_pattern']} has blocks "
                         f"the port does not have")
    return ClassifierConfig(arch=ArchConfig(chimera=chimera, **arch), **d)
