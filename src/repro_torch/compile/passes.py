"""The dataplane compiler's passes (port of ``repro.compile.passes``).

``compile_program`` lowers a trained Chimera classifier into a deployable
:class:`~repro_torch.compile.program.DataplaneProgram` through these passes,
in order:

1. :func:`signature_layout` — size the packed marker signature so every
   marker token owns one TCAM bit.
2. :func:`pack_rules` — pad the RuleSet to the signature width and compile
   the soft-rule weights into the fixed-point SRAM table (Eq. 19).
3. :func:`quantize_state` — the fixed-point format of the (S, Z)
   accumulators whose Eq. 39 horizon covers the configured flow horizon;
   the Eq. 7/11 and Eq. 13 per-flow SRAM budgets.
4. :func:`select_backend` — validate the score backend and record the
   ``decode_step`` kernel's shared memory per block against the H100's.
5. :func:`assemble_ledger` — shared SRAM / TCAM / action-bus accounting,
   the paper's Table 2 row.

Every pass returns its artifacts and ``[StageEntry, ...]``;
``compile_program`` collects the entries into the :class:`ResourceLedger`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.compile.ledger import StageEntry
from repro_torch.core import symbolic
from repro_torch.core.feature_maps import phi_norm_bound
from repro_torch.core.hardware_model import (
    DataplaneSpec,
    aggregated_state_bits,
    chimera_resource_report,
    window_bits,
)
from repro_torch.core.quantization import FixedPointSpec, overflow_safe_horizon
from repro_torch.core.state_quant import StateQuantConfig
from repro_torch.kernels.decode_step import ops as decode_ops

# window ring entries travel as 8-bit quantized elements on-switch (the
# Table 2 operating point); shared with the aggregate report below
WINDOW_ELEM_BITS = 8

# the score backends a program may name: the JAX package's float backends
# all run the float score path here (the device of the tensors chooses the
# kernel or its plain version), "int-emulation" the integer one
FLOAT_BACKENDS = ("xla", "reference", "pallas-tpu", "pallas-interpret")
INT_BACKEND = "int-emulation"


def check_backend(backend: Optional[str]) -> str:
    """The effective backend name: ``None`` is ``"xla"``; an unknown name raises."""
    if backend is None:
        return "xla"
    if backend not in FLOAT_BACKENDS + (INT_BACKEND,):
        raise ValueError(
            f"unknown backend {backend!r}; the port takes None, "
            f"{', '.join(map(repr, FLOAT_BACKENDS))} (the float score path) or "
            f"{INT_BACKEND!r}"
        )
    return backend


# --------------------------------------------------------------------------
# Pass 1: signature / TCAM layout
# --------------------------------------------------------------------------

def required_sig_words(vocab_size: int, marker_base: int) -> int:
    """Packed 32-bit words needed so every marker token (``tokens >=
    marker_base``) owns its own signature bit; with fewer, the packet
    signature's clip aliases all high markers onto the last bit."""
    n_markers = max(vocab_size - marker_base, 0)
    return max(-(-n_markers // 32), 1)


def signature_layout(ccfg, rules: Optional[symbolic.RuleSet], spec: DataplaneSpec):
    """Finalize ``ccfg.sig_words``: wide enough for every marker token and
    for any pre-built ruleset (never truncates caller rules)."""
    need = required_sig_words(ccfg.arch.vocab_size, ccfg.marker_base)
    if rules is not None:
        need = max(need, int(rules.values.shape[1]))
    ccfg = dataclasses.replace(ccfg, sig_words=need)
    entries = [
        StageEntry(
            stage="signature-layout",
            resource="phv-lane-bits",
            used=32 * need,
            budget=spec.phv_lane_bits,
            detail=f"{need} uint32 words cover markers "
                   f"[{ccfg.marker_base}, {ccfg.arch.vocab_size}) in the PHV",
        )
    ]
    return ccfg, entries


# --------------------------------------------------------------------------
# Pass 2: rule packing + HL-MRF weight-table compilation
# --------------------------------------------------------------------------

def pack_rules(
    ccfg, rules: symbolic.RuleSet, spec: DataplaneSpec, weight_bits: int = 16
) -> Tuple[symbolic.RuleSet, torch.Tensor, FixedPointSpec, List[StageEntry]]:
    """Pad rule signatures to the compiled width and lower the soft-rule
    weight column into the Eq. 19 fixed-point SRAM table."""
    W = ccfg.sig_words
    have = int(rules.values.shape[1])
    if have > W:
        raise ValueError(
            f"ruleset is {have} signature words wide but the compiled "
            f"layout has {W}; rules care about bits no packet can set"
        )
    if have < W:
        z = rules.values.new_zeros(rules.values.shape[:-1] + (W - have,))
        rules = symbolic.RuleSet(
            values=torch.cat([rules.values, z], dim=-1),
            masks=torch.cat([rules.masks, z], dim=-1),
            weights=rules.weights,
            hard=rules.hard,
        )
    M = rules.n_rules
    table, wspec = symbolic.compile_weights_to_table(
        rules.weights, FixedPointSpec(bits=weight_bits), spec.sram_total_bits
    )
    roundtrip = float(
        torch.max(torch.abs(symbolic.decompile_table(table, wspec) - rules.weights))
    )
    entries = [
        StageEntry(
            stage="rule-packing",
            resource="tcam-entries",
            used=M + ccfg.arch.chimera.n_global,
            budget=spec.tcam_total_entries,
            detail=f"{M} ternary rules + {ccfg.arch.chimera.n_global} static "
                   f"globals (Eq. 14/16)",
        ),
        StageEntry(
            stage="rule-packing",
            resource="rule-table-bits",
            used=M * weight_bits,
            budget=spec.sram_total_bits,
            detail=f"Eq. 19 W_q table, {weight_bits}-bit; round-trip err "
                   f"{roundtrip:.3g} <= eta_q {wspec.eta_q:.3g}",
        ),
    ]
    return rules, table, wspec, entries


# --------------------------------------------------------------------------
# Pass 3: streaming-state fixed-point quantization
# --------------------------------------------------------------------------

def quantize_state(
    ccfg, qcfg: StateQuantConfig, spec: DataplaneSpec, horizon: int
) -> Tuple[float, List[StageEntry]]:
    """Choose the S-accumulator fixed-point scale so ``horizon`` updates
    provably cannot overflow (Eq. 39), and check the Eq. 7/11 + Eq. 13
    per-flow SRAM budgets for the quantized streaming state."""
    arch = ccfg.arch
    ch = arch.chimera
    d_v = arch.head_dim
    m = ch.feature_map.feature_dim(arch.head_dim)
    agg_bits = aggregated_state_bits(m, d_v, qcfg.s_bits) + m * qcfg.z_bits
    win_bits = window_bits(ch.chunk_size, arch.d_model, WINDOW_ELEM_BITS)

    # the accumulator LSB from the no-overflow condition: per-step growth is
    # bounded by B_phi * R_v real units, so the smallest safe scale satisfies
    # horizon * (B_phi*R_v/scale + 0.5) <= max_int
    b_phi = phi_norm_bound(ch.feature_map, arch.head_dim)
    r_v = ch.feature_map.input_scale
    max_int = 2 ** (qcfg.s_bits - 1) - 1
    headroom = max_int / horizon - 0.5
    if headroom > 0:
        s_scale = b_phi * r_v / headroom
        safe = overflow_safe_horizon(b_phi, r_v, FixedPointSpec(bits=qcfg.s_bits, scale=s_scale))
        if safe < horizon:  # the two divisions round independently; nudge
            s_scale *= 1.0 + 1e-9
            safe = overflow_safe_horizon(
                b_phi, r_v, FixedPointSpec(bits=qcfg.s_bits, scale=s_scale)
            )
    else:  # horizon unreachable at this bit width regardless of scale
        s_scale = float("inf")
        safe = 2 * max_int
    entries = [
        StageEntry(
            stage="state-quantization",
            resource="per-flow-sram-bits",
            used=agg_bits,
            budget=spec.per_flow_sram_bits,
            detail=f"Eq. 7/11 aggregated (S, Z): m={m} d_v={d_v} "
                   f"b=({qcfg.s_bits},{qcfg.z_bits})",
        ),
        StageEntry(
            stage="state-quantization",
            resource="window-sram-bits",
            used=win_bits,
            budget=spec.per_flow_sram_bits,
            detail=f"Eq. 13 ring: L={ch.chunk_size} d={arch.d_model} b={WINDOW_ELEM_BITS}",
        ),
        StageEntry(
            stage="state-quantization",
            resource="overflow-horizon",
            used=horizon,
            budget=safe,
            detail=f"Eq. 39: scale={s_scale:.4g} B_phi={b_phi:.4g} "
                   f"R_v={r_v:.3g} at {qcfg.s_bits}-bit",
        ),
    ]
    return s_scale, entries


# --------------------------------------------------------------------------
# Pass 4: score backend + the decode kernel's working set
# --------------------------------------------------------------------------

def select_backend(
    ccfg, backend: Optional[str]
) -> Tuple[str, Optional[Dict[str, int]], List[StageEntry]]:
    """Validate the score backend and record the ``decode_step`` kernel's
    shared memory per block (``csrc/decode_step.cu``, the arithmetic of
    its wrapper's ``contract``) against what an H100 block may use — the
    on-card counterpart of the JAX package's VMEM row.  There are no tiles
    to choose: the kernel's layout is fixed by the widths."""
    effective = check_backend(backend)
    arch = ccfg.arch
    dims = {
        "Gq": max(arch.n_heads // arch.n_kv_heads, 1),
        "d": arch.head_dim,
        "dv": arch.head_dim,
        "m": arch.chimera.feature_map.feature_dim(arch.head_dim),
        "L": arch.chimera.chunk_size,
    }
    entries = [
        StageEntry(
            stage="kernel-backend",
            resource="smem-bytes",
            used=decode_ops._smem_bytes(**dims),
            budget=decode_ops.SMEM_LIMIT,
            detail=f"backend={effective} decode_step.cu shared memory per block at {dims}",
        )
    ]
    return effective, None, entries


# --------------------------------------------------------------------------
# Pass 5: aggregate shared-resource accounting
# --------------------------------------------------------------------------

def _map_table(ccfg) -> Tuple[int, int]:
    """(entries, bits/entry) of the shared Map codebook / projection SRAM."""
    arch = ccfg.arch
    fm = arch.chimera.feature_map
    if fm.kind == "codebook":
        return fm.codebook_size, arch.head_dim * (fm.codebook_bits or 16)
    return fm.feature_dim(arch.head_dim), arch.head_dim * 16


def assemble_ledger(
    ccfg,
    rules: symbolic.RuleSet,
    qcfg: StateQuantConfig,
    weight_bits: int,
    flows: int,
    spec: DataplaneSpec,
):
    """Shared SRAM / TCAM / action-bus aggregate: the paper's Table 2 row
    (``chimera_resource_report``) plus its ledger entries."""
    arch = ccfg.arch
    ch = arch.chimera
    m = ch.feature_map.feature_dim(arch.head_dim)
    map_entries, map_bits = _map_table(ccfg)
    report = chimera_resource_report(
        m=m,
        d_v=arch.head_dim,
        state_bits=qcfg.s_bits,
        z_bits=qcfg.z_bits,
        window_len=ch.chunk_size,
        d_model=arch.d_model,
        window_elem_bits=WINDOW_ELEM_BITS,
        n_global=ch.n_global,
        n_hard_rules=int(torch.sum(rules.hard)),
        map_table_entries=map_entries,
        map_entry_bits=map_bits,
        flows=flows,
        spec=spec,
    )
    sz = aggregated_state_bits(m, arch.head_dim, qcfg.s_bits) + m * qcfg.z_bits
    win = window_bits(ch.chunk_size, arch.d_model, WINDOW_ELEM_BITS)
    sram_used = (
        flows * (sz + win) / 64  # 64-way shared-bank amortization (Table 2)
        + map_entries * map_bits
        + rules.n_rules * weight_bits
    )
    entries = [
        StageEntry(
            stage="resource-ledger",
            resource="shared-sram-bits",
            used=sram_used,
            budget=spec.sram_total_bits,
            detail=f"{flows} flows (64-way banks) + Map table + W_q table",
        ),
        StageEntry(
            stage="resource-ledger",
            # raw bits, not report.bus_fraction: the report clips fractions
            # to 1.0 for table rendering, which would mask an overflow here
            resource="action-bus-bits",
            used=m * 8 // spec.stages,
            budget=spec.action_bus_bits,
            detail=f"one quantized phi row staged over {spec.stages} stages",
        ),
    ]
    return report, entries
