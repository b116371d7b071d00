"""Dataplane budget model (port of ``repro.core.hardware_model`` lines
16-27 and 51-169): the switch budget, the paper's budget equations (Eqs.
7, 11, 13, 18, 19), the flow-table budget and the Table 2 resource report.
The TPU roofline spec is left out: the port's device is an H100."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DataplaneSpec:
    """Commodity programmable-switch (Tofino-class) budget model (§3.3.1)."""

    per_flow_sram_bits: int = 8 * 1024  # ~1 KB per-flow budget (paper §3.3.1)
    phv_lane_bits: int = 4096
    sram_total_bits: int = 120 * 2 ** 20 * 8  # 120 MB SRAM
    tcam_total_entries: int = 12 * 2048  # 12 stages x 2k ternary entries
    action_bus_bits: int = 4096
    stages: int = 12
    pipelines: int = 4


DEFAULT_DATAPLANE = DataplaneSpec()


def aggregated_state_bits(m: int, d_v: int, b: int) -> int:
    """Eq. 7: bits_agg = m * d_v * b for the S accumulator."""
    return m * d_v * b


def fits_per_flow(m: int, d_v: int, b: int, spec: DataplaneSpec = DEFAULT_DATAPLANE) -> bool:
    """Eq. 11: m * d_v * b <= per-flow SRAM budget."""
    return aggregated_state_bits(m, d_v, b) <= spec.per_flow_sram_bits


def window_bits(L: int, d: int, b: int) -> int:
    """Eq. 13 storage: local circular buffer of L tokens of width d at b bits."""
    return L * d * b


def fits_window(L: int, d: int, b: int, spec: DataplaneSpec = DEFAULT_DATAPLANE) -> bool:
    return window_bits(L, d, b) <= spec.per_flow_sram_bits


def table_fits(n_entries: int, bits_per_entry: int, budget_bits: int) -> bool:
    """Eq. 19: N_entries * b <= M_tbl."""
    return n_entries * bits_per_entry <= budget_bits


def flow_table_bytes(n_flows: int, bytes_per_flow: int) -> int:
    """Total resident bytes of a flow table holding ``n_flows`` entries."""
    return n_flows * bytes_per_flow


def check_flow_table_budget(n_flows: int, bytes_per_flow: int, budget_bytes: int) -> int:
    """Eq. 11 lifted to the whole flow table: N_flows × per-flow state must
    fit the configured budget.  Raises ``ValueError`` on violation, returns
    total bytes otherwise."""
    total = flow_table_bytes(n_flows, bytes_per_flow)
    if total > budget_bytes:
        raise ValueError(
            f"flow table needs {total} B ({n_flows} flows x {bytes_per_flow} "
            f"B/flow) > budget {budget_bytes} B (Eq. 11)"
        )
    return total


def install_time_ok(delta_t_install_s: float, t_cp_s: float) -> bool:
    """Eq. 18: atomic install must complete within the control-plane epoch."""
    return delta_t_install_s < t_cp_s


@dataclasses.dataclass(frozen=True)
class ResourceReport:
    """Per-model dataplane cost in the units of the paper's Table 2."""

    stateful_bits_per_flow: int
    sram_fraction: float
    tcam_fraction: float
    bus_fraction: float

    def as_dict(self) -> dict:
        """Machine-readable form (the compile ledger's; JSON-serializable)."""
        return {
            "stateful_bits_per_flow": int(self.stateful_bits_per_flow),
            "sram_fraction": float(self.sram_fraction),
            "tcam_fraction": float(self.tcam_fraction),
            "bus_fraction": float(self.bus_fraction),
        }

    def as_row(self) -> str:
        d = self.as_dict()
        return (
            f"{d['stateful_bits_per_flow']},"
            f"{d['sram_fraction']:.4f},{d['tcam_fraction']:.4f},{d['bus_fraction']:.4f}"
        )


def chimera_resource_report(
    *,
    m: int,
    d_v: int,
    state_bits: int,
    z_bits: int,
    window_len: int,
    d_model: int,
    window_elem_bits: int,
    n_global: int,
    n_hard_rules: int,
    map_table_entries: int,
    map_entry_bits: int,
    flows: int = 8192,
    spec: DataplaneSpec = DEFAULT_DATAPLANE,
) -> ResourceReport:
    """The paper-style resource row of a Chimera configuration.

    The dataplane keeps 30 stateful bits per flow (EMA/occupancy counters
    and cascade state, the paper's operating point); the quantized (S, Z)
    accumulators and window rings live in shared SRAM, 64 flows to a bank
    through the fuzzy flow-hash mapping, beside the Map tables; TCAM holds
    the static global index G and the hard rules; the action bus carries
    one 8-bit φ row staged over the pipeline's stages.
    """
    per_flow_counters = 30
    sz_bits = aggregated_state_bits(m, d_v, state_bits) + m * z_bits
    win_bits = window_bits(window_len, d_model, window_elem_bits)
    sram_bits = flows * (sz_bits + win_bits) / 64 + map_table_entries * map_entry_bits
    tcam_entries = n_global + n_hard_rules
    bus_bits = m * 8 // spec.stages
    return ResourceReport(
        stateful_bits_per_flow=per_flow_counters,
        sram_fraction=min(1.0, sram_bits / spec.sram_total_bits),
        tcam_fraction=min(1.0, tcam_entries / spec.tcam_total_entries),
        bus_fraction=min(1.0, bus_bits / spec.action_bus_bits),
    )
