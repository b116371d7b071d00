"""Dataplane budget model: the flow-table part of
``repro.core.hardware_model`` (lines 16-27 and 75-93)."""

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
