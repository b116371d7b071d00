"""TCAM-style static-global key selection (paper §3.4, Eq. 14).

Port of the two functions of ``repro.core.key_selection`` that the decode
path calls: sign-LSH signatures and the Hamming-budget ternary match.
"""

from __future__ import annotations

import torch


def init_signature_projection(g: torch.Generator, d: int, sig_bits: int, device="cpu"):
    return torch.randn((d, sig_bits), generator=g, device=g.device).to(device)


def make_signature(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Sign-LSH signature: (..., d) -> (..., sig_bits) in {0,1} (int32)."""
    dt = torch.promote_types(x.dtype, proj.dtype)  # jnp's promotion of bf16 @ f32
    return (x.to(dt) @ proj.to(dt) > 0).to(torch.int32)


def ternary_match_mask(
    sig_q: torch.Tensor,  # (..., Tq, W)
    sig_k: torch.Tensor,  # (..., G, W)
    max_hamming: int,
) -> torch.Tensor:
    """Hit iff Hamming(sig_q, sig_k) ≤ budget.  Returns float mask (..., Tq, G)."""
    diff = torch.abs(sig_q[..., :, None, :] - sig_k[..., None, :, :])  # XOR
    ham = torch.sum(diff, dim=-1)
    return (ham <= max_hamming).to(torch.float32)
