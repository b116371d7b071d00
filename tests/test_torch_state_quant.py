"""The port's quantized Chimera decode state (``repro_torch.core.state_quant``)
on the CPU, against the JAX package's.

* The counterparts of ``tests/test_state_quant.py``, on the port alone:
  round-trip error, the asymmetric-precision ordering, end-to-end decode
  drift, the memory saving, the η_q bound at every width pair (and its
  hypothesis sweep) and the refused 12-bit width.
* Against JAX, from the same numpy state: ``quantize_state``'s ints and
  scales are bit-identical at three width pairs; a JAX ``QuantChimeraState``
  crosses through ``bridge.quant_state_from_numpy``; over 8 ticks of
  ``quant_decode_step`` from it the outputs agree within OUT_TOL and the
  requantized ints differ by at most one step, on at most REQUANT_SHARE of
  the elements.  The two float steps sum in other orders, so an element
  whose scaled value lies within float32 rounding of a half step rounds to
  the neighbouring int in one package: measured here, 0 elements over the 8
  ticks (the share is a bound, not a target).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import chimera_attention as JCA
from repro.core import state_quant as JSQ
from repro.core.feature_maps import FeatureMapConfig as JFeatureMapConfig
from repro_torch import bridge
from repro_torch.core import chimera_attention as TCA
from repro_torch.core.feature_maps import FeatureMapConfig
from repro_torch.core.state_quant import (
    StateQuantConfig,
    _int_dtype,
    dequantize_state,
    quant_decode_step,
    quantize_state,
    state_bytes,
)

OUT_TOL = 1e-5  # quant_decode_step's output against JAX's, 8 ticks
REQUANT_SHARE = 1e-3  # requantized ints one step apart; measured 0

CFG_J = JCA.ChimeraAttentionConfig(feature_map=JFeatureMapConfig(kind="exp_prf", m=32),
                                   chunk_size=16, n_global=0)
CFG = TCA.ChimeraAttentionConfig(feature_map=FeatureMapConfig(kind="exp_prf", m=32),
                                 chunk_size=16, n_global=0)


def _setup(B=2, H=2, T=64, d=16, seed=0):
    params = TCA.init_chimera_attention(CFG, H, d, d, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    q, k, v = (torch.randn((B, H, T, d), generator=g) for _ in range(3))
    return params, q, k, v


def _run(params, q, k, v, steps, B=2, H=2, d=16):
    state = TCA.init_decode_state(CFG, B, H, d, d)
    for t in range(steps):
        TCA.chimera_decode_step(CFG, params, q[:, :, t], k[:, :, t], v[:, :, t], state)
    return state


def test_roundtrip_error_small():
    state = _run(*_setup(), 48)
    back = dequantize_state(quantize_state(state))
    rel_S = float(torch.linalg.norm(back.S - state.S) / (torch.linalg.norm(state.S) + 1e-9))
    rel_Z = float(torch.linalg.norm(back.Z - state.Z) / (torch.linalg.norm(state.Z) + 1e-9))
    assert rel_S < 1e-3  # 16-bit accumulator
    assert rel_Z < 2e-2  # 8-bit normalization mass (asymmetric — §4.12)


def test_asymmetric_precision_ordering():
    """§4.12: the accumulator gets more precision than the normalization."""
    state = _run(*_setup(), 32)
    sym_lo = quantize_state(state, StateQuantConfig(s_bits=8, z_bits=8))
    asym = quantize_state(state, StateQuantConfig(s_bits=16, z_bits=8))
    err_lo = float(torch.linalg.norm(dequantize_state(sym_lo).S - state.S))
    err_asym = float(torch.linalg.norm(dequantize_state(asym).S - state.S))
    assert err_asym < err_lo / 10


def test_end_to_end_decode_drift_bounded():
    """Quantize-at-rest decode tracks the fp32 decode over a long stream, and
    leaves the state it was given as it was."""
    params, q, k, v = _setup(T=96)
    state_fp = TCA.init_decode_state(CFG, 2, 2, 16, 16)
    state_q = quantize_state(state_fp)
    max_err = 0.0
    for t in range(96):
        o_fp = TCA.chimera_decode_step(CFG, params, q[:, :, t], k[:, :, t], v[:, :, t], state_fp)
        before = [x.clone() for x in state_q.leaves()]
        o_q, new_q = quant_decode_step(CFG, params, q[:, :, t], k[:, :, t], v[:, :, t], state_q)
        for a, b in zip(before, state_q.leaves()):
            assert torch.equal(a, b)
        state_q = new_q
        max_err = max(max_err, float(torch.max(torch.abs(o_fp - o_q))))
    scale = float(torch.max(torch.abs(o_fp)))
    assert max_err < 0.05 * max(scale, 1.0), f"drift {max_err} vs scale {scale}"


def test_memory_saving():
    state = TCA.init_decode_state(CFG, 4, 2, 16, 16, dtype=torch.float32)
    qs = quantize_state(state)
    assert state_bytes(state) / state_bytes(qs) > 1.8  # S fp32->int16, Z ->int8, bufs ->bf16
    assert state_bytes(qs) == sum(x.nbytes for x in jax.tree_util.tree_leaves(
        JSQ.quantize_state(JCA.init_decode_state(CFG_J, 4, 2, 16, 16))))


def check_roundtrip_eta_q(s_bits, z_bits, seed, magnitude):
    """quantize -> dequantize error per element <= η_q = scale/2 (Thm A.3),
    plus an fp32-mantissa slack that only matters at 32 bits."""
    assert _int_dtype(s_bits) == {8: torch.int8, 16: torch.int16, 32: torch.int32}[s_bits]
    base = TCA.init_decode_state(CFG, 2, 2, 16, 16)
    g = torch.Generator().manual_seed(seed)
    state = dataclasses.replace(
        base,
        S=torch.randn(base.S.shape, generator=g) * magnitude,
        Z=torch.abs(torch.randn(base.Z.shape, generator=g)) * magnitude,
    )
    qs = quantize_state(state, StateQuantConfig(s_bits=s_bits, z_bits=z_bits))
    assert qs.S_q.dtype == _int_dtype(s_bits) and qs.Z_q.dtype == _int_dtype(z_bits)
    back = dequantize_state(qs)
    for x, b, scale in ((state.S, back.S, qs.S_scale), (state.Z, back.Z, qs.Z_scale)):
        eta_q = 0.5 * scale
        slack = torch.abs(x) * 2.0 ** -22
        err = torch.abs(b - x)
        assert bool(torch.all(err <= eta_q + slack + 1e-12)), (
            s_bits, z_bits, float(torch.max(err - eta_q - slack)))


class TestRoundTripEtaQ:
    @pytest.mark.parametrize("s_bits", (8, 16, 32))
    @pytest.mark.parametrize("z_bits", (8, 16, 32))
    def test_eta_q_bound_all_widths(self, s_bits, z_bits):
        check_roundtrip_eta_q(s_bits, z_bits, seed=3, magnitude=4.0)

    def test_unsupported_width_rejected(self):
        with pytest.raises(ValueError, match="8, 16 or 32"):
            _int_dtype(12)
        with pytest.raises(ValueError, match="8, 16 or 32"):
            quantize_state(TCA.init_decode_state(CFG, 1, 1, 16, 16), StateQuantConfig(s_bits=12))

    @settings(max_examples=25, deadline=None)
    @given(s_bits=st.sampled_from((8, 16, 32)), z_bits=st.sampled_from((8, 16, 32)),
           seed=st.integers(0, 2**16), magnitude=st.floats(1e-3, 1e3))
    def test_eta_q_bound_property(self, s_bits, z_bits, seed, magnitude):
        check_roundtrip_eta_q(s_bits, z_bits, seed, magnitude)


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run():
    """JAX params, a state after 40 tokens (two folds), and 8 more tokens."""
    B, H, d = 2, 2, 16
    params = JCA.init_chimera_attention(CFG_J, H, d, d, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, H, 48, d)).astype(np.float32) for _ in range(3))
    state = JCA.init_decode_state(CFG_J, B, H, d, d)
    for t in range(40):
        _, state = JCA.chimera_decode_step(CFG_J, params, q[:, :, t], k[:, :, t], v[:, :, t],
                                           state)
    return params, state, (q[:, :, 40:], k[:, :, 40:], v[:, :, 40:])


def _tstate(jstate):
    return TCA.ChimeraState(*(torch.from_numpy(np.array(x)) for x in (
        jstate.S, jstate.Z, jstate.k_buf, jstate.v_buf, jstate.count)))


def _np_leaves(qs):
    return [np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
            for x in jax.tree_util.tree_leaves(qs)]


@pytest.mark.parametrize("s_bits,z_bits", [(16, 8), (8, 8), (32, 32)])
def test_quantize_state_bit_identical_to_jax(jax_run, s_bits, z_bits):
    _, jstate, _ = jax_run
    jq = JSQ.quantize_state(jstate, JSQ.StateQuantConfig(s_bits=s_bits, z_bits=z_bits))
    tq = quantize_state(_tstate(jstate), StateQuantConfig(s_bits=s_bits, z_bits=z_bits))
    for t, j in zip(tq.leaves(), _np_leaves(jq)):
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    jb = JSQ.dequantize_state(jq)
    tb = dequantize_state(tq)
    for name in ("S", "Z", "k_buf", "v_buf", "count"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))


def test_quant_decode_step_matches_jax_over_8_ticks(jax_run):
    jparams, jstate, (q, k, v) = jax_run
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jq = JSQ.quantize_state(jstate)
    tq = bridge.quant_state_from_numpy(*(np.asarray(x) for x in jax.tree_util.tree_leaves(jq)),
                                       device="cpu")
    assert tq.k_buf.dtype == torch.bfloat16 and tq.S_q.dtype == torch.int16
    moved = total = 0
    for t in range(8):
        jo, jq = JSQ.quant_decode_step(CFG_J, jparams, q[:, :, t], k[:, :, t], v[:, :, t], jq)
        to, tq = quant_decode_step(CFG, tparams, *(torch.from_numpy(np.ascontiguousarray(x[:, :, t]))
                                                   for x in (q, k, v)), tq)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=OUT_TOL)
        for a, b in ((tq.S_q, jq.S_q), (tq.Z_q, jq.Z_q)):
            diff = np.abs(a.numpy().astype(np.int64) - np.asarray(b).astype(np.int64))
            assert diff.max() <= 1
            moved += int((diff != 0).sum())
            total += diff.size
        np.testing.assert_allclose(tq.S_scale.numpy(), np.asarray(jq.S_scale), rtol=1e-5)
        np.testing.assert_array_equal(tq.count.numpy(), np.asarray(jq.count))
        # the port's ints stay its own: the next tick starts from them
    assert moved <= REQUANT_SHARE * total, (moved, total)
