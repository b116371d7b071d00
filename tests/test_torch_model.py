"""The port's model path against the JAX package, on the CPU, at the
``tiny_arch`` size (2 layers, d 32, 2 heads, d_head 16, m 16, L 16).

Inputs and weights come from numpy / the JAX initializer and cross the
boundary as numpy; the port runs its plain kernel versions here.

Tolerance: float32 on both sides with different summation orders, so
rtol 1e-4, atol 1e-5 (errors grow through the layers and the stream state
accumulates up to 2·L+3 tokens); discrete state (counts, bits) is identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chimera_attention as JCA
from repro.core import feature_maps as JFM
from repro.core import key_selection as JKS
from repro.core import symbolic as JS
from repro.models import model as JM
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.core import chimera_attention as TCA
from repro_torch.core import feature_maps as TFM
from repro_torch.core import key_selection as TKS
from repro_torch.core import symbolic as TS
from repro_torch.models import model as TM
from repro_torch.train import classifier as TC

RTOL, ATOL = 1e-4, 1e-5
# a sign-LSH bit is `x·proj > 0`; two float32 reductions of the same dot
# product may disagree on its sign only when it is this close to zero
LSH_EPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _chimera_cfg(tiny_arch, n_global):
    return dataclasses.replace(tiny_arch.chimera, n_global=n_global, use_pallas=False)


# --------------------------------------------------------------------------
# core math
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,m", [("exp_prf", 16), ("elu1", 24), ("relu", 24)])
def test_feature_map_matches_jax(kind, m):
    cfg_j = JFM.FeatureMapConfig(kind=kind, m=m)
    cfg_t = TFM.FeatureMapConfig(kind=kind, m=m)
    params = JFM.init_feature_map(cfg_j, 16, jax.random.PRNGKey(3))
    x = np.random.default_rng(0).standard_normal((5, 7, 16)).astype(np.float32)
    want = JFM.apply_feature_map(cfg_j, params, jnp.asarray(x))
    got = TFM.apply_feature_map(cfg_t, {k: _t(v) for k, v in params.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_exp_prf_init_rows_are_block_orthogonal():
    w = TFM.init_feature_map(
        TFM.FeatureMapConfig(kind="exp_prf", m=40), 16, torch.Generator().manual_seed(1)
    )["w"].double()
    assert w.shape == (40, 16)
    for b in range(2):  # two full 16-row blocks: orthogonal rows
        blk = w[16 * b: 16 * (b + 1)]
        gram = blk @ blk.T
        off = gram - torch.diag(torch.diagonal(gram))
        assert off.abs().max() < 1e-4 * gram.diagonal().max()


def test_sign_lsh_bits_agree_except_at_zero_crossings():
    """make_signature's bits agree with the JAX package's on the same inputs;
    any bit that differs must have |x·proj| < LSH_EPS (a near-zero dot product
    whose sign depends on the summation order), never a real disagreement."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4096, 16)).astype(np.float32)
    x[:64] = 0.0  # exact zeros: both sides must give bit 0
    proj = rng.standard_normal((16, 16)).astype(np.float32)
    got = TKS.make_signature(_t(x), _t(proj)).numpy()
    want = np.asarray(JKS.make_signature(jnp.asarray(x), jnp.asarray(proj)))
    dots = np.abs(x.astype(np.float64) @ proj.astype(np.float64))
    mismatch = got != want
    assert (dots[mismatch] < LSH_EPS).all(), dots[mismatch].max()
    assert not got[:64].any()
    sig_k = rng.integers(0, 2, size=(3, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        TKS.ternary_match_mask(_t(got[:8, None]), _t(sig_k), 8).numpy(),
        np.asarray(JKS.ternary_match_mask(jnp.asarray(got[:8, None]), jnp.asarray(sig_k), 8)),
    )


def test_pack_bits_packet_signature_and_default_rules_match_jax(tiny_classifier_cfg):
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, size=(6, 70))
    np.testing.assert_array_equal(
        TS.pack_bits(_t(bits)).numpy().view(np.uint32),
        np.asarray(JS.pack_bits(jnp.asarray(bits))),
    )
    tokens = rng.integers(0, 512, size=(9, 16)).astype(np.int32)
    tokens[0, :4] = [256, 287, 288, 511]  # word edges, incl. the sign bit
    ccfg_t = bridge.classifier_config_from_reference(tiny_classifier_cfg)
    np.testing.assert_array_equal(
        TC.packet_signature(ccfg_t, _t(tokens)).numpy().view(np.uint32),
        np.asarray(JC.packet_signature(tiny_classifier_cfg, jnp.asarray(tokens))),
    )
    anom = np.array([300, 319, 400, 511])
    jr = JC.default_rules(tiny_classifier_cfg, jnp.asarray(anom))
    tr = TC.default_rules(ccfg_t, anom, device="cpu")
    np.testing.assert_array_equal(tr.values.numpy().view(np.uint32), np.asarray(jr.values))
    np.testing.assert_array_equal(tr.masks.numpy().view(np.uint32), np.asarray(jr.masks))
    np.testing.assert_array_equal(tr.weights.numpy(), np.asarray(jr.weights))
    np.testing.assert_array_equal(tr.hard.numpy(), np.asarray(jr.hard))


# --------------------------------------------------------------------------
# chimera_decode_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_global", [0, 8])
def test_chimera_decode_step_matches_jax(tiny_arch, n_global):
    """2·L+3 tokens per flow, so every flow folds its ring twice; per-flow
    fill levels start staggered."""
    cfg_j = _chimera_cfg(tiny_arch, n_global)
    cfg_t = bridge.arch_from_reference(dataclasses.replace(tiny_arch, chimera=cfg_j)).chimera
    B, H, Hkv, d = 3, 2, 2, 16
    params = JCA.init_chimera_attention(cfg_j, Hkv, d, d, jax.random.PRNGKey(4))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    st_j = JCA.init_decode_state(cfg_j, B, Hkv, d, d)
    st_t = TCA.init_decode_state(cfg_t, B, Hkv, d, d)
    rng = np.random.default_rng(n_global)
    L = cfg_j.chunk_size
    step_j = jax.jit(JCA.chimera_decode_step, static_argnums=0)
    for step in range(2 * L + 3 + 2):
        q, k, v = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, H, d), (B, Hkv, d), (B, Hkv, d)))
        if step < 2:  # stagger: flow 0 starts two tokens later
            st_j.count = st_j.count.at[0].set(0)
            st_t.count[0] = 0
        out_j, st_j = step_j(
            cfg_j, params, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), st_j
        )
        out_t = TCA.chimera_decode_step(cfg_t, tparams, _t(q), _t(k), _t(v), st_t)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(st_t.count.numpy(), np.asarray(st_j.count))
    assert (np.asarray(st_j.count) != 0).all()  # folded, then refilled
    for name in ("S", "Z", "k_buf", "v_buf"):
        np.testing.assert_allclose(
            getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)), rtol=RTOL, atol=ATOL
        )


# --------------------------------------------------------------------------
# decode_hidden_step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def classifier_pair(tiny_classifier_cfg):
    params, _ = JC.init_classifier(tiny_classifier_cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return tiny_classifier_cfg, params, tparams


def test_decode_hidden_step_matches_jax_per_token(classifier_pair):
    ccfg, params, tparams = classifier_pair
    arch_t = bridge.arch_from_reference(ccfg.arch)
    B = 4
    caches_j = JM.init_caches(ccfg.arch, B, 0, dtype=jnp.float32)
    caches_t = TM.init_caches(arch_t, B, device="cpu")
    rng = np.random.default_rng(1)
    L = ccfg.arch.chimera.chunk_size
    step_j = jax.jit(JM.decode_hidden_step, static_argnums=0)
    for step in range(2 * L + 3):
        tok = rng.integers(0, 512, size=(B,)).astype(np.int32)
        pos = np.full((B,), step, np.int32)
        h_j, caches_j = step_j(
            ccfg.arch, params["backbone"], jnp.asarray(tok), jnp.asarray(pos), caches_j
        )
        h_t = TM.decode_hidden_step(arch_t, tparams["backbone"], _t(tok), _t(pos), caches_t)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=RTOL, atol=ATOL)
    for name in ("S", "Z", "k_buf", "v_buf", "count"):
        got, want = getattr(caches_t["b0"], name).numpy(), np.asarray(getattr(caches_j["b0"], name))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
