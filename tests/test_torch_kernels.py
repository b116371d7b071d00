"""The port's two kernel families against the JAX package, on the CPU.

Here the wrappers run their plain PyTorch versions (the tensors lie on the
CPU); the same inputs, made with numpy from a fixed seed, go through the
JAX reference and the Pallas kernel in interpret mode.  The CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked
tests at the end (and by ``chip_smoke.py``), which skip without a GPU.

Tolerance: both sides are float32 with different summation orders
(XLA's dot vs torch's BLAS), so floats agree within rtol 1e-5, atol 1e-6;
booleans and integer state are identical.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.symbolic import RuleSet as JRuleSet
from repro.kernels import dispatch
from repro.kernels.decode_step.ref import decode_step_ref
from repro.kernels.flow_ingest.kernel import flow_ingest_scores_pallas
from repro.train import classifier as JC
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.kernels.chimera_attention import ops as cops
from repro_torch.kernels.decode_step import ops as dops
from repro_torch.kernels.flow_ingest import ops as sops
from repro_torch.kernels.window_attention import ops as wops

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's and XLA's CPU thread pools contend in one process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# decode_step
# --------------------------------------------------------------------------

def _decode_inputs(seed, B, heads, Gq, d=16, dv=16, m=16, L=8):
    rng = np.random.default_rng(seed)
    BH = B * heads
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    pos = lambda *s: (rng.random(s) / np.sqrt(m)).astype(np.float32)  # noqa: E731
    return {
        "q": f(BH, Gq, d, scale=0.5), "k_t": f(BH, d, scale=0.5), "v_t": f(BH, dv),
        "phi_q": pos(BH, Gq, m), "phi_buf": pos(BH, L, m),
        "k_buf": f(BH, L, d, scale=0.5), "v_buf": f(BH, L, dv),
        "S": f(BH, m, dv, scale=0.1), "Z": pos(BH, m) * L,
    }, L


ORDER = ("q", "k_t", "v_t", "phi_q", "phi_buf", "k_buf", "v_buf", "S", "Z")


@pytest.mark.parametrize("Gq", [1, 2])
@pytest.mark.parametrize("counts", ["per-flow", "scalar-full", "scalar-mid"])
@pytest.mark.parametrize("jax_impl", ["reference", "pallas-interpret"])
def test_decode_step_plain_matches_jax(Gq, counts, jax_impl):
    B, heads = 4, 2
    x, L = _decode_inputs(seed=Gq, B=B, heads=heads, Gq=Gq)
    if counts == "per-flow":
        c = np.array([0, 3, L - 1, L - 2], np.int32)  # incl. a fold (L-1)
        c_jax = np.repeat(c, heads)
    else:
        c = np.array(L - 1 if counts == "scalar-full" else 2, np.int32)
        c_jax = c
    if jax_impl == "reference":
        out_j, state_j = decode_step_ref(
            *(jnp.asarray(x[k]) for k in ORDER), jnp.asarray(c_jax), chunk_size=L
        )
    else:
        impl = dispatch.resolve("decode_step", "pallas-interpret")
        out_j, state_j = impl(
            *(jnp.asarray(x[k]) for k in ORDER), jnp.asarray(c_jax), chunk_size=L
        )
    t = {k: _t(v) for k, v in x.items()}
    out_t, c_t = dops.decode_step(*(t[k] for k in ORDER), _t(c), chunk_size=L)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    for name, want in zip(("S", "Z", "k_buf", "v_buf"), state_j[:4]):
        np.testing.assert_allclose(t[name].numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want_c = np.asarray(state_j[4])
    if counts == "per-flow":
        want_c = want_c.reshape(B, heads)[:, 0]
    np.testing.assert_array_equal(c_t.numpy(), want_c)


def test_decode_step_global_partials_enter_the_merge():
    """gnum/gden join the numerator and denominator before normalization:
    out == (num_local + num_stream + gnum) / (den_local + den_stream + gden + γ),
    held against a numpy oracle; the state update ignores them."""
    B, heads, Gq = 3, 2, 2
    x, L = _decode_inputs(seed=7, B=B, heads=heads, Gq=Gq)
    c = np.array([1, L - 1, 5], np.int32)
    rng = np.random.default_rng(8)
    gnum = rng.standard_normal((B * heads, Gq, 16)).astype(np.float32)
    gden = rng.random((B * heads, Gq)).astype(np.float32)
    gamma = 1e-6

    cb = np.repeat(c, heads).astype(np.int64)
    want = np.empty_like(gnum, dtype=np.float64)
    for r in range(B * heads):
        kb, vb = x["k_buf"][r].astype(np.float64), x["v_buf"][r].astype(np.float64)
        kb[cb[r]], vb[cb[r]] = x["k_t"][r], x["v_t"][r]
        n = cb[r] + 1
        for g in range(Gq):
            s = np.exp(kb[:n] @ x["q"][r, g] / np.sqrt(16))
            num = s @ vb[:n] + x["phi_q"][r, g] @ x["S"][r] + gnum[r, g]
            den = s.sum() + x["phi_q"][r, g] @ x["Z"][r] + gden[r, g]
            want[r, g] = num / (den + gamma)

    t1 = {k: _t(v) for k, v in x.items()}
    out_g, _ = dops.decode_step(*(t1[k] for k in ORDER), _t(c), chunk_size=L,
                                gamma=gamma, gnum=_t(gnum), gden=_t(gden))
    np.testing.assert_allclose(out_g.numpy(), want, rtol=RTOL, atol=ATOL)
    t2 = {k: _t(v) for k, v in x.items()}
    dops.decode_step(*(t2[k] for k in ORDER), _t(c), chunk_size=L, gamma=gamma)
    for k in ("S", "Z", "k_buf", "v_buf"):  # globals never change the state
        np.testing.assert_array_equal(t1[k].numpy(), t2[k].numpy())


# --------------------------------------------------------------------------
# flow_score
# --------------------------------------------------------------------------

def _score_case(tiny_classifier_cfg, M, B, seed):
    rng = np.random.default_rng(seed)
    d, K, W = tiny_classifier_cfg.arch.d_model, tiny_classifier_cfg.n_classes, 8
    sig = rng.integers(0, 2**32, size=(B, W), dtype=np.uint64).astype(np.uint32)
    src = rng.integers(0, B, size=(M,))
    masks = rng.integers(0, 2**32, size=(M, W), dtype=np.uint64).astype(np.uint32)
    rand_vals = rng.integers(0, 2**32, size=(M, W), dtype=np.uint64).astype(np.uint32)
    values = np.where(rng.random((M, 1)) < 0.5, sig[src], rand_vals)
    weights = rng.standard_normal(M).astype(np.float32)
    hard = rng.random(M) < 0.3
    hard[0] = True
    params = {
        "cls": {"w": (rng.standard_normal((d, K)) / np.sqrt(d)).astype(np.float32)},
        "anom": {"w": (rng.standard_normal((d, 1)) / np.sqrt(d)).astype(np.float32)},
        "fusion": {"alpha": np.float32(0.7), "beta": np.float32(1.3)},
    }
    pooled = rng.standard_normal((B, d)).astype(np.float32)
    sticky = rng.random(B) < 0.25
    return params, (values, masks, weights, hard), pooled, sig, sticky


@pytest.mark.parametrize("M", [1, 130])
def test_flow_score_plain_matches_jax(tiny_classifier_cfg, M):
    B = 13  # not a multiple of 8
    params, rule_arrays, pooled, sig, sticky = _score_case(tiny_classifier_cfg, M, B, seed=M)
    jrules = JRuleSet(*(jnp.asarray(a) for a in rule_arrays))
    jparams = {k: {n: jnp.asarray(v) for n, v in p.items()} for k, p in params.items()}
    args = (jparams, jrules, jnp.asarray(pooled), jnp.asarray(sig), jnp.asarray(sticky))
    want_pallas, sticky_pallas = flow_ingest_scores_pallas(
        tiny_classifier_cfg, *args, lane_tile=8, state_tile=128, interpret=True
    )
    want_ref, _ = JC.streaming_scores(tiny_classifier_cfg, *args)

    out, new_sticky = sops.flow_score(
        bridge.params_from_jax(params, device="cpu"),
        bridge.rules_from_numpy(*rule_arrays, device="cpu"),
        _t(pooled), bridge.symbolic.uint32_to_int32(sig), _t(sticky),
    )
    assert out["hard_hit"].any() and not out["hard_hit"].all()
    assert (out["hard_hit"].numpy() & ~sticky).any()  # fresh TCAM hits, not only sticky
    for want in (want_pallas, want_ref):
        np.testing.assert_array_equal(out["hard_hit"].numpy(), np.asarray(want["hard_hit"]))
        for k in ("class_logits", "s_nn", "s_sym", "trust"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(new_sticky.numpy(), np.asarray(sticky_pallas))
    assert (out["trust"].numpy()[out["hard_hit"].numpy()] == 1.0).all()


# --------------------------------------------------------------------------
# the kernels' contracts cover every width the port's configs give them
# --------------------------------------------------------------------------

def _port_configs():
    """``(label, cfg)`` for every configuration the port runs: each registry
    config at full width and as ``smoke_config``, each also as its softmax
    variant (``launch/dryrun.py --no-chimera``: banded for SWA, full-causal
    otherwise).  The full widths are the model zoo's default Chimera widths
    (L 256, m 128, d_head 128, Gq 1, 4 and 8; MiniCPM3-4B's MLA heads at q/k
    width 96 and v width 64), which ``decode_step`` takes with its ring
    tiled and ``chimera_attention`` through its long-chunk kernel."""
    out = []
    for name in sorted(registry.ARCHS):
        for size, cfg in (("full", registry.get_config(name)),
                          ("smoke", registry.smoke_config(name))):
            out.append((f"{name} {size}", cfg))
            out.append((f"{name} {size} softmax", dataclasses.replace(cfg, use_chimera=False)))
    return out


# the full-causal softmax prefill runs window_attention with the window at
# the prompt's length: any length the launcher serves
FULL_CAUSAL_T = 8192
# the enc-dec encoder's frames: 30 s of audio, padded (whisper-tiny)
ENCODER_T = 1536


def _kernel_calls(cfg):
    """``(kernel, contract(...))`` for each kernel the config's paths launch:
    the Chimera stack's decode_step (flow ingest, LM decode), flow_score
    (flow ingest, the classifier's 8 classes over 8 signature words) and
    chimera_attention (training); the softmax stack's window_attention (LM
    prefill, banded or at W = T).  MLA's heads are its materialized ones:
    H heads of q/k width qk_nope + qk_rope and v width v_head_dim.  A stack
    without attention blocks (xLSTM) launches none of them.  An enc-dec
    stack (whisper-tiny) also runs window_attention's non-causal mode: its
    encoder (Te keys) and, with use_chimera False, its cross-attention."""
    if "attn" not in cfg.pattern:
        return []
    H, Hkv, d, dv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim
    if cfg.attention_kind == "mla":
        Hkv, d, dv = H, cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim or cfg.head_dim
    encoder = ([("window_attention", wops.contract(d=d, dv=dv, H=H, Hkv=Hkv, causal=False,
                                                   n_k=ENCODER_T))] if cfg.encoder_layers else [])
    if cfg.use_chimera:
        ch = cfg.chimera
        m, L = ch.feature_map.feature_dim(d), ch.chunk_size
        return encoder + [
            ("decode_step", dops.contract(Gq=H // Hkv, d=d, dv=dv, m=m, L=L)),
            ("flow_score", sops.contract(d=cfg.d_model, K=8, W=8, M=1)),
            ("chimera_attention", cops.contract(d=d, dv=dv, m=m, L=L)),
        ]
    swa = cfg.attention_kind == "swa" and cfg.sliding_window
    return encoder + [("window_attention", wops.contract(d=d, dv=dv, H=H, Hkv=Hkv,
                                                         window=cfg.sliding_window if swa
                                                         else FULL_CAUSAL_T))]


@pytest.mark.parametrize("label,cfg", _port_configs(), ids=[c[0] for c in _port_configs()])
def test_every_port_config_lies_inside_every_kernel_contract(label, cfg):
    calls = _kernel_calls(cfg)
    assert calls or "attn" not in cfg.pattern
    for kernel, refused in calls:
        assert refused is None, f"{label}: {kernel}: {refused}"


@pytest.mark.parametrize("contract,dims", [
    (dops.contract, dict(Gq=1, d=64, dv=24, m=256, L=64)),
    (dops.contract, dict(Gq=1, d=18, dv=64, m=256, L=64)),
    (dops.contract, dict(Gq=8, d=1024, dv=128, m=128, L=256)),  # shared memory, ring tiled
    (cops.contract, dict(d=64, dv=64, m=256, L=512)),
    (cops.contract, dict(d=64, dv=64, m=24, L=64)),
    (cops.contract, dict(d=12, dv=64, m=64, L=64)),
    # L 256: the chunk kernel's q and k tiles grow with d, 547 KB here
    (cops.contract, dict(d=1024, dv=128, m=128, L=256)),
    (wops.contract, dict(d=256, dv=256, H=4, Hkv=2, window=8)),
    (wops.contract, dict(d=64, dv=64, H=4, Hkv=3, window=8)),
    (sops.contract, dict(d=0, K=8, W=8, M=1)),
])
def test_contracts_name_what_they_refuse(contract, dims):
    assert isinstance(contract(**dims), str)


@pytest.mark.parametrize("d,dv,m", [(128, 128, 128), (128, 128, 320), (128, 128, 1024),
                                    (64, 128, 512), (24, 32, 16), (384, 128, 128)])
def test_long_chunk_kernel_shared_memory_does_not_grow_with_m(d, dv, m):
    """L 256: the readout and the fold stage m in slices, so every m % 16
    is taken up to the shared memory that d and dv alone set."""
    assert cops.contract(d=d, dv=dv, m=m, L=256) is None
    assert cops._long_smem_bytes(d, dv, m) <= cops._long_smem_bytes(d, dv, 128)


# --------------------------------------------------------------------------
# the CUDA kernels (skip without a GPU)
# --------------------------------------------------------------------------

def _chip_smoke():
    """The smoke script's kernel checks (kernel vs plain version on the card)."""
    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_global", [False, True])
def test_decode_step_kernel_matches_plain_on_card(cuda, with_global):
    chip_smoke = _chip_smoke()
    chip_smoke.check_decode(with_global, timed=False)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["none", "spread", "all"])
@pytest.mark.parametrize("Gq", [1, 2])
@pytest.mark.parametrize("dv", [16, 32, 64, 128])
@pytest.mark.parametrize("with_global", [False, True])
def test_decode_step_kernel_edge_shapes_on_card(cuda, fill, Gq, dv, with_global):
    """out, S, Z, the ring and count against the plain version (64 lanes x 4
    kv-heads, d 64, m 256, L 64): no fold, one flow in 64 folding, all."""
    chip_smoke = _chip_smoke()
    chip_smoke.check_decode(with_global, timed=False, fill=fill, B=64, Gq=Gq, dv=dv)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 300])
def test_flow_score_kernel_matches_plain_on_card(cuda, M):
    chip_smoke = _chip_smoke()
    chip_smoke.check_score(M, timed=False)


@pytest.mark.cuda
@pytest.mark.parametrize("K,W", [(5, 3), (12, 8), (8, 5)])
def test_flow_score_kernel_generic_shapes_on_card(cuda, K, W):
    """Class and signature widths off the kernel's K = 8, W = 8 fast path."""
    chip_smoke = _chip_smoke()
    chip_smoke.check_score(40, timed=False, K=K, W=W)
