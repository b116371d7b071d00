"""The port's LM serving slice against the JAX package, on the CPU: the
``window_attention`` kernel's plain version, the MoE layer, softmax
sliding-window (SWA) attention with its ring KV cache, ``prefill_with_caches``
and ``ServeEngine``, at the smoke size of Mixtral-8x7B (2 layers, d 64, 4
heads over 2 kv-heads, d_head 16, 4 experts top-2) with a window cut to 32
so that prompts cross it.  The port runs its plain kernel versions here; the
JAX package's Pallas kernel runs in interpret mode.

Tolerances: float32 on both sides with different summation orders, so
rtol 1e-4, atol 1e-5 (RTOL, ATOL); greedy generations and MoE routing are
identical.  bfloat16 rounds at other places in XLA (which may keep excess
precision in fused chains) than in torch, so the bf16 test states its own
tolerance (BF16_MEAN, BF16_MAX).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.kernels.window_attention.kernel import window_attention_pallas
from repro.kernels.window_attention.ref import window_attention_ref
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serve import engine as JE
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.feature_maps import FeatureMapConfig
from repro_torch.kernels.window_attention import ops as wops
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.serve import engine as TE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
WINDOW = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def _swa_cfg(**kw):
    """The JAX smoke Mixtral in softmax mode with a window prompts can cross."""
    return dataclasses.replace(j_smoke("mixtral-8x7b"), use_chimera=False,
                               sliding_window=WINDOW, **kw)


@pytest.fixture(scope="module")
def mixtral():
    jcfg = _swa_cfg()
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, params, bridge.arch_from_reference(jcfg), bridge.params_from_jax(
        _np(params), device="cpu")


def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


# --------------------------------------------------------------------------
# the window_attention kernel's plain version and wrapper
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T,blk_q,blk_k", [(96, 32, 32), (96, 96, 32), (128, 32, 32),
                                           (128, 64, 32)])
@pytest.mark.parametrize("W", [32, 64, 128])
def test_window_plain_matches_ref_and_pallas(T, blk_q, blk_k, W):
    rng = np.random.default_rng(T + W + blk_q)
    q, k, v = (rng.standard_normal((3, T, 16)).astype(np.float32) for _ in range(3))
    got = wops.window_attention_plain(_t(q), _t(k), _t(v), W)
    _close(got, window_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), W))
    _close(got, window_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        window=W, blk_q=blk_q, blk_k=blk_k, interpret=True))


@pytest.mark.parametrize("T,W", [(50, 7), (96, 32), (40, 100)])
def test_window_wrapper_cpu_route_matches_ref_with_kv_heads(T, W):
    """The wrapper takes K and V per kv-head; the reference repeats them to
    the query heads first (models/attention.py:116-118)."""
    rng = np.random.default_rng(T)
    B, H, Hkv, d = 2, 4, 2, 16
    q = rng.standard_normal((B, H, T, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, T, d)).astype(np.float32) for _ in range(2))
    ke, ve = (np.repeat(x, H // Hkv, axis=1).reshape(B * H, T, d) for x in (k, v))
    want = window_attention_ref(jnp.asarray(q.reshape(B * H, T, d)), jnp.asarray(ke),
                                jnp.asarray(ve), W)
    before = wops.launches
    got = wops.sliding_window_attention(_t(q), _t(k), _t(v), W)
    assert wops.launches == before  # the plain version is no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, T, d)
    _close(got.reshape(B * H, T, d), want)


def test_window_wrapper_refuses_other_devices_and_bad_inputs():
    meta = torch.device("meta")
    z = lambda *s, dev="cpu": torch.zeros(s, device=dev)  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        wops.sliding_window_attention(z(1, 2, 8, 4, dev=meta), z(1, 1, 8, 4, dev=meta),
                                      z(1, 1, 8, 4, dev=meta), 4)
    with pytest.raises(ValueError, match="query heads over"):
        wops.sliding_window_attention(z(1, 3, 8, 4), z(1, 2, 8, 4), z(1, 2, 8, 4), 4)
    with pytest.raises(ValueError, match="window must be"):
        wops.sliding_window_attention(z(1, 2, 8, 4), z(1, 1, 8, 4), z(1, 1, 8, 4), 0)
    with pytest.raises(TypeError, match="k is torch.float64"):
        wops.sliding_window_attention(z(1, 2, 8, 4), z(1, 1, 8, 4).double(), z(1, 1, 8, 4), 4)
    assert wops.launches == 0


def _tf32(x):
    """x rounded to TF32 by dropping the low 13 of fp32's 23 mantissa bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_mm(a, b, passes):
    """a @ b as the tensor cores form it from TF32 operands with fp32 sums:
    one pass (a_hi b_hi), or split fp32 (a_lo b_hi + a_hi b_lo + a_hi b_hi).
    A product of two TF32 values is exact in fp32, so fp32 matmuls of the
    rounded operands emulate it."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _window_tf32(q, k, v, window, passes, tile=64):
    """csrc/window_attention.cu's arithmetic (BH layout): per 64-key tile
    S = Q K^T in emulated TF32, an online softmax in fp32 in the log2 domain
    with the -1e30 guard, and P V in emulated TF32 into a fresh accumulator
    that is added to O with fp32 adds."""
    BH, T, d = q.shape
    neg = -1e30
    sc = (1 / d ** 0.5) * 1.4426950408889634
    i = torch.arange(T)[:, None]
    m = torch.full((BH, T, 1), neg)
    l = torch.zeros(BH, T, 1)
    acc = torch.zeros(BH, T, v.shape[-1])
    for j0 in range(0, T, tile):
        j = torch.arange(j0, min(j0 + tile, T))[None, :]
        band = (j <= i) & (i - j < window)
        s = torch.where(band, _tf32_mm(q, k[:, j0:j0 + tile].transpose(1, 2), passes), neg)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * sc)
        alpha = torch.exp2(m - mn)
        p = torch.where(band, torch.exp2(s * sc - mn), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_mm(p, v[:, j0:j0 + tile], passes)
        m = mn
    return acc / l


def test_window_split_fp32_keeps_the_kernel_tolerance_and_one_tf32_pass_does_not():
    """Why csrc/window_attention.cu runs 3xTF32: at BH 2, T 1024, W 512,
    d 128, N(0, 1) inputs, split fp32 stays within the tolerance the card's
    kernel is held to (chip_smoke's ATOL 1e-5 + RTOL 1e-4 * |ref|) of the fp32
    plain version; a single TF32 pass on both products does not."""
    rng = np.random.default_rng(15)
    q, k, v = (_t(rng.standard_normal((2, 1024, 128)).astype(np.float32)) for _ in range(3))
    ref = wops.window_attention_plain(q, k, v, 512)
    beyond = {}
    for passes in (3, 1):
        got = _window_tf32(q, k, v, 512, passes)
        beyond[passes] = int(((got - ref).abs() > ATOL + RTOL * ref.abs()).sum())
    assert beyond[3] == 0, f"split fp32: {beyond[3]} entries beyond the tolerance"
    assert beyond[1] > 0, "one TF32 pass stayed within the tolerance"


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _drops(cfg, router_w, x):
    """Selections over capacity under the reference's routing (numpy)."""
    B, T, d = x.shape
    g = min(JMoE.MOE_GROUP_SIZE, T)
    G, E, k = B * T // g, cfg.moe_experts, cfg.moe_top_k
    C = max(1, int(g * k * cfg.capacity_factor / E))
    ids = np.argsort(-(x.reshape(G, g, d) @ router_w), axis=-1, kind="stable")[..., :k]
    counts = np.stack([(ids == e).sum(axis=(1, 2)) for e in range(E)], -1)
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("cf,shared", [(4.0, 0), (1.0, 0), (4.0, 1)])
def test_moe_layer_matches_jax(cf, shared):
    jcfg = _swa_cfg(capacity_factor=cf, moe_shared_experts=shared)
    p, _ = JMoE.init_moe(jcfg, jax.random.PRNGKey(3))
    x = np.random.default_rng(1).standard_normal((2, 96, jcfg.d_model)).astype(np.float32)
    out_j, aux_j = JMoE.moe_layer(jcfg, p, jnp.asarray(x))
    out_t, aux_t = TMoE.moe_layer(bridge.arch_from_reference(jcfg),
                                  bridge.params_from_jax(_np(p), device="cpu"), _t(x))
    _close(out_t, out_j)
    _close(aux_t, aux_j)
    drops = _drops(jcfg, np.asarray(p["router"]["w"]), x)
    assert (drops > 0) == (cf == 1.0), drops  # capacity factor 1.0 drops selections


@pytest.mark.parametrize("cf", [64.0, 11.0, 1.25])
def test_moe_layer_at_moonshot_routing_matches_jax(cf):
    """moonshot-v1-16b-a3b's routing at d 64: 64 experts, top-6, 2 shared
    experts, drop-free (capacity factor E as smoke_config sets it, and
    ceil(E / k) = 11, at which chip_smoke's prefill-vs-decode checks run)
    and at the config's 1.25, which drops selections."""
    jcfg = dataclasses.replace(j_smoke("moonshot-v1-16b-a3b"), moe_experts=64, moe_top_k=6,
                               moe_shared_experts=2, capacity_factor=cf)
    assert (jcfg.d_model, jcfg.moe_experts, jcfg.moe_top_k) == (64, 64, 6)
    p, _ = JMoE.init_moe(jcfg, jax.random.PRNGKey(4))
    x = np.random.default_rng(2).standard_normal((2, 96, jcfg.d_model)).astype(np.float32)
    out_j, aux_j = JMoE.moe_layer(jcfg, p, jnp.asarray(x))
    out_t, aux_t = TMoE.moe_layer(bridge.arch_from_reference(jcfg),
                                  bridge.params_from_jax(_np(p), device="cpu"), _t(x))
    _close(out_t, out_j)
    _close(aux_t, aux_j)
    drops = _drops(jcfg, np.asarray(p["router"]["w"]), x)
    assert (drops > 0) == (cf < 11.0), drops


def test_moe_init_layout_matches_jax():
    jcfg = _swa_cfg(moe_shared_experts=1)
    pj, _ = JMoE.init_moe(jcfg, jax.random.PRNGKey(0))
    pt = TMoE.init_moe(bridge.arch_from_reference(jcfg), torch.Generator().manual_seed(0))
    shapes = lambda tree: {p: tuple(np.shape(x)) for p, x in _leaves(tree)}  # noqa: E731
    assert shapes(pt) == shapes(_np(pj))


# --------------------------------------------------------------------------
# softmax SWA attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "reference"])
def test_swa_attention_layer_matches_jax(mixtral, backend):
    jcfg, params, tcfg, tparams = mixtral
    jcfg = dataclasses.replace(jcfg, swa_backend=backend)
    x = np.random.default_rng(2).standard_normal((2, 96, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(96), (2, 96))
    want = JA.attention_layer(jcfg, _layer(params["blocks"]["b0"]["attn"]), jnp.asarray(x),
                              jnp.asarray(pos))
    got = TA.attention_layer(tcfg, TM.index_params(tparams["blocks"]["b0"]["attn"], 0), _t(x),
                             _t(pos))
    _close(got, want)


def test_swa_decode_matches_jax_across_ring_wraps(mixtral):
    """Window 8, max_len 64: a ring of 8 slots, written 20 times."""
    jcfg, params, _, tparams = mixtral
    jcfg = dataclasses.replace(jcfg, sliding_window=8)
    tcfg = bridge.arch_from_reference(jcfg)
    pj, pt = _layer(params["blocks"]["b0"]["attn"]), TM.index_params(
        tparams["blocks"]["b0"]["attn"], 0)
    cj = JA.init_attention_cache(jcfg, 2, 64, jnp.float32)
    ct = TA.init_attention_cache(tcfg, 2, 64, torch.float32)
    assert tuple(ct["k"].shape) == np.shape(cj["k"]) == (2, 2, 8, 16)
    xs = np.random.default_rng(4).standard_normal((20, 2, 1, jcfg.d_model)).astype(np.float32)
    for t in range(20):
        pos = np.full((2,), t, np.int32)
        oj, cj = JA.attention_decode(jcfg, pj, jnp.asarray(xs[t]), jnp.asarray(pos), cj)
        ot = TA.attention_decode(tcfg, pt, _t(xs[t]), _t(pos), ct)
        _close(ot, oj, msg=f"step {t}")
    for name in ("k", "v"):
        _close(ct[name], cj[name])


@pytest.mark.parametrize("T,window,max_len", [(96, 32, 128), (24, 32, 128), (40, 32, 16)])
def test_prefill_with_caches_matches_jax(mixtral, T, window, max_len):
    """Logits and every cache leaf; T > ring length takes the ring branch of
    _fill_kv_cache (first and last cases)."""
    jcfg, params, _, tparams = mixtral
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    tcfg = bridge.arch_from_reference(jcfg)
    toks = np.random.default_rng(T).integers(0, jcfg.vocab_size, (2, T)).astype(np.int32)
    lj, cj = JM.prefill_with_caches(jcfg, params, jnp.asarray(toks), max_len=max_len)
    before = wops.launches
    lt, ct = TM.prefill_with_caches(tcfg, tparams, _t(toks).long(), max_len=max_len)
    assert wops.launches == before
    _close(lt, lj)
    assert ct.keys() == cj.keys()
    for j in cj:
        assert ct[j].keys() == cj[j].keys()
        for name in cj[j]:
            assert tuple(ct[j][name].shape) == np.shape(cj[j][name])
            _close(ct[j][name], cj[j][name], msg=f"{j}/{name}")


def test_forward_and_decode_match_jax(mixtral):
    jcfg, params, tcfg, tparams = mixtral
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    fj, aj = JM.forward(jcfg, params, {"tokens": jnp.asarray(toks)})
    ft, at = TM.forward(tcfg, tparams, {"tokens": _t(toks).long()})
    _close(ft, fj)
    _close(at, aj)
    cj = JM.init_caches(jcfg, 2, 64, dtype=jnp.float32)
    ct = TM.init_caches(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    step = jax.jit(JM.decode_step, static_argnums=0)
    for t in range(40):
        pos = np.full((2,), t, np.int32)
        lj, cj = step(jcfg, params, jnp.asarray(toks[:, t]), jnp.asarray(pos), cj)
        lt = TM.decode_step(tcfg, tparams, _t(toks[:, t]).long(), _t(pos), ct)
        _close(lt, lj, msg=f"step {t}")
    # drop-free capacity: the last decode step equals the teacher-forced forward
    _close(lt, np.asarray(fj)[:, -1])


# --------------------------------------------------------------------------
# ServeEngine
# --------------------------------------------------------------------------

def _engines(jcfg, params, tparams, slots=2, max_len=128):
    return (JE.ServeEngine(jcfg, params, batch_slots=slots, max_len=max_len),
            TE.ServeEngine(bridge.arch_from_reference(jcfg), tparams, batch_slots=slots,
                           max_len=max_len, device="cpu"))


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


def _same_runs(ej, et, reqs_j, reqs_t):
    assert [r.generated for r in reqs_t] == [r.generated for r in reqs_j]
    assert all(r.done for r in reqs_t)
    assert dataclasses.asdict(et.stats) == dataclasses.asdict(ej.stats)


def test_serve_engine_submit_step_matches_jax(mixtral):
    """Three requests through two slots: the third refills a slot while the
    other is mid-prompt, so the slots run at staggered positions."""
    jcfg, params, _, tparams = mixtral
    ej, et = _engines(jcfg, params, tparams)
    prompts = _prompts(jcfg.vocab_size, (5, 9, 7), 6)
    news = (6, 4, 5)
    reqs_j = [JE.Request(rid=i, prompt=p, max_new_tokens=n)
              for i, (p, n) in enumerate(zip(prompts, news))]
    reqs_t = [TE.Request(rid=i, prompt=p, max_new_tokens=n)
              for i, (p, n) in enumerate(zip(prompts, news))]
    for rj, rt in zip(reqs_j, reqs_t):
        ej.submit(rj)
        et.submit(rt)
    ej.run_until_done()
    et.run_until_done()
    _same_runs(ej, et, reqs_j, reqs_t)


def test_serve_engine_staggered_slots_follow_position_zero_as_jax(mixtral):
    """Slot 1 starts 3 ticks after slot 0; as in the reference, softmax decode
    takes every slot's ring slot and validity from position[0]
    (attention.py:264-276), and the port reproduces it."""
    jcfg, params, _, tparams = mixtral
    ej, et = _engines(jcfg, params, tparams)
    p0, p1 = _prompts(jcfg.vocab_size, (12, 10), 7)
    outs = []
    for E, eng in ((JE, ej), (TE, et)):
        a = E.Request(rid=0, prompt=p0, max_new_tokens=30)
        b = E.Request(rid=1, prompt=p1, max_new_tokens=20)
        eng.submit(a)
        for _ in range(3):
            eng.step()
        eng.submit(b)
        eng.run_until_done()
        outs.append((a.generated, b.generated, list(eng.positions)))
    assert outs[1] == outs[0]


def test_serve_engine_prefill_batch_matches_jax(mixtral):
    """Prompts of 50 and 45 tokens: a 44-token prefill crosses the window."""
    jcfg, params, _, tparams = mixtral
    ej, et = _engines(jcfg, params, tparams)
    prompts = _prompts(jcfg.vocab_size, (50, 45), 8)
    reqs_j = [JE.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    reqs_t = [TE.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    ej.prefill_batch(reqs_j)
    et.prefill_batch(reqs_t)
    for name in ("k", "v"):
        _close(et.caches["b0"][name], ej.caches["b0"][name])
    assert et.caches["b0"]["k"].dtype == torch.float32
    ej.run_until_done()
    et.run_until_done()
    _same_runs(ej, et, reqs_j, reqs_t)


def test_serve_engine_step_on_chimera_dataplane_matches_jax():
    jcfg = j_smoke("chimera-dataplane")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(2))
    ej, et = _engines(jcfg, params, bridge.params_from_jax(_np(params), device="cpu"))
    prompts = _prompts(jcfg.vocab_size, (6, 4), 9)
    reqs_j = [JE.Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    reqs_t = [TE.Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    for rj, rt in zip(reqs_j, reqs_t):
        ej.submit(rj)
        et.submit(rt)
    ej.run_until_done()
    et.run_until_done()
    _same_runs(ej, et, reqs_j, reqs_t)
    # prefill_batch on the Chimera config, since chimera_prefill is ported
    ej, et = _engines(jcfg, params, bridge.params_from_jax(_np(params), device="cpu"))
    reqs_j = [JE.Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    reqs_t = [TE.Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    ej.prefill_batch(reqs_j)
    et.prefill_batch(reqs_t)
    ej.run_until_done()
    et.run_until_done()
    _same_runs(ej, et, reqs_j, reqs_t)


def test_serve_engine_temperature_sampling_is_seeded(mixtral):
    jcfg, _, tcfg, tparams = mixtral
    runs = []
    for _ in range(2):
        eng = TE.ServeEngine(tcfg, tparams, batch_slots=2, max_len=64, temperature=0.8,
                             seed=3, device="cpu")
        r = TE.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=8)
        eng.submit(r)
        eng.run_until_done()
        runs.append(r.generated)
    assert runs[0] == runs[1] and len(runs[0]) == 8
    assert all(0 <= t < tcfg.vocab_size for t in runs[0])


def test_serve_engine_refuses_what_it_does_not_serve(mixtral):
    _, _, tcfg, tparams = mixtral
    eng = TE.ServeEngine(tcfg, tparams, batch_slots=2, max_len=64, device="cpu")
    for call in (lambda: eng.ingest([1], [[1]]), lambda: eng.flow_scores(1),
                 lambda: eng.swap_tables()):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError, match="a parameter lies on meta"):
        TE.ServeEngine(tcfg, {"w": torch.zeros(2, device="meta")}, device="cpu")


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")


def test_serve_engine_without_device_raises_on_a_host_without_gpu(no_gpu, mixtral):
    _, _, tcfg, tparams = mixtral
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.ServeEngine(tcfg, tparams)


# --------------------------------------------------------------------------
# configs, bridge, ported-path guards
# --------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", ["mixtral-8x7b", "chimera-dataplane", "yi-9b", "qwen3-32b",
                                  "codeqwen1.5-7b", "moonshot-v1-16b-a3b", "chameleon-34b",
                                  "chimera-dataplane+codebook"])
def test_configs_match_jax(name):
    from repro.configs import get_config as j_get
    from repro.core.feature_maps import FeatureMapConfig as JFeatureMapConfig

    name, _, fm = name.partition("+")
    pairs = ((get_config(name), j_get(name)), (smoke_config(name), j_smoke(name)))
    if fm:  # the codebook map, with its size and fixed-point bits
        kw = dict(kind=fm, m=64, codebook_size=128, codebook_bits=8)
        pairs = tuple((dataclasses.replace(p, chimera=dataclasses.replace(
            p.chimera, feature_map=FeatureMapConfig(**kw))), dataclasses.replace(
            r, chimera=dataclasses.replace(r.chimera, feature_map=JFeatureMapConfig(**kw))))
            for p, r in pairs)
    for port, ref in pairs:
        assert port == bridge.arch_from_reference(ref)
        assert [port.layer_is_moe(i) for i in range(4)] == [ref.layer_is_moe(i) for i in range(4)]
    assert ArchConfig(name="x", family="dense", n_layers=1, d_model=8, n_heads=1,
                      n_kv_heads=1, d_ff=8, vocab_size=8).dtype == "bfloat16"


def test_bridge_carries_every_leaf_of_a_mixtral_tree(mixtral):
    jcfg, params, tcfg, tparams = mixtral
    want = dict(_leaves(_np(params)))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    assert ("blocks", "b0", "_moe") in got and ("blocks", "b0", "mlp", "wi") in got
    assert "chimera" not in tparams["blocks"]["b0"]["attn"]
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=str(path))
    own = TM.init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {p: tuple(t.shape) for p, t in _leaves(own)} == {
        p: tuple(t.shape) for p, t in got.items()}


@pytest.mark.parametrize("replace", [dict(family="audio", block_pattern=("attn", "mamba")),
                                     dict(family="audio", block_pattern=("mlstm",)),
                                     dict(family="audio")])
def test_unported_attention_paths_raise(replace):
    """Full-causal softmax and MLA are ported (tests/test_torch_mla.py), so
    are Mamba and xLSTM (tests/test_torch_ssm.py) and the enc-dec stack
    (tests/test_torch_encdec.py); what the serving path still refuses is an
    enc-dec config's prefill and LM engine, whatever its blocks, which the
    JAX package lacks too."""
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"), use_chimera=False, encoder_layers=2,
                              **replace)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="no encoder-decoder"):
        TM.prefill_with_caches(cfg, {}, toks, 8)
    with pytest.raises(NotImplementedError, match="no encoder-decoder"):
        TE.ServeEngine(cfg, {}, batch_slots=1, max_len=8, device="cpu")


# --------------------------------------------------------------------------
# bfloat16: the residual stream in cfg.dtype, products in float32
# --------------------------------------------------------------------------

# mean and max abs difference of logits (|logits| up to ~5) between the two
# packages in bf16: XLA and torch round bf16 at other places.  A port that
# kept the residual stream in fp32 misses both (mean ~8e-3, max ~0.2-0.6).
BF16_MEAN, BF16_MAX = 5e-3, 0.1


@pytest.mark.parametrize("name", ["mixtral-8x7b", "chimera-dataplane"])
def test_bfloat16_config_matches_jax(name):
    rep = dict(use_chimera=False, sliding_window=WINDOW) if name == "mixtral-8x7b" else {}
    jcfg = dataclasses.replace(j_smoke(name), dtype="bfloat16", **rep)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(1))
    tcfg = bridge.arch_from_reference(jcfg)
    tparams = bridge.params_from_jax(_np(params), device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 96)).astype(np.int32)
    fj, _ = JM.forward(jcfg, params, {"tokens": jnp.asarray(toks)})
    ft, _ = TM.forward(tcfg, tparams, {"tokens": _t(toks).long()})
    assert ft.dtype == torch.float32  # bf16 activations times fp32 weights
    diff = np.abs(ft.float().numpy() - np.asarray(fj, np.float32))
    assert diff.mean() < BF16_MEAN and diff.max() < BF16_MAX, (diff.mean(), diff.max())
    # one decode step: the hidden state stays in the residual stream's dtype
    cj = JM.init_caches(jcfg, 2, 128, dtype=jnp.float32)
    ct = TM.init_caches(tcfg, 2, 128, dtype=torch.float32, device="cpu")
    pos = np.zeros((2,), np.int32)
    hj, _ = JM.decode_hidden_step(jcfg, params, jnp.asarray(toks[:, 0]), jnp.asarray(pos), cj)
    ht = TM.decode_hidden_step(tcfg, tparams, _t(toks[:, 0]).long(), _t(pos), ct)
    assert hj.dtype == jnp.bfloat16 and ht.dtype == torch.bfloat16
    _close(ht, hj, rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_window_attention_kernel_matches_plain_on_card(cuda):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    chip_smoke.check_window(timed=False)
    # an input that needs a gradient goes through the autograd Function: the
    # forward kernel with lse, then the three backward kernels
    q = torch.zeros((1, 2, 8, 64), device=cuda, requires_grad=True)
    kv = torch.zeros((1, 1, 8, 64), device=cuda)
    before = wops.bwd_launches
    wops.sliding_window_attention(q, kv, kv, 4).sum().backward()
    assert wops.bwd_launches == before + 3 and torch.equal(q.grad, torch.zeros_like(q))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("T,W,dtype,H,Hkv", [
    (200, 48, "float32", 4, 1),     # ragged T, W below a tile
    (200, 300, "float32", 4, 1),    # W > T
    (77, 13, "float32", 2, 2),
    (200, 48, "bfloat16", 4, 1),
    (200, 48, "float32", 8, 4),     # 4 kv-heads
    (128, 64, "float32", 4, 2),     # a tile boundary
    (200, 128, "float32", 4, 2),    # W a multiple of the 64-key tile, T not
    (200, 128, "bfloat16", 8, 4),
])
def test_window_attention_kernel_edge_shapes_on_card(cuda, T, W, dtype, H, Hkv, d):
    """The tensor-core kernel against the plain version: fp32 within ATOL +
    RTOL * |ref|, bf16 within 8e-3 (chip_smoke.check_window_edge)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    chip_smoke.check_window_edge(T, W, dtype, H, Hkv, d, seed=T + W + d)
