"""Chimera attention trained by the port, against the JAX package, on the CPU.

* ``chimera_attention_bwd_plain`` (the chunked backward: the CPU route of
  ``_Partials.backward`` and the yardstick of ``csrc/chimera_attention_bwd.cu``)
  and its wrapper ``chimera_attention_bwd_bh`` against ``jax.vjp`` of the
  JAX op ``repro.kernels.chimera_attention.ops.chimera_attention_partials``
  with ``backend="reference"``, whose ``custom_vjp`` backward (``_bwd``
  :52-62) is what the kernel replaces: L 16 and 32, T = L and 4L, Gq 1 and
  2, d = dv and d != dv, every (use_local, use_stream) the forward takes.
* The same function against autograd of the dense
  ``chimera_attention_partials_plain`` in float64.
* The port's ``chimera_attention`` (n_global 0 and 8, Gq 2) differentiated
  with respect to q, k and v against ``jax.vjp`` of the JAX
  ``chimera_attention`` on its default ``use_pallas=False`` scan path.
* ``make_train_step`` on the smoke Mixtral-8x7B and MiniCPM3-4B (MLA)
  Chimera variants, the configs' default, against JAX's: loss, ``nll``,
  ``aux``, every gradient leaf, gradient norm and each parameter leaf's
  update in norm; 5 ``Trainer`` steps against a live JAX ``Trainer`` from
  the same parameters.

Tolerances: float32 on both sides with other summation orders: the
partials' gradients within rtol 1e-4 and 1e-5 times the largest entry of
JAX's gradient (RTOL, ATOL_REL: the stream tier sums over whole later
chunks); float64 within 1e-10 (EXACT); losses and metrics of the train step
within rtol 1e-4 and atol 1e-5 (RTOL, ATOL), its gradient leaves within
rtol 1e-4 and 1e-5 times the leaf's largest entry; the Trainers' per-step
losses within rtol 1e-5 (LOSS_RTOL), as ``tests/test_torch_trainer.py``
holds them; each leaf's parameter update within 1e-3 of JAX's in norm
(UPDATE_RTOL: AdamW amplifies the rounding of gradients near eps).  With
``dtype="bfloat16"`` (the zoo configs' compute type) the loss within 4e-3
(BF16_LOSS_RTOL, about one bf16 rounding: the packages round at other
places) and every gradient leaf finite.  The card's checks of the same functions are in
``tests/test_torch_chimera_training_card.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import chimera_attention as JCA
from repro.core.feature_maps import FeatureMapConfig as JFeatureMapConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.kernels.chimera_attention import ops as jops
from repro.models import model as JM
from repro.optim.optimizer import AdamWConfig as JAdamWConfig
from repro.optim.optimizer import init_optimizer as j_init_optimizer
from repro.train.train_step import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.core import chimera_attention as TCA
from repro_torch.core.feature_maps import FeatureMapConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.kernels.chimera_attention import ops as cops
from repro_torch.models import model as TM
from repro_torch.optim.optimizer import AdamWConfig, init_optimizer
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.train_step import make_train_step, value_and_grad

RTOL, ATOL, ATOL_REL = 1e-4, 1e-5, 1e-5
EXACT = 1e-10
LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-3
BF16_LOSS_RTOL = 4e-3  # bf16 compute: the two packages round at other places (2^-8 relative)
SMOKE_T = 32  # the train steps' sequence: two chunks of the smoke configs' L 16
NAMES = ("q", "k", "v", "phi_q", "phi_k")
MODES = [(True, True), (True, False), (False, True)]
MODE_IDS = ["local+stream", "local", "stream"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's and XLA's CPU thread pools contend in one process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _close_grad(got, want, msg="", rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL_REL * np.abs(want).max() + 1e-30,
                               err_msg=msg)


def _inputs(seed, B=2, Hkv=2, Gq=1, T=64, d=16, dv=16, m=32, dtype=np.float32):
    """Normalized q, k (norm 2, as the callers pass them), v, positive
    features, and the partials' gradients g_num, g_den."""
    rng = np.random.default_rng(seed)

    def unit(*s):
        x = rng.standard_normal(s)
        return (2 * x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(dtype)

    pos = lambda *s: (rng.random(s) / np.sqrt(m)).astype(dtype)  # noqa: E731
    return [unit(B, Hkv, Gq, T, d), unit(B, Hkv, T, d),
            rng.standard_normal((B, Hkv, T, dv)).astype(dtype),
            pos(B, Hkv, Gq, T, m), pos(B, Hkv, T, m),
            rng.standard_normal((B, Hkv, Gq, T, dv)).astype(dtype),
            rng.standard_normal((B, Hkv, Gq, T)).astype(dtype)]


# --------------------------------------------------------------------------
# the partials' backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("d,dv", [(16, 16), (24, 16)])
@pytest.mark.parametrize("Gq", [1, 2])
@pytest.mark.parametrize("L,n_chunks", [(16, 1), (16, 4), (32, 1), (32, 4)])
def test_bwd_plain_matches_jax_vjp(L, n_chunks, Gq, d, dv, mode):
    T = L * n_chunks
    xs = _inputs(seed=L + T + Gq + d, Gq=Gq, T=T, d=d, dv=dv)
    _, vjp = jax.vjp(lambda *a: jops.chimera_attention_partials(*a, L, *mode, "reference"),
                     *map(jnp.asarray, xs[:5]))
    want = vjp((jnp.asarray(xs[5]), jnp.asarray(xs[6])))
    ts = [torch.from_numpy(x) for x in xs]
    got = cops.chimera_attention_bwd_plain(*ts, L, *mode)
    # the wrapper on the flattened layout: the CPU route runs the plain version
    flat = cops.chimera_attention_bwd_bh(*(t.flatten(0, 1) for t in ts), chunk_size=L,
                                         use_local=mode[0], use_stream=mode[1])
    for name, g, f, w in zip(NAMES, got, flat, want):
        assert g.dtype == f.dtype == torch.float32 and g.shape == w.shape
        _close_grad(g, w, msg=name)
        _close_grad(f, np.asarray(w).reshape(f.shape), msg=f"{name}, the wrapper")
    assert cops.launches == cops.bwd_launches == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("L,T,Gq,d,dv,m", [(16, 64, 2, 16, 32, 16), (32, 96, 3, 24, 16, 48),
                                           (16, 16, 1, 8, 16, 32)])
def test_bwd_plain_matches_dense_autograd_in_float64(L, T, Gq, d, dv, m, mode):
    xs = [torch.from_numpy(x) for x in _inputs(seed=T + m, Gq=Gq, T=T, d=d, dv=dv, m=m,
                                               dtype=np.float64)]
    leaves = [x.clone().requires_grad_(True) for x in xs[:5]]
    num, den = cops.chimera_attention_partials_plain(*leaves, L, *mode)
    want = torch.autograd.grad((num, den), leaves, (xs[5], xs[6]), allow_unused=True)
    got = cops.chimera_attention_bwd_plain(*xs, L, *mode)
    for name, g, w in zip(NAMES, got, want):
        w = torch.zeros_like(g) if w is None else w
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=EXACT, atol=EXACT, err_msg=name)


def test_function_backward_runs_the_chunked_backward_in_each_input_type():
    """``_Partials.backward`` on CPU tensors: the chunked plain backward,
    grads in each input's type (bfloat16 inputs computed in float32)."""
    xs = [torch.from_numpy(x) for x in _inputs(seed=3, Gq=2, T=48)]
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [x.to(dtype).requires_grad_(True) for x in xs[:5]]
        num, den = cops.chimera_attention_partials(*leaves, 16)
        gs = (xs[5].to(num.dtype), xs[6].to(den.dtype))
        got = torch.autograd.grad((num, den), leaves, gs)
        want = cops.chimera_attention_bwd_bh(
            *(x.detach().flatten(0, 1) for x in (*leaves, *gs)), chunk_size=16)
        for name, g, w, x in zip(NAMES, got, want, leaves):
            assert g.dtype == x.dtype and w.dtype == torch.float32, name
            assert torch.equal(g, w.reshape(g.shape).to(dtype)), name
    assert cops.launches == cops.bwd_launches == 0


def test_bwd_wrapper_checks_shapes_devices_and_counts_launches():
    ts = [torch.from_numpy(x).flatten(0, 1) for x in _inputs(seed=0, Gq=2)]
    with pytest.raises(ValueError, match="g_den has shape"):
        cops.chimera_attention_bwd_bh(*ts[:6], ts[6][:, :, :-1], chunk_size=16)
    with pytest.raises(ValueError, match="divisible"):
        cops.chimera_attention_bwd_bh(*ts, chunk_size=24)
    meta = [torch.empty(t.shape, device="meta") for t in ts]
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        cops.chimera_attention_bwd_bh(*meta, chunk_size=16)
    assert cops.bwd_launches == 0
    # launches of one call: dK/dV and dQ, the fold with a carried state, the
    # prefix with more than two chunks
    assert [cops.bwd_kernel_launches(T, 256) for T in (256, 512, 8192)] == [2, 3, 4]
    assert cops.bwd_kernel_launches(8192, 256, use_stream=False) == 2


# --------------------------------------------------------------------------
# the backward in the training step's types (all seven inputs bf16)
# --------------------------------------------------------------------------

def _mixed(xs):
    """q, k and v rounded to bfloat16, the features and gradients float32."""
    return [torch.from_numpy(x).to(torch.bfloat16) if i < 3 else torch.from_numpy(x)
            for i, x in enumerate(xs)]


def _bf16(xs):
    """All seven inputs rounded to bfloat16, as a bfloat16 model's training
    step passes them."""
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("L,n_chunks,Gq,d,dv,m", [(16, 4, 2, 24, 16, 32), (32, 3, 1, 16, 32, 16)])
def test_bwd_wrapper_in_the_training_mix_matches_jax_vjp(L, n_chunks, Gq, d, dv, m, mode):
    """``chimera_attention_bwd_bh`` on CPU tensors with all seven inputs in
    bf16, as the training step passes them, against ``jax.vjp`` of the JAX
    reference on the same bf16-rounded values."""
    T = L * n_chunks
    xs = _bf16(_inputs(seed=L + T + m, Gq=Gq, T=T, d=d, dv=dv, m=m))
    _, vjp = jax.vjp(lambda *a: jops.chimera_attention_partials(*a, L, *mode, "reference"),
                     *(jnp.asarray(x.float().numpy()) for x in xs[:5]))
    want = vjp((jnp.asarray(xs[5].float().numpy()), jnp.asarray(xs[6].float().numpy())))
    assert cops.bwd_route(*xs[:6]) == "bf16"
    got = cops.chimera_attention_bwd_bh(*(x.flatten(0, 1) for x in xs), chunk_size=L,
                                        use_local=mode[0], use_stream=mode[1])
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        _close_grad(g, np.asarray(w).reshape(g.shape), msg=name)
    assert cops.bwd_launches == cops.bwd_launches_bf16 == 0  # CPU tensors launch nothing


def test_function_backward_in_the_training_mix_returns_each_input_type():
    """``_Partials.backward`` with bf16 q, k, v and fp32 features (the
    features' type of a bf16 model whose feature map keeps fp32 weights;
    the fp32 route on the card): bf16 gradients for q, k and v, fp32 ones
    for the features, each the wrapper's float32 gradient in its input's
    type."""
    xs = _mixed(_inputs(seed=4, Gq=2, T=48))
    leaves = [x.clone().requires_grad_(True) for x in xs[:5]]
    num, den = cops.chimera_attention_partials(*leaves, 16)
    assert num.dtype == den.dtype == torch.float32  # the features' type wins, as in jnp
    got = torch.autograd.grad((num, den), leaves, (xs[5], xs[6]))
    want = cops.chimera_attention_bwd_bh(*(x.flatten(0, 1) for x in xs), chunk_size=16)
    for name, g, w, x in zip(NAMES, got, want, leaves):
        assert g.dtype == x.dtype == (torch.bfloat16 if name in ("q", "k", "v") else torch.float32)
        assert torch.equal(g, w.reshape(g.shape).to(g.dtype)), name


def test_bwd_route_by_input_type_and_what_it_refuses():
    ts = [torch.from_numpy(x).flatten(0, 1) for x in _inputs(seed=6, Gq=2, T=32)]
    bf = [t.bfloat16() for t in ts]
    assert cops.bwd_route(*bf[:6]) == "bf16"  # g_den's type does not choose
    assert cops.bwd_route(*ts[:6]) == "fp32"
    # the first six all bf16, or every input widened to fp32
    for i in range(6):
        assert cops.bwd_route(*bf[:i], ts[i], *bf[i + 1:6]) == "fp32", i
    # a mix is widened, which is exact
    got = cops.chimera_attention_bwd_bh(*bf[:3], bf[3], ts[4], bf[5], bf[6], chunk_size=16)
    wide = cops.chimera_attention_bwd_bh(*(t.float() for t in (*bf[:3], bf[3], ts[4], bf[5],
                                                               bf[6])), chunk_size=16)
    assert all(torch.equal(a, b) for a, b in zip(got, wide))
    # other types raise
    with pytest.raises(TypeError, match="must be one of"):
        cops.chimera_attention_bwd_bh(ts[0].half(), *ts[1:], chunk_size=16)
    with pytest.raises(TypeError, match="must be one of"):
        cops.chimera_attention_bwd_bh(*bf[:3], ts[3].double(), *ts[4:], chunk_size=16)
    with pytest.raises(ValueError, match="g_num must be one of"):
        cops.chimera_attention_bwd_bh(*bf[:5], ts[5].double(), ts[6], chunk_size=16)
    # launches of one call on the bf16 route: the fold and the prefix with a
    # carried state, the stream tier's kernel, dK/dV and dQ
    assert [cops.bwd_kernel_launches(T, 256, route="bf16") for T in (256, 512, 8192)] == [3, 5, 5]
    assert cops.bwd_kernel_launches(8192, 256, use_local=False, route="bf16") == 3
    assert cops.bwd_kernel_launches(8192, 256, use_stream=False, route="bf16") == 3
    assert cops.bwd_kernel_launches(8192, 256, False, False, route="bf16") == 1
    with pytest.raises(ValueError, match="no route"):
        cops.bwd_kernel_launches(8192, 256, route="tf32")
    assert cops.bwd_launches_fp32 == cops.bwd_launches_bf16 == 0


# the card's tolerance for the backward kernels (chip_smoke.py's
# CHIMERA_BWD_ATOL, CHIMERA_BWD_RTOL) against float64 on the same inputs
CARD_ATOL_REL, CARD_RTOL = 1e-5, 1e-4


def _terms(x, n):
    """x (float32 values) as n bf16 terms, in float64: hi = bf16(x), lo =
    bf16(x - hi)."""
    out, r = [], x.double()
    for _ in range(n):
        t = r.float().bfloat16().double()
        out.append(t)
        r = r - t
    return out


def _prod(eq, a, b):
    """sum of the term products a_i b_j with i + j < max(len(a), len(b)):
    one term by one, or hi hi + hi lo + lo hi of two split operands."""
    keep = max(len(a), len(b))
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(a) for j, y in enumerate(b)
               if i + j < keep)


def _split_model(xs, L, use_local, use_stream, n):
    """The bf16 route's arithmetic in float64: the bf16 inputs one term
    each (_terms of a bf16 value is that value and zeros), every value
    formed in fp32 (the state S, R and P, dS) as ``n`` bf16 terms, the
    products as _prod (the folds' too, phi against v or g_num), the
    intermediates rounded to fp32 where the kernels round them; Z and R_z
    summed exactly."""
    q, k, v, pq, pk, gn, gd = (x.double() for x in xs)
    B, H, Gq, T, d = q.shape
    dv, m, c = v.shape[-1], pq.shape[-1], T // L
    f32 = lambda t: t.float().double()  # noqa: E731
    qc, kc, vc = q.reshape(B, H, Gq, c, L, d), k.reshape(B, H, c, L, d), v.reshape(B, H, c, L, dv)
    pqc, pkc = pq.reshape(B, H, Gq, c, L, m), pk.reshape(B, H, c, L, m)
    gnc, gdc = gn.reshape(B, H, Gq, c, L, dv), gd.reshape(B, H, Gq, c, L)
    G = _terms(gnc, n)
    dq, dk, dvv = torch.zeros_like(qc), torch.zeros_like(kc), torch.zeros_like(vc)
    dpq, dpk = torch.zeros_like(pqc), torch.zeros_like(pkc)
    if use_local:
        scale = 1 / np.sqrt(d)
        causal = torch.tril(torch.ones((L, L), dtype=torch.float64))
        p = f32(torch.exp(f32(torch.einsum("bhgcid,bhcjd->bhgcij", qc, kc)) * scale)) * causal
        dp = f32(_prod("bhgcie,bhcje->bhgcij", G, [vc]))
        ds = f32(p * (dp + gdc[..., None]) * scale)
        P, DS = _terms(p, n), _terms(ds, n)
        dq = _prod("bhgcij,bhcjd->bhgcid", DS, [kc])
        dk = _prod("bhgcij,bhgcid->bhcjd", DS, [qc])
        dvv = _prod("bhgcij,bhgcie->bhcje", P, G)
    if use_stream and c > 1:
        PK = _terms(pkc, n)
        S = f32(cops._exclusive_prefix(_prod("bhcjm,bhcje->bhcme", PK, [vc]), 2))
        Z = cops._exclusive_prefix(torch.sum(pkc, dim=3), 2)
        R = f32(cops._exclusive_prefix(_prod("bhgcim,bhgcie->bhcme", _terms(pqc, n), G), 2,
                                       reverse=True))
        Rz = cops._exclusive_prefix(torch.einsum("bhgcim,bhgci->bhcm", pqc, gdc), 2, reverse=True)
        SS, RR = _terms(S, n), _terms(R, n)
        dpq = _prod("bhgcie,bhcme->bhgcim", G, SS) + gdc[..., None] * Z[:, :, None, :, None]
        dpk = _prod("bhcje,bhcme->bhcjm", [vc], RR) + Rz[:, :, :, None]
        dvv = dvv + _prod("bhcjm,bhcme->bhcje", PK, RR)
    return [g.reshape(x.shape) for g, x in zip((dq, dk, dvv, dpq, dpk), xs[:5])]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("L,T,Gq,d,dv,m", [(16, 64, 2, 16, 16, 32), (32, 128, 1, 24, 32, 48),
                                           (64, 256, 2, 40, 64, 16)])
def test_bf16_split_model_holds_the_card_tolerance(L, T, Gq, d, dv, m, mode):
    """Why the bf16 route takes each value it forms in fp32 (P, dS, the
    state and R) as two bf16 terms: the model of its arithmetic, from all
    seven inputs in bf16 as the training step passes them, holds
    chip_smoke.py's tolerance for the backward kernels (CARD_ATOL_REL x
    max|ref| + CARD_RTOL x |ref| against float64) with two terms, and one
    term alone does not."""
    xs = [x.double() for x in _bf16(_inputs(seed=T + m, Gq=Gq, T=T, d=d, dv=dv, m=m))]
    want = cops.chimera_attention_bwd_plain(*xs, L, *mode)
    worst = {}
    for n in (1, 2):
        got = _split_model(xs, L, *mode, n)
        worst[n] = max(float(((g - w).abs() / (CARD_ATOL_REL * w.abs().max() + CARD_RTOL * w.abs()
                                                + 1e-300)).max()) for g, w in zip(got, want))
    assert worst[2] <= 0.5, worst  # half the tolerance left for the kernels' fp32 sums
    assert worst[1] > 1, worst


# --------------------------------------------------------------------------
# core.chimera_attention.chimera_attention against the JAX scan path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_global", [0, 8])
def test_chimera_attention_grads_match_jax_scan(n_global):
    L, B, H, Hkv, T, d = 16, 2, 4, 2, 64, 16
    cfg_j = JCA.ChimeraAttentionConfig(feature_map=JFeatureMapConfig(kind="exp_prf", m=32),
                                       chunk_size=L, n_global=n_global, use_pallas=False)
    cfg_t = TCA.ChimeraAttentionConfig(feature_map=FeatureMapConfig(kind="exp_prf", m=32),
                                       chunk_size=L, n_global=n_global)
    params = JCA.init_chimera_attention(cfg_j, Hkv, d, d, jax.random.PRNGKey(11))
    rng = np.random.default_rng(20 + n_global)
    q, k, v, ct = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, H, T, d), (B, Hkv, T, d), (B, Hkv, T, d), (B, H, T, d)))
    out_j, vjp = jax.vjp(lambda *a: JCA.chimera_attention(cfg_j, params, *a),
                         *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(ct))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = TCA.chimera_attention(cfg_t, bridge.params_from_jax(_np(params), device="cpu"), *xs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    got = torch.autograd.grad(out, xs, torch.from_numpy(ct))
    for name, g, w in zip(("q", "k", "v"), got, want):
        _close_grad(g, w, msg=name)


# --------------------------------------------------------------------------
# the train step and the Trainer against JAX
# --------------------------------------------------------------------------

CHIMERA_SMOKE = ["mixtral-8x7b", "minicpm3-4b"]


def _close_updates(got, want, start):
    """Each leaf's update (new - start) within UPDATE_RTOL of JAX's, in norm
    (elementwise, AdamW turns a rounding of a gradient near eps into a
    change of the step)."""
    start, want = dict(_leaves(_np(start))), dict(_leaves(_np(want)))
    for path, p in _leaves(got):
        d_got, d_want = p.detach().numpy() - start[path], want[path] - start[path]
        err = np.linalg.norm(d_got - d_want)
        assert err <= UPDATE_RTOL * np.linalg.norm(d_want) + 1e-12, (path, err)


@pytest.mark.parametrize("name", CHIMERA_SMOKE)
def test_train_step_matches_jax(name):
    jcfg = j_smoke(name)
    assert jcfg.use_chimera and not jcfg.chimera.use_pallas  # the default scan path
    tcfg = bridge.arch_from_reference(jcfg)
    jparams, _ = JM.init_model(jcfg, jax.random.PRNGKey(13))
    tparams = bridge.params_from_jax(_np(jparams), device="cpu")
    toks = np.random.default_rng(14).integers(0, jcfg.vocab_size, (2, SMOKE_T + 1))
    tok, lab = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tbatch = {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long()}

    (jl, jm), jg = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jbatch), has_aux=True)(
        jparams)
    (tl, tm), tg = value_and_grad(lambda p: TM.loss_fn(tcfg, p, tbatch), tparams)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    for k in ("nll", "aux", "zloss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    want = dict(_leaves(_np(jg)))
    got = dict(_leaves(tg))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        _close_grad(g, want[path], msg=f"gradient {path}")

    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jnew, _, jmet = j_make_train_step(jcfg, JAdamWConfig(**opt))(
        jparams, j_init_optimizer(jparams), jbatch)
    tnew, _, tmet = make_train_step(tcfg, AdamWConfig(**opt))(
        tparams, init_optimizer(tparams), tbatch)
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    _close_updates(tnew, jnew, jparams)


@pytest.mark.parametrize("name", CHIMERA_SMOKE)
def test_bf16_train_step_matches_jax(name):
    """The smoke configs in bfloat16 compute, as the zoo's full-width
    configs train: the float32 TCAM mask against bfloat16 values and
    features promotes as jnp does, and the backward runs on bfloat16 saved
    inputs (cast to float32 by the wrapper)."""
    from repro.train.train_step import cast_for_compute as j_cast
    from repro_torch.train.train_step import cast_for_compute

    jcfg = dataclasses.replace(j_smoke(name), dtype="bfloat16")
    tcfg = bridge.arch_from_reference(jcfg)
    jparams, _ = JM.init_model(jcfg, jax.random.PRNGKey(16))
    tparams = bridge.params_from_jax(_np(jparams), device="cpu")
    toks = np.random.default_rng(17).integers(0, jcfg.vocab_size, (2, SMOKE_T + 1))
    tok, lab = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    jl, _ = JM.loss_fn(jcfg, j_cast(jcfg, jparams),
                       {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    batch = {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long()}
    (tl, _), tg = value_and_grad(lambda p: TM.loss_fn(tcfg, cast_for_compute(tcfg, p), batch),
                                 tparams)
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_LOSS_RTOL)
    got = dict(_leaves(tg))
    assert sorted(got) == sorted(dict(_leaves(_np(jparams))))
    for path, g in got.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), path


@pytest.mark.parametrize("name", CHIMERA_SMOKE)
def test_trainer_matches_a_live_jax_trainer(tmp_path, name):
    """5 steps of each package's Trainer from the JAX Trainer's parameters
    and optimizer state, on the same token stream: per-step losses,
    ``nll``, ``aux`` and gradient norms within LOSS_RTOL."""
    jcfg = j_smoke(name)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    jtr = JTrainer(jcfg, JTrainerConfig(total_steps=5, log_every=1, ckpt_every=100,
                                        ckpt_dir=str(tmp_path / "jax")),
                   JTokenStream(jcfg.vocab_size, 4, SMOKE_T + 1, seed=15),
                   opt_cfg=JAdamWConfig(**opt))
    start = (_np(jtr.params), _np(jtr.opt_state))
    out_j = jtr.run()
    tr = Trainer(bridge.arch_from_reference(jcfg),
                 TrainerConfig(total_steps=5, log_every=1, ckpt_every=100,
                               ckpt_dir=str(tmp_path / "port")),
                 TokenStream(jcfg.vocab_size, 4, SMOKE_T + 1, seed=15),
                 opt_cfg=AdamWConfig(**opt), device="cpu",
                 params=bridge.params_from_jax(start[0], device="cpu"))
    tr.opt_state = bridge.params_from_jax(start[1], device="cpu")
    out = tr.run()
    assert [r["step"] for r in out["log"]] == [r["step"] for r in out_j["log"]] == [1, 2, 3, 4, 5]
    for k in ("loss", "nll", "aux", "grad_norm"):
        np.testing.assert_allclose([r[k] for r in out["log"]], [r[k] for r in out_j["log"]],
                                   rtol=LOSS_RTOL, err_msg=k)
    _close_updates(tr.params, jtr.params, start[0])
    assert cops.launches == cops.bwd_launches == 0
