"""Softmax attention trained by the port, against the JAX package, on the CPU.

* The window op's gradients: the port's differentiable
  ``sliding_window_attention`` (autograd through the plain version, the CPU
  route) and the backward kernels' function (``window_attention_lse_plain``
  for the forward's lse, then ``window_attention_bwd_plain`` on the
  kernels' flattened layout) against ``jax.vjp`` of the JAX op with
  ``backend="reference"``, whose ``custom_vjp`` backward
  (``repro/kernels/window_attention/ops.py:37-40``) is what the port's
  ``csrc/window_attention_bwd.cu`` replaces.  JAX takes K and V repeated to
  the query heads, so its dk and dv are summed over each kv-head's heads.
* ``window_attention_bwd_plain`` against autograd of
  ``window_attention_plain``.
* The bf16 backward kernels' rounding (``csrc/window_attention_bwd.cu``: P
  and dS fed to the tensor cores as bf16 hi + lo) emulated in torch, held
  to ``window_attention_bwd_plain`` in float64 under ``chip_smoke``'s bf16
  rule at its edge shapes; one rounding of P and dS is beyond that rule.
* ``remat="full"`` against ``"none"``: the same loss and gradients, and each
  layer group's forward run twice.
* ``make_train_step`` on the smoke Mixtral-8x7B (softmax, window cut to 8 at
  T 32) and the smoke MiniCPM3-4B (softmax MLA) against JAX's: loss,
  ``nll``, ``aux``, gradient norm and every gradient leaf, and each
  parameter leaf's update in norm; 5 ``Trainer`` steps against a live JAX
  ``Trainer`` from the same parameters.

Tolerances: float32 on both sides with other summation orders, rtol 1e-4
and atol 1e-5 (RTOL, ATOL; float64 within 1e-10); the Trainers' per-step
losses within rtol 1e-5 (LOSS_RTOL), as ``tests/test_torch_trainer.py``
holds them; each leaf's parameter update within 1e-3 of JAX's in norm
(UPDATE_RTOL: AdamW amplifies the rounding of gradients near eps).  The card's checks of the same functions are in
``tests/test_torch_softmax_training_card.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.pipeline import TokenStream as JTokenStream
from repro.kernels.window_attention import ops as JW
from repro.models import model as JM
from repro.optim.optimizer import AdamWConfig as JAdamWConfig
from repro.optim.optimizer import init_optimizer as j_init_optimizer
from repro.train.train_step import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.kernels.window_attention import ops as wops
from repro_torch.models import model as TM
from repro_torch.optim.optimizer import AdamWConfig, init_optimizer, tree_flatten
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.train_step import make_train_step, value_and_grad

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-3  # each parameter leaf's update, in norm (see _close_updates)
T = 24  # the window op's tests
SMOKE_T, SMOKE_WINDOW = 32, 8  # the train steps': the window cuts the band


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


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _close_updates(got, want, start):
    """Each leaf's update (new - start) within UPDATE_RTOL of JAX's, in norm.
    Elementwise the updates are not comparable at fp32 tolerances: AdamW
    moves an element by about lr * g / (|g| + eps), which for |g| near eps
    turns a rounding of g into a change of the step (seen: 1 element in
    32768 off by 3e-5 at lr 1e-3)."""
    start, want = dict(_leaves(_np(start))), dict(_leaves(_np(want)))
    for path, p in _leaves(got):
        d_got, d_want = p.detach().numpy() - start[path], want[path] - start[path]
        err = np.linalg.norm(d_got - d_want)
        assert err <= UPDATE_RTOL * np.linalg.norm(d_want) + 1e-12, (path, err)


# --------------------------------------------------------------------------
# the window op's backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,dv", [(16, 16), (32, 32), (24, 16)])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("W", [9, T, T + 5, 1], ids=["W<T", "W=T", "W>T", "W=1"])
def test_window_attention_grads_match_jax_vjp(W, G, d, dv):
    B, H = 2, 4
    Hkv = H // G
    rng = np.random.default_rng(100 * W + 10 * G + d)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, H, T, d), (B, Hkv, T, d), (B, Hkv, T, dv), (B, H, T, dv)))
    out_j, vjp = jax.vjp(
        lambda q, k, v: JW.sliding_window_attention(q, k, v, W, backend="reference"),
        jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=1)), jnp.asarray(np.repeat(v, G, axis=1)))
    dq_j, dk_j, dv_j = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    want = (dq_j, dk_j.reshape(B, Hkv, G, T, d).sum(2), dv_j.reshape(B, Hkv, G, T, dv).sum(2))

    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = wops.sliding_window_attention(*xs, W)
    _close(out, out_j, msg="output")
    got = torch.autograd.grad(out, xs, torch.from_numpy(do))
    # the kernels' function on their flattened layout, K and V per kv-head
    qf, dof = (torch.from_numpy(a).reshape(B * H, T, -1) for a in (q, do))
    kf, vf = (torch.from_numpy(a).reshape(B * Hkv, T, -1) for a in (k, v))
    lse = wops.window_attention_lse_plain(qf, kf.repeat_interleave(G, 0), W)
    assert lse.shape == (B * H, T) and lse.dtype == torch.float32
    o = out.detach().reshape(B * H, T, dv)
    kernels_fn = wops.window_attention_bwd_plain(qf, kf, vf, o, lse, dof, W)
    kernels_fn = (kernels_fn[0].reshape(B, H, T, d), kernels_fn[1].reshape(B, Hkv, T, d),
                  kernels_fn[2].reshape(B, Hkv, T, dv))
    for name, a, b, w in zip(("dq", "dk", "dv"), got, kernels_fn, want):
        _close(a, w, msg=f"{name}, autograd of the wrapper")
        _close(b, w, msg=f"{name}, the backward kernels' function")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("T_,W,G", [(40, 7, 1), (40, 40, 2), (33, 64, 4), (17, 1, 2)])
def test_window_attention_bwd_plain_matches_autograd(T_, W, G, dtype):
    """On the flattened layout, K and V per kv-head: the plain backward
    against autograd through the plain forward with K and V repeated."""
    BH, d, dv = 8, 16, 24
    g = torch.Generator().manual_seed(T_ + W + G)
    q, do = (torch.randn(s, generator=g, dtype=dtype) for s in ((BH, T_, d), (BH, T_, dv)))
    k, v = (torch.randn(s, generator=g, dtype=dtype) for s in ((BH // G, T_, d),
                                                               (BH // G, T_, dv)))
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = wops.window_attention_plain(xs[0], xs[1].repeat_interleave(G, 0),
                                    xs[2].repeat_interleave(G, 0), W)
    want = torch.autograd.grad(o, xs, do)
    lse = wops.window_attention_lse_plain(q, k.repeat_interleave(G, 0), W)
    got = wops.window_attention_bwd_plain(q, k, v, o.detach(), lse, do, W)
    tol = dict(rtol=1e-10, atol=1e-10) if dtype == torch.float64 else dict(rtol=RTOL, atol=ATOL)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape
        _close(a, w, msg=name, **tol)


def test_window_attention_backward_refuses_mismatched_shapes():
    q = torch.zeros((1, 2, 8, 16))
    kv = torch.zeros((1, 1, 8, 16))
    o, lse = torch.zeros_like(q), torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="do not fit"):
        wops.window_attention_bwd(q, kv, kv, o, lse[:, :, :4], o, 4)
    # the Function's two halves launch kernels and have no CPU route
    with pytest.raises(RuntimeError, match="no kernel for device"):
        wops.window_attention_fwd(q, kv, kv, 4)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        wops.window_attention_bwd(q, kv, kv, o, lse, o, 4)
    assert wops.contract(d=16, dv=16, H=2, Hkv=1, window=4) is None
    assert "not in" in wops.contract(d=256, dv=256, H=2, Hkv=1, window=4)


# --------------------------------------------------------------------------
# the bf16 backward kernels' arithmetic, emulated
# --------------------------------------------------------------------------

N_WINDOW_EDGES = 13  # len(chip_smoke.WINDOW_EDGES)
# (T, W, H, Hkv) beside the edge shapes: G 4 over a 64-row tile boundary
# with W a multiple of the tile, W = 1 (the diagonal alone), W > T
BF16_EXTRA = {"G=4": (256, 128, 8, 2), "W=1": (100, 1, 4, 2), "W>T": (64, 200, 4, 1)}
LOG2E = 1.4426950408889634


def _chip_smoke():
    import os
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _bwd_bf16_emulated(q, k, v, o, lse, do, window, split=True):
    """``(dq, dk, dv)`` in bf16 as ``csrc/window_attention_bwd.cu``'s bf16
    kernels round: bf16 q, k, v, dO and o; S = q k^T and dP = dO v^T with
    fp32 sums; P = exp2(S scale log2(e) - lse log2(e)) in the band, D =
    rowsum(dO o) and dS = P (dP - D) in fp32; P and dS enter dV = P^T dO, dK
    = dS^T q scale and dQ = dS k scale as hi = bf16(x) and lo = bf16(x - hi)
    (``split``) or as hi alone, with fp32 sums; each result rounded to bf16
    once.  On the kernels' flattened layout (K and V per kv-head)."""
    BH, T, d = q.shape
    BHkv, dv = k.shape[0], v.shape[-1]
    G = BH // BHkv
    qg = q.float().reshape(BHkv, G, T, d)
    og, dog = (x.float().reshape(BHkv, G, T, dv) for x in (o, do))
    kf, vf = k.float(), v.float()
    scale = 1.0 / np.sqrt(d)
    s = torch.einsum("kgid,kjd->kgij", qg, kf)
    l2 = (lse.float().reshape(BHkv, G, T) * LOG2E)[..., None]
    p = torch.where(wops._band(T, window, "cpu"), torch.exp2(s * (scale * LOG2E) - l2), 0.0)
    dp = torch.einsum("kgic,kjc->kgij", dog, vf)
    ds = p * (dp - torch.sum(dog * og, dim=-1)[..., None])

    def terms(x):
        hi = x.bfloat16().float()
        return (hi, (x - hi).bfloat16().float()) if split else (hi,)

    dvv = sum(torch.einsum("kgij,kgic->kjc", t, dog) for t in terms(p))
    dk = sum(torch.einsum("kgij,kgid->kjd", t, qg) for t in terms(ds)) * scale
    dq = sum(torch.einsum("kgij,kjd->kgid", t, kf) for t in terms(ds)) * scale
    return tuple(x.bfloat16() for x in (dq.reshape(BH, T, d), dk, dvv))


def _bf16_excess(T, W, H, Hkv, d, dv, seed, split=True):
    """The emulated bf16 backward against ``window_attention_bwd_plain`` in
    float64 rounded to bf16 once, at B 2, on bf16 inputs from ``seed`` and
    the forward's o (bf16) and lse (fp32): the largest ratio of an entry's
    error to ``chip_smoke``'s bf16 tolerance, WIN_BWD_BF16_ATOL * max|ref of
    dq, dk, dv| + WIN_BF16_TOL * |ref| (<= 1 within it)."""
    c = _chip_smoke()
    rng = np.random.default_rng(seed)
    B, G = 2, H // Hkv
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
                   for s in ((B * H, T, d), (B * Hkv, T, d), (B * Hkv, T, dv), (B * H, T, dv)))
    kr, vr = (x.float().repeat_interleave(G, 0) for x in (k, v))
    o = wops.window_attention_plain(q.float(), kr, vr, W).bfloat16()
    lse = wops.window_attention_lse_plain(q.float(), kr, W)
    got = _bwd_bf16_emulated(q, k, v, o, lse, do, W, split=split)
    ref = wops.window_attention_bwd_plain(*(x.double() for x in (q, k, v, o)), lse.double(),
                                          do.double(), W)
    floor = c.WIN_BWD_BF16_ATOL * max(float(r.abs().max()) for r in ref)
    worst = 0.0
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        r = r.bfloat16().double()
        worst = max(worst, float(((a.double() - r).abs() / (floor + c.WIN_BF16_TOL * r.abs()))
                                 .max()))
    return worst


def test_bf16_emulation_covers_chip_smokes_edge_shapes():
    assert len(_chip_smoke().WINDOW_EDGES) == N_WINDOW_EDGES


@pytest.mark.parametrize("d,dv", [(128, 128), (96, 64), (24, 16)])
@pytest.mark.parametrize("case", [f"edge {i}" for i in range(N_WINDOW_EDGES)] + list(BF16_EXTRA))
def test_window_attention_bwd_bf16_arithmetic_within_chip_smoke_tolerance(case, d, dv):
    """The bf16 kernels' rounding (P and dS split hi + lo) holds chip_smoke's
    bf16 rule at every edge shape of its backward check and at G 4, W 1 and
    W > T: within it on the CPU before the card's check."""
    if case in BF16_EXTRA:
        T_, W, H, Hkv = BF16_EXTRA[case]
        seed = T_ + W
    else:
        i = int(case.split()[1])
        T_, W, _, H, Hkv = _chip_smoke().WINDOW_EDGES[i]
        seed = 100 + i
    assert _bf16_excess(T_, W, H, Hkv, d, dv, seed) <= 1.0


def test_single_bf16_rounding_of_p_and_ds_is_beyond_the_tolerance():
    """Why the kernels split P and dS: rounded to bf16 once (2^-9 of each
    entry) they put entries whose reference is near 0 beyond the 1e-4 *
    max|ref| floor, at a G 4 edge shape at d = dv = 128."""
    assert _bf16_excess(200, 48, 4, 1, 128, 128, 100, split=False) > 1.0


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

def _softmax_smoke(name, **kw):
    cfg = dataclasses.replace(smoke_config(name), use_chimera=False, **kw)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=SMOKE_WINDOW)
    return cfg


def _batch(vocab, seed, B=2):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, SMOKE_T + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@pytest.mark.parametrize("name,chimera", [("mixtral-8x7b", False), ("minicpm3-4b", False),
                                          ("mixtral-8x7b", True)])
def test_remat_full_matches_none(name, chimera, monkeypatch):
    """The same loss and every gradient leaf, bit for bit; with "full" each
    group's forward runs again in the backward."""
    base = dataclasses.replace(_softmax_smoke(name), use_chimera=chimera)
    assert smoke_config(name).remat == "none" and base.n_groups == 2
    params = TM.init_model(base, torch.Generator().manual_seed(5), device="cpu")
    tok, lab = _batch(base.vocab_size, 6)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    calls = []
    real = TM._group_forward

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TM, "_group_forward", counted)
    runs = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        calls.clear()
        (loss, metrics), grads = value_and_grad(lambda p: TM.loss_fn(cfg, p, batch), params)
        runs[remat] = (loss, metrics, tree_flatten(grads)[0], len(calls))
    (l0, m0, g0, n0), (l1, m1, g1, n1) = runs["none"], runs["full"]
    assert (n0, n1) == (base.n_groups, 2 * base.n_groups)
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_remat_crosses_the_bridge_and_defaults_as_jax():
    from repro.configs import get_config as j_get

    for name in ("mixtral-8x7b", "minicpm3-4b", "chimera-dataplane"):
        assert bridge.arch_from_reference(j_get(name)).remat == j_get(name).remat
        assert bridge.arch_from_reference(j_smoke(name)).remat == "none"


# --------------------------------------------------------------------------
# the train step and the Trainer against JAX
# --------------------------------------------------------------------------

STEP_CASES = [("mixtral-8x7b", "xla"), ("mixtral-8x7b", "reference"), ("minicpm3-4b", "xla")]


def _jax_softmax_smoke(name, swa_backend="xla"):
    cfg = dataclasses.replace(j_smoke(name), use_chimera=False, swa_backend=swa_backend)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=SMOKE_WINDOW)
    return cfg


@pytest.mark.parametrize("name,swa_backend", STEP_CASES)
def test_train_step_matches_jax(name, swa_backend):
    jcfg = _jax_softmax_smoke(name, swa_backend)
    tcfg = bridge.arch_from_reference(jcfg)
    assert tcfg == _softmax_smoke(name)
    jparams, _ = JM.init_model(jcfg, jax.random.PRNGKey(7))
    tparams = bridge.params_from_jax(_np(jparams), device="cpu")
    tok, lab = _batch(jcfg.vocab_size, 8)
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tbatch = {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long()}

    (jl, jm), jg = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jbatch), has_aux=True)(
        jparams)
    (tl, tm), tg = value_and_grad(lambda p: TM.loss_fn(tcfg, p, tbatch), tparams)
    _close(tl, jl, msg="loss")
    for k in ("nll", "aux", "zloss"):
        _close(tm[k], jm[k], msg=k)
    want = dict(_leaves(_np(jg)))
    got = dict(_leaves(tg))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        _close(g, want[path], msg=f"gradient {path}")

    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jnew, _, jmet = j_make_train_step(jcfg, JAdamWConfig(**opt))(
        jparams, j_init_optimizer(jparams), jbatch)
    tnew, _, tmet = make_train_step(tcfg, AdamWConfig(**opt))(
        tparams, init_optimizer(tparams), tbatch)
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        _close(tmet[k], jmet[k], msg=k)
    _close_updates(tnew, jnew, jparams)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "minicpm3-4b"])
def test_trainer_matches_a_live_jax_trainer(tmp_path, name):
    """5 steps of each package's Trainer from the JAX Trainer's parameters
    and optimizer state, on the same token stream: per-step losses,
    ``nll``, ``aux`` and gradient norms within LOSS_RTOL."""
    jcfg = _jax_softmax_smoke(name)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    jtr = JTrainer(jcfg, JTrainerConfig(total_steps=5, log_every=1, ckpt_every=100,
                                        ckpt_dir=str(tmp_path / "jax")),
                   JTokenStream(jcfg.vocab_size, 4, SMOKE_T + 1, seed=9),
                   opt_cfg=JAdamWConfig(**opt))
    start = (_np(jtr.params), _np(jtr.opt_state))
    out_j = jtr.run()
    tr = Trainer(bridge.arch_from_reference(jcfg),
                 TrainerConfig(total_steps=5, log_every=1, ckpt_every=100,
                               ckpt_dir=str(tmp_path / "port")),
                 TokenStream(jcfg.vocab_size, 4, SMOKE_T + 1, seed=9),
                 opt_cfg=AdamWConfig(**opt), device="cpu",
                 params=bridge.params_from_jax(start[0], device="cpu"))
    tr.opt_state = bridge.params_from_jax(start[1], device="cpu")
    out = tr.run()
    assert [r["step"] for r in out["log"]] == [r["step"] for r in out_j["log"]] == [1, 2, 3, 4, 5]
    for k in ("loss", "nll", "aux", "grad_norm"):
        np.testing.assert_allclose([r[k] for r in out["log"]], [r[k] for r in out_j["log"]],
                                   rtol=LOSS_RTOL, err_msg=k)
    _close_updates(tr.params, jtr.params, start[0])


def test_trainer_step_donates_the_old_trees(tmp_path):
    """The Trainer's step releases the old parameters and moments (its dicts
    are emptied); a step made with ``make_train_step`` alone leaves its
    inputs untouched."""
    cfg = _softmax_smoke("mixtral-8x7b")
    tr = Trainer(cfg, TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path)),
                 TokenStream(cfg.vocab_size, 2, SMOKE_T + 1, seed=1), device="cpu")
    old_p, old_m = tr.params, tr.opt_state["m"]
    tr.run()
    assert old_p == {} and old_m == {} and tree_flatten(tr.params)[0]
    params = TM.init_model(cfg, torch.Generator().manual_seed(2), device="cpu")
    tok, lab = _batch(cfg.vocab_size, 3)
    batch = {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long()}
    before = [p.clone() for p in tree_flatten(params)[0]]
    make_train_step(cfg, AdamWConfig())(params, init_optimizer(params), batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(params)[0], before))
