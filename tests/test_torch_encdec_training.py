"""whisper-tiny's encoder-decoder trained by the port, against the JAX
package, on the CPU.

* The non-causal softmax's gradients: the wrapper's CPU route
  (``noncausal_attention``, autograd through ``noncausal_attention_plain``),
  the port's ``blockwise_softmax_attention(causal=False)`` and the backward
  kernels' function (``window_attention_noncausal_lse_plain`` for the
  forward's lse, then ``window_attention_noncausal_bwd_plain`` on the
  kernels' flattened layout, K and V per kv-head) against ``jax.vjp`` of
  JAX's ``blockwise_softmax_attention(causal=False)`` in both its forms
  (dense; online kv blocks), Tq != Tk both ways and Tq = 1.
* ``window_attention_noncausal_bwd_plain`` against autograd of the plain
  forward, in float32 and float64.
* ``cross_attention_layer`` (both branches, gradients through
  ``encode_cross_kv`` to the encoder's output), ``encode`` and smoke
  whisper-tiny's ``loss_fn``, every leaf's gradient against
  ``jax.vjp`` / ``jax.value_and_grad``.
* 3 ``make_train_step`` steps against JAX's, and 3 ``Trainer`` steps on an
  enc-dec stream (batches with ``enc_embeds``) against a live JAX
  ``Trainer`` on the same stream.
* ``remat="full"`` against ``"none"`` for ``encode`` and the decoder: the
  same loss and gradients, and each encoder layer and decoder group run
  twice.

Tolerances: float32 on both sides with other summation orders, rtol 1e-4
and atol 1e-4 (RTOL, ATOL; a weight's gradient sums up to B x T_ENC rows'
products, entries of order 10; float64 within 1e-10); each leaf's parameter
update within 1e-3 of JAX's in norm (UPDATE_RTOL: AdamW amplifies the
rounding of gradients near eps, ROADMAP Queue 3).  The card's checks of
the non-causal backward are in ``tests/test_torch_encdec_training_card.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import attention as JA
from repro.models import model as JM
from repro.optim.optimizer import AdamWConfig as JAdamWConfig
from repro.optim.optimizer import init_optimizer as j_init_optimizer
from repro.train.train_step import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.kernels.window_attention import ops as wops
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.optim.optimizer import AdamWConfig, init_optimizer, tree_flatten
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.train_step import make_train_step, value_and_grad

RTOL, ATOL = 1e-4, 1e-4
UPDATE_RTOL = 1e-3
WHISPER = "whisper-tiny"
B, T_DEC, T_ENC = 2, 32, 128  # T_DEC: 2 smoke chunks of 16; T_ENC: 2 kv blocks of 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's and XLA's CPU thread pools contend in one process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


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


def _trees_close(got, want, msg):
    got, want = dict(_leaves(got)), dict(_leaves(_np(want)))
    assert sorted(got) == sorted(want), msg
    for path, g in got.items():
        _close(g, want[path], msg=f"{msg} {path}")


def _close_updates(got, want, start):
    """Each leaf's update (new - start) within UPDATE_RTOL of JAX's, in norm
    (an update is about lr g / (|g| + eps): elementwise, a rounding of g
    near eps changes the step)."""
    start, want = dict(_leaves(_np(start))), dict(_leaves(_np(want)))
    for path, p in _leaves(got):
        d_got, d_want = p.detach().numpy() - start[path], want[path] - start[path]
        err = np.linalg.norm(d_got - d_want)
        assert err <= UPDATE_RTOL * np.linalg.norm(d_want) + 1e-12, (path, err)


def _cfgs(use_chimera):
    jcfg = dataclasses.replace(j_smoke(WHISPER), use_chimera=use_chimera)
    return jcfg, bridge.arch_from_reference(jcfg)


# --------------------------------------------------------------------------
# the non-causal softmax's backward
# --------------------------------------------------------------------------

# (Tq, Tk, H, Hkv, blk): JAX's dense form (Tk % blk != 0 or Tk <= blk) and
# its online form (Tk % blk == 0, Tk > blk); Tq != Tk both ways, Tq = 1, 2
# query heads a kv-head
NONCAUSAL_GRAD_CASES = [
    (40, 40, 4, 4, 16), (24, 24, 4, 2, 32), (20, 77, 4, 4, 64), (1, 37, 4, 4, 16),
    (32, 128, 4, 4, 32), (128, 32, 4, 2, 16), (1, 128, 4, 4, 32),
]


@pytest.mark.parametrize("Tq,Tk,H,Hkv,blk", NONCAUSAL_GRAD_CASES)
def test_noncausal_grads_match_jax_vjp(Tq, Tk, H, Hkv, blk):
    d = dv = 16
    G = H // Hkv
    rng = np.random.default_rng(Tq + 7 * Tk + G)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, H, Tq, d), (B, Hkv, Tk, d), (B, Hkv, Tk, dv), (B, H, Tq, dv)))
    out_j, vjp = jax.vjp(lambda q, k, v: JA.blockwise_softmax_attention(q, k, v, blk,
                                                                        causal=False),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    for route, fn in (("wrapper", lambda *x: wops.noncausal_attention(*x)),
                      ("blockwise", lambda *x: TA.blockwise_softmax_attention(*x, blk,
                                                                              causal=False))):
        xs = [_t(a).requires_grad_(True) for a in (q, k, v)]
        out = fn(*xs)
        _close(out, out_j, msg=f"{route} output")
        for name, g, w in zip(("dq", "dk", "dv"), torch.autograd.grad(out, xs, _t(do)), want):
            _close(g, w, msg=f"{route} {name}")
    # the kernels' function on their flattened layout, K and V per kv-head
    qf, dof = (_t(a).reshape(B * H, Tq, -1) for a in (q, do))
    kf, vf = (_t(a).reshape(B * Hkv, Tk, -1) for a in (k, v))
    lse = wops.window_attention_noncausal_lse_plain(qf, kf.repeat_interleave(G, 0))
    assert lse.shape == (B * H, Tq) and lse.dtype == torch.float32
    o = _t(out_j).reshape(B * H, Tq, dv)
    got = wops.window_attention_noncausal_bwd_plain(qf, kf, vf, o, lse, dof)
    shapes = ((B, H, Tq, d), (B, Hkv, Tk, d), (B, Hkv, Tk, dv))
    for name, g, w, s in zip(("dq", "dk", "dv"), got, want, shapes):
        _close(g.reshape(s), w, msg=f"the backward kernels' function {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("Tq,Tk,G", [(40, 40, 1), (33, 70, 2), (70, 33, 4), (1, 65, 2)])
def test_noncausal_bwd_plain_matches_autograd(Tq, Tk, G, dtype):
    """On the flattened layout, K and V per kv-head: the plain backward
    against autograd through the plain forward with K and V repeated."""
    BH, d, dv = 8, 16, 24
    g = torch.Generator().manual_seed(Tq + Tk + G)
    q, do = (torch.randn(s, generator=g, dtype=dtype) for s in ((BH, Tq, d), (BH, Tq, dv)))
    k, v = (torch.randn(s, generator=g, dtype=dtype) for s in ((BH // G, Tk, d),
                                                               (BH // G, Tk, dv)))
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = wops.window_attention_noncausal_plain(xs[0], xs[1].repeat_interleave(G, 0),
                                              xs[2].repeat_interleave(G, 0))
    want = torch.autograd.grad(o, xs, do)
    lse = wops.window_attention_noncausal_lse_plain(q, k.repeat_interleave(G, 0))
    got = wops.window_attention_noncausal_bwd_plain(q, k, v, o.detach(), lse, do)
    tol = dict(rtol=1e-10, atol=1e-10) if dtype == torch.float64 else {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape
        _close(a, w, msg=name, **tol)


def test_noncausal_backward_halves_refuse_the_cpu_and_bad_shapes():
    q = torch.zeros((1, 2, 8, 16))
    kv = torch.zeros((1, 1, 5, 16))
    o, lse = torch.zeros_like(q), torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="do not fit"):
        wops.window_attention_noncausal_bwd(q, kv, kv, o, lse[:, :, :4], o)
    # the Function's two halves launch kernels and have no CPU route
    with pytest.raises(RuntimeError, match="no kernel for device"):
        wops.window_attention_noncausal_fwd(q, kv, kv)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        wops.window_attention_noncausal_bwd(q, kv, kv, o, lse, o)


# --------------------------------------------------------------------------
# the layers and the model under autograd
# --------------------------------------------------------------------------

def _x(T, seed, d=64):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(np.float32)


def _grads(fn, params, inputs, ct):
    """``(out, d params (a tree; zeros where unused, as JAX's), d inputs)``
    of <fn(params, *inputs), ct> by autograd."""
    leaves, unflatten = tree_flatten(params)
    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    xs = [_t(a).requires_grad_(True) for a in inputs]
    out = fn(unflatten(ps), *xs)
    grads = torch.autograd.grad(torch.sum(out * _t(ct)), ps + xs, allow_unused=True)
    dps = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
    return out, unflatten(dps), grads[len(ps):]


@pytest.mark.parametrize("Tq", [T_DEC, 1])
@pytest.mark.parametrize("use_chimera", [True, False])
def test_cross_attention_grads_match_jax(use_chimera, Tq):
    """Every parameter of the sublayer, the decoder states and the encoder's
    output (through ``encode_cross_kv``)."""
    jcfg, tcfg = _cfgs(use_chimera)
    jp, _ = JA.init_cross_attention(jcfg, jax.random.PRNGKey(2))
    tp = bridge.params_from_jax(_np(jp), device="cpu")
    enc, x, ct = _x(T_ENC, 5), _x(Tq, 6), _x(Tq, 7)
    out_j, vjp = jax.vjp(
        lambda p, x, e: JA.cross_attention_layer(jcfg, p, x, JA.encode_cross_kv(jcfg, p, e)),
        jp, jnp.asarray(x), jnp.asarray(enc))
    gp_j, gx_j, ge_j = vjp(jnp.asarray(ct))
    out, gp, (gx, ge) = _grads(
        lambda p, x, e: TA.cross_attention_layer(tcfg, p, x, TA.encode_cross_kv(tcfg, p, e)),
        tp, (x, enc), ct)
    _close(out, out_j, msg="output")
    _close(gx, gx_j, msg="d x")
    _close(ge, ge_j, msg="d enc_out")
    _trees_close(gp, gp_j, "d params")


@pytest.fixture(scope="module", params=[True, False], ids=["chimera", "softmax"])
def case(request):
    """Smoke whisper-tiny (2 encoder and 2 decoder layers, d 64, Chimera L
    16) in one cross-attention branch: JAX's parameters, both configs, and
    numpy inputs (frame embeddings B x T_ENC, tokens B x T_DEC)."""
    jcfg, tcfg = _cfgs(request.param)
    jp, _ = JM.init_model(jcfg, jax.random.PRNGKey(7))
    tp = bridge.params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((B, T_ENC, 64)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, T_DEC + 1)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, emb=emb, toks=toks)


def _batch(c, pkg, step=0):
    toks = np.roll(c["toks"], step, axis=1)
    emb = c["emb"] * (1.0 + 0.1 * step)
    if pkg == "jax":
        return {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]),
                "enc_embeds": jnp.asarray(emb)}
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int64)),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int64)),
            "enc_embeds": torch.from_numpy(emb)}


def test_encode_grads_match_jax(case):
    """<encode(params, frames), ct>: every parameter leaf's gradient (zeros
    off the encoder, as JAX's) and the frames'."""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    ct = _x(T_ENC, 9)
    out_j, vjp = jax.vjp(lambda p, e: JM.encode(jcfg, p, e), case["jp"],
                         jnp.asarray(case["emb"]))
    gp_j, ge_j = vjp(jnp.asarray(ct))
    out, gp, (ge,) = _grads(lambda p, e: TM.encode(tcfg, p, e), case["tp"], (case["emb"],), ct)
    _close(out, out_j, msg="encoder output")
    _close(ge, ge_j, msg="d frames")
    _trees_close(gp, gp_j, "d params")


def test_loss_fn_grads_match_jax(case):
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    (jl, jm), jg = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, _batch(case, "jax")),
                                      has_aux=True)(case["jp"])
    (tl, tm), tg = value_and_grad(lambda p: TM.loss_fn(tcfg, p, _batch(case, "torch")),
                                  case["tp"])
    _close(tl, jl, msg="loss")
    for k in ("nll", "aux", "zloss"):
        _close(tm[k], jm[k], msg=k)
    _trees_close(tg, jg, "gradient")


def test_train_step_matches_jax(case):
    """3 steps of ``make_train_step`` on three batches: each step's loss,
    nll and gradient norm, and each leaf's update after the three."""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(j_make_train_step(jcfg, JAdamWConfig(**opt)))
    tstep = make_train_step(tcfg, AdamWConfig(**opt))
    jp, jo = case["jp"], j_init_optimizer(case["jp"])
    tp, to = case["tp"], init_optimizer(case["tp"])
    for step in range(3):
        jp, jo, jmet = jstep(jp, jo, _batch(case, "jax", step))
        tp, to, tmet = tstep(tp, to, _batch(case, "torch", step))
        for k in ("loss", "nll", "grad_norm", "lr"):
            _close(tmet[k], jmet[k], msg=f"step {step} {k}")
    _close_updates(tp, jp, case["jp"])


class EncDecStream:
    """A resumable stream of enc-dec batches, as JAX's ``Trainer`` takes
    them: ``enc_embeds`` (B, T_ENC, d) frames, ``tokens`` and ``labels`` (B,
    T_DEC), from a numpy seed and the step."""

    def __init__(self, vocab, d, seed):
        self.vocab, self.d, self.seed, self.step = vocab, d, seed, 0

    def state(self):
        return {"step": self.step}

    def restore(self, state):
        self.step = int(state["step"])

    def next_batch(self):
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        toks = rng.integers(0, self.vocab, (B, T_DEC + 1)).astype(np.int32)
        return {"enc_embeds": rng.standard_normal((B, T_ENC, self.d)).astype(np.float32),
                "tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


@pytest.mark.parametrize("use_chimera", [True, False])
def test_trainer_on_an_encdec_stream_matches_a_live_jax_trainer(tmp_path, use_chimera):
    jcfg, tcfg = _cfgs(use_chimera)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    tcfg_j = JTrainerConfig(total_steps=3, log_every=1, ckpt_every=100,
                            ckpt_dir=str(tmp_path / "jax"))
    jtr = JTrainer(jcfg, tcfg_j, EncDecStream(jcfg.vocab_size, jcfg.d_model, 4),
                   opt_cfg=JAdamWConfig(**opt))
    start = (_np(jtr.params), _np(jtr.opt_state))
    out_j = jtr.run()
    tr = Trainer(tcfg, TrainerConfig(total_steps=3, log_every=1, ckpt_every=100,
                                     ckpt_dir=str(tmp_path / "port")),
                 EncDecStream(tcfg.vocab_size, tcfg.d_model, 4), opt_cfg=AdamWConfig(**opt),
                 device="cpu", params=bridge.params_from_jax(start[0], device="cpu"))
    tr.opt_state = bridge.params_from_jax(start[1], device="cpu")
    out = tr.run()
    assert [r["step"] for r in out["log"]] == [r["step"] for r in out_j["log"]] == [1, 2, 3]
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose([r[k] for r in out["log"]], [r[k] for r in out_j["log"]],
                                   rtol=RTOL, err_msg=k)
    _close_updates(tr.params, jtr.params, start[0])


# --------------------------------------------------------------------------
# remat over the encoder and the decoder
# --------------------------------------------------------------------------

def test_remat_full_matches_none_over_the_enc_dec_stack(case, monkeypatch):
    """The same loss and every gradient leaf, bit for bit; with "full" each
    encoder layer and each decoder group (its cross-attention keys and
    values included) runs again in the backward."""
    base = case["tcfg"]
    assert base.remat == "none" and base.encoder_layers == 2 and base.n_groups == 2
    calls = {"enc": 0, "dec": 0, "cross_kv": 0}
    real_group, real_dec, real_kv = TM._group_forward, TM._decoder_group, TA.encode_cross_kv

    def group(*a, **kw):
        calls["enc"] += 1
        return real_group(*a, **kw)

    def dec(*a, **kw):
        calls["dec"] += 1
        return real_dec(*a, **kw)

    def kv(*a, **kw):
        calls["cross_kv"] += 1
        return real_kv(*a, **kw)

    monkeypatch.setattr(TM, "_group_forward", group)
    monkeypatch.setattr(TM, "_decoder_group", dec)
    monkeypatch.setattr(TM.attn, "encode_cross_kv", kv)
    runs = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        calls.update(enc=0, dec=0, cross_kv=0)
        (loss, _), grads = value_and_grad(lambda p: TM.loss_fn(cfg, p, _batch(case, "torch")),
                                          case["tp"])
        runs[remat] = (loss, tree_flatten(grads)[0], dict(calls))
    (l0, g0, n0), (l1, g1, n1) = runs["none"], runs["full"]
    assert n0 == {"enc": 2, "dec": 2, "cross_kv": 2}
    assert n1 == {"enc": 4, "dec": 4, "cross_kv": 4}
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    # serving (no gradient) runs each once, whatever remat says
    calls.update(enc=0, dec=0, cross_kv=0)
    with torch.no_grad():
        TM.forward(dataclasses.replace(base, remat="full"), case["tp"], _batch(case, "torch"))
    assert calls == {"enc": 2, "dec": 2, "cross_kv": 2}
