"""Mamba and xLSTM trained by the port, against the JAX package, on the CPU.

* ``mamba_layer``, ``mlstm_layer`` and ``slstm_layer`` at the smoke
  configs, across chunk boundaries (whole chunks and a ragged tail): the
  gradient of <layer(params, x), ct> with respect to every parameter and
  to x against ``jax.vjp``.
* The smoke Jamba-1.5-Large (Mamba, Chimera attention, MoE) and
  xLSTM-125M: ``loss_fn``'s value and every leaf's gradient against
  ``jax.value_and_grad``, then 3 ``make_train_step`` steps against JAX's.
* The nested remat: each Mamba chunk and each mLSTM chunk checkpointed
  (JAX's ``jax.checkpoint`` around the chunk bodies) gives the same
  gradients, bit for bit, as the same code without it, and runs each
  chunk's body twice; the model's ``remat="full"`` over those layers
  likewise.

The JAX package scans a Mamba chunk with ``associative_scan``, the port
token by token, so sums run in other orders.  Tolerances: rtol 1e-4 and
atol 1e-4 (RTOL, ATOL; a weight's gradient sums over B x T rows); each
leaf's parameter update within 1e-3 of JAX's in norm (UPDATE_RTOL: AdamW
amplifies the rounding of gradients near eps, ROADMAP Queue 3).  The JAX
package's scans refuse bfloat16 and its mLSTM overflows at xlstm-125m's
chunk of 256 (ROADMAP Queue 3), so these float32 smoke sizes are where the
two packages are compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import mamba as JMa
from repro.models import model as JM
from repro.models import xlstm as JX
from repro.optim.optimizer import AdamWConfig as JAdamWConfig
from repro.optim.optimizer import init_optimizer as j_init_optimizer
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.models import mamba as TMa
from repro_torch.models import model as TM
from repro_torch.models import xlstm as TX
from repro_torch.models.layers import remat_call
from repro_torch.optim.optimizer import AdamWConfig, init_optimizer, tree_flatten
from repro_torch.train.train_step import make_train_step, value_and_grad

RTOL, ATOL = 1e-4, 1e-4
UPDATE_RTOL = 1e-3
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-125m"


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


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=msg)


def _trees_close(got, want, msg):
    got, want = dict(_leaves(got)), dict(_leaves(_np(want)))
    assert sorted(got) == sorted(want), msg
    for path, g in got.items():
        _close(g, want[path], msg=f"{msg} {path}")


def _close_updates(got, want, start):
    """Each leaf's update (new - start) within UPDATE_RTOL of JAX's, in norm."""
    start, want = dict(_leaves(_np(start))), dict(_leaves(_np(want)))
    for path, p in _leaves(got):
        d_got, d_want = p.detach().numpy() - start[path], want[path] - start[path]
        err = np.linalg.norm(d_got - d_want)
        assert err <= UPDATE_RTOL * np.linalg.norm(d_want) + 1e-12, (path, err)


def _x(T, d, seed, B=2):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(np.float32)


def _layer_grads(layer, cfg, params, x, ct):
    """``(out, d params, d x)`` of <layer(cfg, params, x), ct> by autograd."""
    leaves, unflatten = tree_flatten(params)
    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    xt = _t(x).requires_grad_(True)
    out = layer(cfg, unflatten(ps), xt)
    grads = torch.autograd.grad(torch.sum(out * _t(ct)), ps + [xt])
    return out, unflatten(list(grads[:-1])), grads[-1]


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------

# (name, the JAX init, the JAX layer, the port layer, T): the Mamba chunk is
# 8 at the smoke config, the mLSTM chunk 16; whole chunks and a ragged tail
LAYERS = {
    "mamba": (JAMBA, JMa.init_mamba, JMa.mamba_layer, TMa.mamba_layer),
    "mlstm": (XLSTM, JX.init_mlstm, JX.mlstm_layer, TX.mlstm_layer),
    "slstm": (XLSTM, JX.init_slstm, JX.slstm_layer, TX.slstm_layer),
}
LAYER_T = {"mamba": (24, 27), "mlstm": (32, 27), "slstm": (32, 27)}


@pytest.mark.parametrize("kind,T", [(k, T) for k in LAYERS for T in LAYER_T[k]])
def test_layer_grads_match_jax_vjp(kind, T):
    name, j_init, j_layer, t_layer = LAYERS[kind]
    jcfg = j_smoke(name)
    jp, _ = j_init(jcfg, jax.random.PRNGKey(3))
    tcfg, tp = bridge.arch_from_reference(jcfg), bridge.params_from_jax(_np(jp), device="cpu")
    x, ct = _x(T, jcfg.d_model, seed=T), _x(T, jcfg.d_model, seed=T + 100)
    out_j, vjp = jax.vjp(lambda p, x: j_layer(jcfg, p, x), jp, jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(ct))
    out, gp, gx = _layer_grads(t_layer, tcfg, tp, x, ct)
    _close(out, out_j, msg=f"{kind} output")
    _close(gx, gx_j, msg=f"{kind} d x")
    _trees_close(gp, gp_j, f"{kind} d params")


# --------------------------------------------------------------------------
# the nested remat over the chunks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,body", [("mamba", "_chunk_body"), ("mlstm", "_mlstm_chunk")])
def test_chunk_remat_leaves_gradients_unchanged(kind, body, monkeypatch):
    """The layer's gradients with each chunk checkpointed equal, bit for bit,
    those of the same code run without the checkpoint; with it, each chunk's
    body runs twice (the forward, and again in the backward)."""
    name, j_init, _, t_layer = LAYERS[kind]
    jcfg = j_smoke(name)
    jp, _ = j_init(jcfg, jax.random.PRNGKey(4))
    tcfg, tp = bridge.arch_from_reference(jcfg), bridge.params_from_jax(_np(jp), device="cpu")
    T = 27  # 3 whole chunks of 8 or 1 of 16, then a ragged tail
    x, ct = _x(T, jcfg.d_model, seed=5), _x(T, jcfg.d_model, seed=6)
    mod = TMa if kind == "mamba" else TX
    calls = []
    real = getattr(mod, body)

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(mod, body, counted)
    runs = {}
    for remat in (True, False):
        monkeypatch.setattr(mod, "remat_call", lambda on, fn, *a: remat_call(remat and on, fn, *a))
        calls.clear()
        runs[remat] = (_layer_grads(t_layer, tcfg, tp, x, ct), len(calls))
    (r_on, n_on), (r_off, n_off) = runs[True], runs[False]
    n_chunks = 4 if kind == "mamba" else 2
    assert (n_on, n_off) == (2 * n_chunks, n_chunks)
    assert torch.equal(r_on[0], r_off[0]) and torch.equal(r_on[2], r_off[2])
    for a, b in zip(tree_flatten(r_on[1])[0], tree_flatten(r_off[1])[0]):
        assert torch.equal(a, b)
    # without a gradient the body runs once a chunk
    calls.clear()
    with torch.no_grad():
        t_layer(tcfg, tp, _t(x))
    assert len(calls) == n_chunks


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[JAMBA, XLSTM], ids=["jamba", "xlstm"])
def model(request):
    jcfg = j_smoke(request.param)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(2))
    return jcfg, params, bridge.arch_from_reference(jcfg), bridge.params_from_jax(
        _np(params), device="cpu")


def _batch(vocab, seed, pkg, T=32):
    toks = np.random.default_rng(seed).integers(0, vocab, (2, T + 1)).astype(np.int32)
    if pkg == "jax":
        return {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int64)),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int64))}


def test_loss_fn_grads_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, _batch(jcfg.vocab_size, 5, "jax")), has_aux=True)(jparams)
    (tl, tm), tg = value_and_grad(
        lambda p: TM.loss_fn(tcfg, p, _batch(tcfg.vocab_size, 5, "torch")), tparams)
    _close(tl, jl, msg="loss")
    for k in ("nll", "aux", "zloss"):
        _close(tm[k], jm[k], msg=k)
    _trees_close(tg, jg, "gradient")


def test_train_step_matches_jax(model):
    """3 steps of ``make_train_step`` on three batches: each step's loss,
    nll, aux and gradient norm, and each leaf's update after the three."""
    jcfg, jparams, tcfg, tparams = model
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(j_make_train_step(jcfg, JAdamWConfig(**opt)))
    tstep = make_train_step(tcfg, AdamWConfig(**opt))
    jp, jo = jparams, j_init_optimizer(jparams)
    tp, to = tparams, init_optimizer(tparams)
    for step in range(3):
        jp, jo, jmet = jstep(jp, jo, _batch(jcfg.vocab_size, 10 + step, "jax"))
        tp, to, tmet = tstep(tp, to, _batch(tcfg.vocab_size, 10 + step, "torch"))
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            _close(tmet[k], jmet[k], msg=f"step {step} {k}")
    _close_updates(tp, jp, jparams)


def test_model_remat_full_matches_none(model):
    """The model's group checkpoint over the Mamba and xLSTM layers (nested
    around their chunk checkpoints): the same loss and gradients, bit for
    bit."""
    _, _, base, tparams = model
    assert base.remat == "none"
    runs = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        (loss, _), grads = value_and_grad(
            lambda p: TM.loss_fn(cfg, p, _batch(cfg.vocab_size, 7, "torch")), tparams)
        runs[remat] = (loss, tree_flatten(grads)[0])
    assert torch.equal(runs["none"][0], runs["full"][0])
    for a, b in zip(runs["none"][1], runs["full"][1]):
        assert torch.equal(a, b)
