"""The port's training path against the JAX package, on the CPU.

Small shapes throughout (2 layers, d 32, d_head 16, m 32, L 16, T 32-64).
Inputs come from numpy with fixed seeds, or from the JAX initializer, and
cross the boundary as numpy.  Here the ``chimera_attention`` wrapper runs
its plain PyTorch version (the tensors lie on the CPU); the JAX side runs
its pure-jnp reference, the Pallas kernel in interpret mode, or its scan
branch.  The CUDA kernel itself is held against the plain version by the
``cuda``-marked test at the end (and by ``chip_smoke.py``).

Tolerances, float32 on both sides with other summation orders:
* partials and attention outputs (sums of up to T terms): rtol 1e-5, atol 1e-5;
* losses: rtol 1e-5; gradients (through 2 layers): rtol 1e-3, atol 1e-6
  times the largest entry of the leaf's JAX gradient;
* AdamW fed the same gradients: rtol 1e-6, atol 1e-7 (near bit-equal);
* losses of 3 training steps: rtol 1e-4;
* the data streams: identical.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chimera_attention as JCA
from repro.data import pipeline as jpipe
from repro.kernels.chimera_attention import ops as jops
from repro.kernels.chimera_attention.kernel import chimera_attention_pallas
from repro.kernels.chimera_attention.ref import chimera_attention_partials_ref
from repro.models import model as JM
from repro.optim import optimizer as JO
from repro.train import classifier as JC
from repro.train import train_step as JT
from repro_torch import bridge
from repro_torch.core import chimera_attention as TCA
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.chimera_attention import ops as cops
from repro_torch.models import model as TM
from repro_torch.optim import optimizer as TO
from repro_torch.train import classifier as TC
from repro_torch.train import train_step as TT

ROOT = os.path.join(os.path.dirname(__file__), "..")
ATTN_RTOL, ATTN_ATOL = 1e-5, 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-6
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
STEPS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's and XLA's CPU thread pools contend in one process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def arch(tiny_arch):
    """tiny_arch (2 layers, d 32, 2 heads, d_head 16, L 16, n_global 8) with m 32."""
    ch = tiny_arch.chimera
    return dataclasses.replace(tiny_arch, chimera=dataclasses.replace(
        ch, feature_map=dataclasses.replace(ch.feature_map, m=32), use_pallas=False))


@pytest.fixture(scope="module")
def ccfg(arch):
    return JC.ClassifierConfig(arch=arch, n_classes=8, marker_base=256)


# --------------------------------------------------------------------------
# the kernel's plain version and its autograd Function
# --------------------------------------------------------------------------

def _partials_inputs(seed, B=2, Hkv=2, Gq=1, T=64, d=16, dv=16, m=32):
    rng = np.random.default_rng(seed)

    def unit(*s):  # normalized to norm 2, as the callers pass them
        x = rng.standard_normal(s)
        return (2 * x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    pos = lambda *s: (rng.random(s) / np.sqrt(m)).astype(np.float32)  # noqa: E731
    return [unit(B, Hkv, Gq, T, d), unit(B, Hkv, T, d),
            rng.standard_normal((B, Hkv, T, dv)).astype(np.float32),
            pos(B, Hkv, Gq, T, m), pos(B, Hkv, T, m)]


def _jax_partials(impl, xs, L, use_local, use_stream):
    if impl == "reference":
        return chimera_attention_partials_ref(*map(jnp.asarray, xs), L, use_local, use_stream)
    q, k, v, pq, pk = xs
    B, Hkv, Gq, T, d = q.shape
    BH = B * Hkv
    num, den = chimera_attention_pallas(
        jnp.asarray(q.reshape(BH, Gq, T, d)), jnp.asarray(k.reshape(BH, T, d)),
        jnp.asarray(v.reshape(BH, T, -1)), jnp.asarray(pq.reshape(BH, Gq, T, -1)),
        jnp.asarray(pk.reshape(BH, T, -1)),
        chunk_size=L, use_local=use_local, use_stream=use_stream, interpret=True,
    )
    return (np.asarray(num).reshape(B, Hkv, Gq, T, -1), np.asarray(den).reshape(B, Hkv, Gq, T))


@pytest.mark.parametrize("Gq", [1, 2])
@pytest.mark.parametrize("local_stream", [(True, True), (True, False), (False, True)],
                         ids=["local+stream", "local", "stream"])
@pytest.mark.parametrize("jax_impl", ["reference", "pallas-interpret"])
def test_partials_plain_matches_jax(Gq, local_stream, jax_impl):
    L = 16
    use_local, use_stream = local_stream
    xs = _partials_inputs(seed=Gq, Gq=Gq)
    want = _jax_partials(jax_impl, xs, L, use_local, use_stream)
    got = cops.chimera_attention_partials(*map(_t, xs), L, use_local, use_stream)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=ATTN_RTOL, atol=ATTN_ATOL)
    assert cops.launches == 0  # CPU tensors run the plain version


def test_partials_gradients_match_jax_vjp():
    L, Gq = 16, 2
    xs = _partials_inputs(seed=5, Gq=Gq)
    rng = np.random.default_rng(6)
    g_num = rng.standard_normal(xs[0].shape[:-1] + (xs[2].shape[-1],)).astype(np.float32)
    g_den = rng.standard_normal(xs[0].shape[:-1]).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jops.chimera_attention_partials(*a, L, True, True, "reference"),
                     *map(jnp.asarray, xs))
    want = vjp((jnp.asarray(g_num), jnp.asarray(g_den)))
    ts = [_t(x).requires_grad_(True) for x in xs]
    num, den = cops.chimera_attention_partials(*ts, L)
    got = torch.autograd.grad((num, den), ts, (_t(g_num), _t(g_den)))
    for name, g, w in zip(("q", "k", "v", "phi_q", "phi_k"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * np.abs(w).max(), err_msg=name)


def test_partials_wrapper_checks_shapes_and_devices():
    q, k, v, pq, pk = (_t(x[:, 0]) for x in _partials_inputs(seed=0))  # BH layout
    with pytest.raises(ValueError, match="phi_k has shape"):
        cops.chimera_attention_bh(q, k, v, pq, pk[:, :, :-1], chunk_size=16)
    with pytest.raises(ValueError, match="divisible"):
        cops.chimera_attention_bh(q, k, v, pq, pk, chunk_size=24)
    meta = [torch.empty(x.shape, device="meta") for x in (q, k, v, pq, pk)]
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        cops.chimera_attention_bh(*meta, chunk_size=16)
    assert cops.launches == 0


# --------------------------------------------------------------------------
# core.chimera_attention.chimera_attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_global", [0, 8])
@pytest.mark.parametrize("jax_branch", ["scan", "pallas-interpret"])
def test_chimera_attention_matches_jax(arch, n_global, jax_branch):
    cfg_j = dataclasses.replace(arch.chimera, n_global=n_global,
                                use_pallas=jax_branch != "scan", backend="pallas-interpret")
    cfg_t = bridge.arch_from_reference(dataclasses.replace(arch, chimera=cfg_j)).chimera
    B, H, Hkv, T, d = 2, 2, 2, 48, 16
    params = JCA.init_chimera_attention(cfg_j, Hkv, d, d, jax.random.PRNGKey(7))
    rng = np.random.default_rng(n_global)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, T, d), (B, Hkv, T, d), (B, Hkv, T, d)))
    want = JCA.chimera_attention(cfg_j, params, *map(jnp.asarray, (q, k, v)))
    got = TCA.chimera_attention(cfg_t, bridge.params_from_jax(_np_tree(params), device="cpu"),
                                _t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_RTOL, atol=ATTN_ATOL)
    with pytest.raises(ValueError, match="divisible"):
        TCA.chimera_attention(cfg_t, {}, _t(q[:, :, :40]), _t(k[:, :, :40]), _t(v[:, :, :40]))


# --------------------------------------------------------------------------
# the two objectives
# --------------------------------------------------------------------------

def _packet_batch(ccfg, seed, B=4, T=32):
    s = jpipe.PacketStream(batch_size=B, seq_len=T, vocab_size=ccfg.arch.vocab_size,
                           anomaly_rate=0.5, seed=seed)
    return s.next_batch(), s._anomaly_sig


def test_classifier_loss_and_every_gradient_match_jax(ccfg):
    params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(2))
    batch, anom = _packet_batch(ccfg, seed=3)
    rules = JC.default_rules(ccfg, jnp.asarray(anom))
    (loss_j, met_j), grads_j = jax.value_and_grad(
        lambda p: JC.classifier_loss(ccfg, p, rules, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    ccfg_t = bridge.classifier_config_from_reference(ccfg)
    rules_t = TC.default_rules(ccfg_t, anom, device="cpu")
    batch_t = {k: _t(v) for k, v in batch.items()}
    (loss_t, met_t), grads_t = TT.value_and_grad(
        lambda p: TC.classifier_loss(ccfg_t, p, rules_t, batch_t),
        bridge.params_from_jax(_np_tree(params), device="cpu"))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    for k in ("ce", "bce"):
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]), rtol=LOSS_RTOL)
    want = dict(_leaves(_np_tree(grads_j)))
    got = dict(_leaves(grads_t))
    assert got.keys() == want.keys()  # every leaf has a gradient
    zero = [p for p, w in want.items() if not w.any()]
    # leaves with no path to the loss: the signature projection (through a
    # comparison) and the unused LM head
    assert ("backbone", "head", "w") in zero
    assert any("sig_proj" in p for p in zero)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * np.abs(w).max(),
                                   err_msg=str(path))
        if path in zero:
            assert not g.any(), path


def _token_batch(vocab, seed, B=2, T=32):
    return jpipe.TokenStream(vocab_size=vocab, batch_size=B, seq_len=T + 1, seed=seed).next_batch()


def test_loss_fn_matches_jax(arch):
    params, _ = JM.init_model(arch, jax.random.PRNGKey(4))
    batch = _token_batch(arch.vocab_size, seed=1)
    loss_j, met_j = JM.loss_fn(arch, params, {k: jnp.asarray(v) for k, v in batch.items()})
    arch_t = bridge.arch_from_reference(arch)
    loss_t, met_t = TM.loss_fn(arch_t, bridge.params_from_jax(_np_tree(params), device="cpu"),
                               {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    for k in ("nll", "zloss", "aux"):
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]), rtol=LOSS_RTOL, atol=1e-12)


def test_train_step_matches_jax(arch):
    """One step of ``make_train_step``: loss, gradient norm and lr agree."""
    params, _ = JM.init_model(arch, jax.random.PRNGKey(5))
    ocfg_j = JO.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    ocfg_t = TO.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    batch = _token_batch(arch.vocab_size, seed=2)
    _, _, met_j = JT.make_train_step(arch, ocfg_j)(
        params, JO.init_optimizer(params, ocfg_j), {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = bridge.params_from_jax(_np_tree(params), device="cpu")
    new_t, opt_t, met_t = TT.make_train_step(bridge.arch_from_reference(arch), ocfg_t)(
        tparams, TO.init_optimizer(tparams, ocfg_t), {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "nll", "zloss", "lr"):
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met_t["grad_norm"]), float(met_j["grad_norm"]),
                               rtol=GRAD_RTOL)
    assert int(opt_t["step"]) == 1
    assert dict(_leaves(new_t)).keys() == dict(_leaves(tparams)).keys()


def test_make_train_state_layout_matches_jax(arch):
    params_j, opt_j, _ = JT.make_train_state(arch, jax.random.PRNGKey(0))
    params_t, opt_t = TT.make_train_state(bridge.arch_from_reference(arch),
                                          torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: {p: tuple(x.shape) for p, x in _leaves(tree)}  # noqa: E731
    assert shapes(params_t) == shapes(_np_tree(params_j))
    assert shapes(opt_t["m"]) == shapes(_np_tree(opt_j["m"]))
    # the LM tree crosses the bridge leaf for leaf
    back = dict(_leaves(bridge.params_from_jax(_np_tree(params_j), device="cpu")))
    for p, x in _leaves(_np_tree(params_j)):
        np.testing.assert_array_equal(back[p].numpy(), x)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax_on_the_same_gradients(grad_scale):
    rng = np.random.default_rng(int(grad_scale * 100))
    shapes = {"a": {"w": (8, 6), "b": (6,)}, "emb": {"table": (10, 4)}, "s": ()}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    cfg_j = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    cfg_t = TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    pj, sj = jax.tree_util.tree_map(jnp.asarray, params), JO.init_optimizer(params, cfg_j)
    pt = bridge.params_from_jax(params, device="cpu")
    st = TO.init_optimizer(pt, cfg_t)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * grad_scale).astype(np.float32), params)
        grads["emb"]["table"][3:] = 0.0  # rows absent from the batch: still decayed
        pj, sj, mj = JO.adamw_update(cfg_j, pj, jax.tree_util.tree_map(jnp.asarray, grads), sj)
        pt, st, mt = TO.adamw_update(cfg_t, pt, bridge.params_from_jax(grads, device="cpu"), st)
        for name, a, b in (("params", pt, pj), ("m", st["m"], sj["m"]), ("v", st["v"], sj["v"])):
            want = dict(_leaves(_np_tree(b)))
            for path, x in _leaves(a):
                np.testing.assert_allclose(x.numpy(), want[path], rtol=OPT_RTOL, atol=OPT_ATOL,
                                           err_msg=f"step {step} {name} {path}")
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=OPT_RTOL)
        assert int(st["step"]) == int(sj["step"]) == step + 1
    assert (float(mt["grad_norm"]) > 1.0) == (grad_scale > 1.0)


def test_schedule_matches_jax():
    cfg_j = JO.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=12)
    cfg_t = TO.AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=12)
    for s in range(15):
        np.testing.assert_allclose(float(TO.schedule(cfg_t, torch.tensor(s))),
                                   float(JO.schedule(cfg_j, jnp.asarray(s))), rtol=1e-6)


# --------------------------------------------------------------------------
# the training loop of benchmarks/common.py
# --------------------------------------------------------------------------

def test_train_classifier_matches_the_benchmarks_loop(ccfg):
    """3 steps from the same initial parameters on the same batches.  The
    losses are compared; parameters after several Adam steps are not (a
    gradient within rounding of 0 moves its entry by ±lr on either side)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmarks import common as BC

    steps, lr, kw = 3, 3e-3, dict(batch_size=8, seq_len=32, vocab_size=512, anomaly_rate=0.2,
                                  seed=9)
    # the benchmarks loop returns only its parameters; the same loop, run
    # here step by step, gives the losses and must end on the same parameters
    params_bc, _ = BC.train_classifier(ccfg, jpipe.PacketStream(**kw), steps=steps, lr=lr)
    params, _ = JC.init_classifier(ccfg, jax.random.PRNGKey(0))
    init = _np_tree(params)
    stream = jpipe.PacketStream(**kw)
    rules = JC.default_rules(ccfg, jnp.asarray(stream._anomaly_sig))
    ocfg = JO.AdamWConfig(lr=lr, warmup_steps=3, total_steps=steps)
    opt = JO.init_optimizer(params, ocfg)

    @jax.jit
    def step(params, opt, batch):  # benchmarks/common.py's step
        (loss, _), g = jax.value_and_grad(
            lambda p: JC.classifier_loss(ccfg, p, rules, batch), has_aux=True)(params)
        params, opt, _ = JO.adamw_update(ocfg, params, g, opt)
        return params, opt, loss

    losses_j = []
    for _ in range(steps):
        b = {k: jnp.asarray(v) for k, v in stream.next_batch().items()}
        params, opt, loss = step(params, opt, b)
        losses_j.append(float(loss))
    for (p, a), (_, b) in zip(_leaves(_np_tree(params)), _leaves(_np_tree(params_bc))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=str(p))

    ccfg_t = bridge.classifier_config_from_reference(ccfg)
    out, rules_t, losses_t = TC.train_classifier(
        ccfg_t, tpipe.PacketStream(**kw), bridge.params_from_jax(init, device="cpu"),
        steps=steps, lr=lr)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=STEPS_RTOL)
    assert losses_t.shape == (steps,)
    # held-out batches of the same traffic (the rules match its anomaly signature)
    ev = TC.eval_classifier(ccfg_t, out, rules_t, tpipe.PacketStream(**kw, step=100), batches=2)
    assert 0.0 <= ev["f1"] <= 1.0 and ev["trust"].shape == (16,)
    assert (ev["trust"][ev["anom"]] == 1.0).all()  # the hard veto (Eq. 15)


def test_accuracy_metrics_match_jax():
    rng = np.random.default_rng(0)
    preds, labels = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
    want = JC.accuracy_metrics(jnp.asarray(preds), jnp.asarray(labels), 5)
    got = TC.accuracy_metrics(_t(preds), _t(labels), 5)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --------------------------------------------------------------------------
# the data streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(anomaly_rate=0.3, seed=4, batch_size=8, seq_len=64),
    dict(hard_mode=True, noise=0.1, marker_noise=0.05, drift=2.0, seed=1),
    dict(shard_id=1, num_shards=2, n_classes=4, vocab_size=1024),
], ids=["default", "anomalous", "hard", "shard"])
def test_packet_stream_copy_matches_reference(kw):
    a, b = jpipe.PacketStream(**kw), tpipe.PacketStream(**kw)
    np.testing.assert_array_equal(a._anomaly_sig, b._anomaly_sig)
    for _ in range(3):
        ba, bb = a.next_batch(), b.next_batch()
        assert ba.keys() == bb.keys()
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k])
            assert ba[k].dtype == bb[k].dtype
    assert a.state() == b.state()


@pytest.mark.parametrize("kw", [
    dict(vocab_size=1024, batch_size=8, seq_len=129),
    dict(vocab_size=40, batch_size=3, seq_len=17, seed=5, shard_id=2, num_shards=4),
], ids=["launch-defaults", "small-vocab-shard"])
def test_token_stream_copy_matches_reference(kw):
    a, b = jpipe.TokenStream(**kw), tpipe.TokenStream(**kw)
    for _ in range(3):
        ba, bb = a.next_batch(), b.next_batch()
        assert ba.keys() == bb.keys()
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k])
            assert ba[k].dtype == bb[k].dtype
    b.restore(a.state())
    assert a.state() == b.state()


# --------------------------------------------------------------------------
# entry points default to the card
# --------------------------------------------------------------------------

@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")


ENTRY_POINTS = {
    "init_classifier": lambda c, a: TC.init_classifier(c, torch.Generator()),
    "default_rules": lambda c, a: TC.default_rules(c, [300, 301]),
    "init_model": lambda c, a: TM.init_model(a, torch.Generator()),
    "init_caches": lambda c, a: TM.init_caches(a, 2),
    "make_train_state": lambda c, a: TT.make_train_state(a, torch.Generator()),
    "params_from_jax": lambda c, a: bridge.params_from_jax({"w": np.zeros((2, 2), np.float32)}),
    "rules_from_numpy": lambda c, a: bridge.rules_from_numpy(
        np.zeros((1, 8), np.uint32), np.zeros((1, 8), np.uint32), np.ones(1, np.float32),
        np.ones(1, bool)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_on_a_host_without_gpu(no_gpu, ccfg, name):
    ccfg_t = bridge.classifier_config_from_reference(ccfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](ccfg_t, ccfg_t.arch)


# --------------------------------------------------------------------------
# the kernel's arithmetic: split fp32 (3xTF32) on the tensor cores
# --------------------------------------------------------------------------

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


def _partials_tf32(q, k, v, pq, pk, L, passes):
    """The kernel's chunked partials (BH layout, Gq 1) with every product in
    emulated TF32; den rides through the products as a column of ones (the
    kernel sums den on the fp32 cores, which is no less accurate)."""
    BH, T, d = q.shape
    dv = v.shape[-1]
    va = torch.cat([v, torch.ones(BH, T, 1)], dim=-1)
    state = torch.zeros(BH, pq.shape[-1], dv + 1)  # (S | Z)
    idx = torch.arange(L)
    causal = (idx[:, None] >= idx[None, :]).float()
    out = []
    for c in range(T // L):
        sl = slice(c * L, (c + 1) * L)
        p = torch.exp(_tf32_mm(q[:, sl], k[:, sl].transpose(1, 2), passes) * (1 / d ** 0.5))
        acc = _tf32_mm(p * causal, va[:, sl], passes)
        if c > 0:
            acc = acc + _tf32_mm(pq[:, sl], state, passes)
        if c + 1 < T // L:
            state = state + _tf32_mm(pk[:, sl].transpose(1, 2), va[:, sl], passes)
        out.append(acc)
    out = torch.cat(out, dim=1)
    return out[..., :dv], out[..., dv]


def test_split_fp32_keeps_the_kernel_tolerance_and_one_tf32_pass_does_not():
    """Why csrc/chimera_attention.cu runs 3xTF32: at BH 8, T 256, m 256, d 64,
    L 64, split fp32 stays within the tolerance the card's kernel is held to
    (chip_smoke's ATTN_ATOL 1e-4 + RTOL 1e-4 * |ref|) of the fp32 plain
    version; a single TF32 pass does not."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    atol, rtol = chip_smoke.ATTN_ATOL, chip_smoke.RTOL
    xs = [_t(x) for x in _partials_inputs(seed=11, B=4, Hkv=2, T=256, d=64, dv=64, m=256)]
    num_ref, den_ref = (x.flatten(0, 2) for x in cops.chimera_attention_partials_plain(*xs, 64))
    flat = [x.flatten(0, 1) if i in (1, 2, 4) else x.flatten(0, 2) for i, x in enumerate(xs)]
    beyond = {}
    for passes in (3, 1):
        num, den = _partials_tf32(*flat, 64, passes)
        beyond[passes] = sum(int(((got - want).abs() > atol + rtol * want.abs()).sum())
                             for got, want in ((num, num_ref), (den, den_ref)))
    assert beyond[3] == 0, f"split fp32: {beyond[3]} entries beyond the tolerance"
    assert beyond[1] > 0, "one TF32 pass stayed within the tolerance"


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_chimera_attention_kernel_matches_plain_on_card(cuda):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    chip_smoke.check_chimera(timed=False)
    chip_smoke.check_chimera_grads()


@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 32, 64, 128])
@pytest.mark.parametrize("use_local,use_stream", [(True, True), (True, False), (False, True),
                                                  (False, False)])
def test_chimera_attention_kernel_edge_shapes_on_card(cuda, L, use_local, use_stream):
    """Gq 2, one chunk (T = L) and four, against the plain version."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    for T in (L, 4 * L):
        chip_smoke.check_chimera_edge(L, T, use_local, use_stream)
