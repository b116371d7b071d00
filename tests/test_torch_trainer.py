"""The port's Trainer, its launcher and what they call, against the JAX
package, on the CPU.

Tiny widths (the conftest's arch: 2 layers, d 32, 2 heads, d_head 16, L
16, n_global 8, m 16; the codebook map with 8 centroids).  JAX's
parameters and optimizer state cross with ``bridge.params_from_jax`` and
are assigned to ``tr.params`` / ``tr.opt_state`` before ``run()``.

* The codebook feature map: ``init`` shapes; ``apply`` and
  ``assign_codes`` against JAX (codes equal wherever the top-2 gap of
  ``‖c‖² − 2x·c`` exceeds ``CODE_MARGIN``; no flip above it, the flips
  below it counted); ``compile_codebook`` with the same key (centroids
  within 1e-6, float tables within 1e-5, fixed-point tables within one
  LSB); ``quantize_per_channel`` at 8 and 16 bits bit for bit.
* ``Checkpointer.restore(target)`` and its mismatch errors;
  ``StragglerDetector`` and ``ElasticPlanner`` as ``tests/test_infra.py``
  holds JAX's.
* The trainer: the JAX package's three trainer tests run on the port
  (loss decreases; a resumed run equals the direct one within 1e-6;
  two-timescale installs with ``churn_ok``); per-step losses against a
  live JAX ``Trainer`` within rtol ``LOSS_RTOL``, with the LM objective
  and with a custom ``loss_fn``; the controller's
  history against a live JAX run (steps, ``installed``, ``churn_ok``
  equal, ``delta_map`` within rtol ``DELTA_RTOL``); a JAX ``Trainer``'s
  checkpoint resumed by the port's, both runs' final parameters within
  ``RESUME_ATOL``; an integer codebook table refused by both packages'
  gradients; ``launch/train.py --smoke --device cpu``.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feature_maps as JF
from repro.core import quantization as JQ
from repro.core.two_timescale import TwoTimescaleConfig as JTwoTimescaleConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.optim.optimizer import AdamWConfig as JAdamWConfig
from repro.runtime.fault_tolerance import ElasticPlanner as JElasticPlanner
from repro.runtime.fault_tolerance import StragglerDetector as JStragglerDetector
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import feature_maps as TF
from repro_torch.core import quantization as TQ
from repro_torch.core.two_timescale import (
    TwoTimescaleConfig,
    TwoTimescaleController,
    delta_map,
    kmeans,
    prng_key,
)
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import train as LT
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.runtime.fault_tolerance import ElasticPlanner, StragglerDetector
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.train_step import value_and_grad

CODE_MARGIN = 1e-4  # top-2 gap of the assignment scores (|scores| ~ 10)
LOSS_RTOL = 1e-5  # per-step losses over 10-25 steps (seen: 2.2e-7)
DELTA_RTOL = 1e-5  # delta_map of each recluster (seen: 8.4e-8)
RESUME_ATOL = 1e-5  # parameters after 5 steps in each package (seen: ~1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's and XLA's CPU thread pools contend in one process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _codebook(arch, **fm):
    return dataclasses.replace(arch, chimera=dataclasses.replace(
        arch.chimera, feature_map=JF.FeatureMapConfig(kind="codebook", m=16, codebook_size=8,
                                                      **fm)))


def _port_trainer(arch, tmp, steps, stream_seed, batch=4, seq=17, two_timescale=None,
                  opt=None, **kw):
    tcfg = TrainerConfig(total_steps=steps, log_every=1, ckpt_dir=str(tmp),
                         two_timescale=two_timescale, **{"ckpt_every": 100, **kw})
    return Trainer(bridge.arch_from_reference(arch), tcfg,
                   TokenStream(arch.vocab_size, batch, seq, seed=stream_seed),
                   opt_cfg=opt or AdamWConfig(lr=1e-3), device="cpu")


def _jax_trainer(arch, tmp, steps, stream_seed, batch=4, seq=17, two_timescale=None, opt=None,
                 **kw):
    tcfg = JTrainerConfig(total_steps=steps, log_every=1, ckpt_dir=str(tmp),
                          two_timescale=two_timescale, **{"ckpt_every": 100, **kw})
    return JTrainer(arch, tcfg, JTokenStream(arch.vocab_size, batch, seq, seed=stream_seed),
                    opt_cfg=opt or JAdamWConfig(lr=1e-3))


def _carry(tr_t, tr_j):
    """Start the port's trainer from the JAX trainer's parameters and state."""
    tr_t.params = bridge.params_from_jax(_np_tree(tr_j.params), device="cpu")
    tr_t.opt_state = bridge.params_from_jax(_np_tree(tr_j.opt_state), device="cpu")


# --------------------------------------------------------------------------
# the codebook feature map and per-channel quantization
# --------------------------------------------------------------------------

def test_codebook_init_shapes_match_jax():
    for bits in (0, 8):
        cj = JF.FeatureMapConfig(kind="codebook", m=24, codebook_size=32, codebook_bits=bits)
        ct = TF.FeatureMapConfig(kind="codebook", m=24, codebook_size=32, codebook_bits=bits)
        pj = _np_tree(JF.init_feature_map(cj, 16, jax.random.PRNGKey(0)))
        pt = TF.init_feature_map(ct, 16, torch.Generator().manual_seed(0))
        assert {k: (v.shape, str(v.dtype)) for k, v in pj.items()} == {
            k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in pt.items()}
        assert float(pt["table"].min()) > 0.0  # elu + 1
        assert TF.phi_norm_bound(ct, 16) == JF.phi_norm_bound(cj, 16)


def _scores(centroids, x):
    c = centroids.astype(np.float64)
    return np.sum(c * c, axis=-1) - 2.0 * x.astype(np.float64) @ c.T


@pytest.mark.parametrize("bits", [0, 8])
def test_codebook_apply_and_assign_codes_match_jax(bits):
    rng = np.random.default_rng(bits)
    d, m, K = 16, 16, 64
    cj = JF.FeatureMapConfig(kind="codebook", m=m, codebook_size=K, codebook_bits=bits)
    ct = TF.FeatureMapConfig(kind="codebook", m=m, codebook_size=K, codebook_bits=bits)
    params = _np_tree(JF.init_feature_map(cj, d, jax.random.PRNGKey(bits)))
    if bits:  # a fixed-point table, as compile_codebook stores it
        qt = JQ.quantize_per_channel(jnp.asarray(params["table"]), bits, axis=None)
        params.update(table=np.asarray(qt.values), table_scale=np.asarray(qt.scale))
    tparams = bridge.params_from_jax(params, device="cpu")
    assert tparams["table"].dtype == (torch.int8 if bits else torch.float32)
    x = rng.standard_normal((4, 256, d)).astype(np.float32)
    xh = 2.0 * x / np.linalg.norm(x, axis=-1, keepdims=True)
    codes_j = np.asarray(JF.assign_codes(jnp.asarray(params["centroids"]), jnp.asarray(xh)))
    codes_t = TF.assign_codes(tparams["centroids"], torch.from_numpy(xh)).numpy()
    s = np.sort(_scores(params["centroids"], xh), axis=-1)
    sure = (s[..., 1] - s[..., 0]) > CODE_MARGIN
    flips = codes_j != codes_t
    assert not (flips & sure).any()
    print(f"code flips below the {CODE_MARGIN:g} margin: {int(flips.sum())} of {flips.size}")
    phi_j = np.asarray(JF.apply_feature_map(cj, params, jnp.asarray(x)))
    phi_t = TF.apply_feature_map(ct, tparams, torch.from_numpy(x)).numpy()
    same = codes_j == codes_t
    np.testing.assert_array_equal(phi_t[same], phi_j[same])


@pytest.mark.parametrize("bits", [0, 8, 16])
def test_compile_codebook_matches_jax_with_the_same_key(bits):
    rng = np.random.default_rng(10 + bits)
    d, m, K = 16, 16, 32
    base_j = JF.FeatureMapConfig(kind="exp_prf", m=m)
    base_params = _np_tree(JF.init_feature_map(base_j, d, jax.random.PRNGKey(1)))
    samples = rng.standard_normal((512, d)).astype(np.float32)
    cj = JF.FeatureMapConfig(kind="codebook", m=m, codebook_size=K, codebook_bits=bits)
    got = TF.compile_codebook(
        TF.FeatureMapConfig(kind="codebook", m=m, codebook_size=K, codebook_bits=bits),
        TF.FeatureMapConfig(kind="exp_prf", m=m), bridge.params_from_jax(base_params, "cpu"),
        torch.from_numpy(samples), prng_key(3), kmeans_iters=6)
    want = _np_tree(JF.compile_codebook(cj, base_j, base_params, jnp.asarray(samples),
                                        jax.random.PRNGKey(3), kmeans_iters=6))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in got.items()}
    np.testing.assert_allclose(got["centroids"].numpy(), want["centroids"], atol=1e-6)
    if bits:  # one LSB where the float table sits on a rounding boundary
        np.testing.assert_array_less(
            np.abs(got["table"].numpy().astype(np.int64) - want["table"]), 2)
        np.testing.assert_allclose(got["table_scale"].numpy(), want["table_scale"], rtol=1e-5)
    else:
        np.testing.assert_allclose(got["table"].numpy(), want["table"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("axis", [-1, 0, None])
def test_quantize_per_channel_matches_jax(bits, axis):
    x = np.random.default_rng(bits).standard_normal((32, 24)).astype(np.float32) * 3.0
    x[3, 4] = 0.0
    qj = JQ.quantize_per_channel(jnp.asarray(x), bits, axis=axis)
    qt = TQ.quantize_per_channel(torch.from_numpy(x), bits, axis=axis)
    assert qt.values.dtype == {8: torch.int8, 16: torch.int16}[bits]
    np.testing.assert_array_equal(qt.values.numpy(), np.asarray(qj.values))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    np.testing.assert_array_equal(qt.dequantize().numpy(), np.asarray(qj.dequantize()))


def test_integer_leaves_refuse_gradients_in_both_packages():
    """jax.value_and_grad refuses a tree with an integer leaf; the port does too."""
    tree = {"a": np.ones(3, np.float32), "t": np.ones(3, np.int8)}

    def loss(p):
        return (p["a"] * p["t"].astype(p["a"].dtype)).sum(), {}

    with pytest.raises(TypeError, match="int8"):
        jax.value_and_grad(loss, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))
    with pytest.raises(TypeError, match="int8"):
        value_and_grad(lambda p: ((p["a"] * p["t"].float()).sum(), {}),
                       bridge.params_from_jax(tree, device="cpu"))


# --------------------------------------------------------------------------
# Checkpointer.restore onto a target tree
# --------------------------------------------------------------------------

def test_checkpointer_restores_onto_a_target_tree(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn((3, 4), generator=g), "b": torch.randn((4,), generator=g),
                       "q": torch.tensor([[-3, 7]], dtype=torch.int8)},
            "opt": {"step": torch.tensor(5, dtype=torch.int32)}}
    ck = Checkpointer(str(tmp_path))
    ck.save(5, tree, extra={"data_state": {"step": 5}}, blocking=True)
    target = {"params": {"w": torch.zeros(3, 4, dtype=torch.float64), "b": torch.zeros(4),
                         "q": torch.zeros((1, 2), dtype=torch.int8)},
              "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    got, extra, step = ck.restore(target)
    assert step == 5 and extra == {"data_state": {"step": 5}}
    for (path, a), (_, b) in zip(_leaves(got), _leaves(tree)):
        assert a.dtype == dict(_leaves(target))[path].dtype, path
        np.testing.assert_array_equal(a.numpy(), b.to(a.dtype).numpy())
    assert got["opt"]["step"].dtype == torch.int32 and got["params"]["q"].dtype == torch.int8
    nested, _, _ = ck.restore(step=5)  # no target: nested dicts of numpy arrays
    np.testing.assert_array_equal(nested["params"]["w"], tree["params"]["w"].numpy())


@pytest.mark.parametrize("change", ["leaves", "shape", "name"])
def test_checkpointer_restore_refuses_a_mismatched_target(tmp_path, change):
    tree = {"a": torch.zeros(2, 3), "b": torch.zeros(4)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree, blocking=True)
    bad = {"leaves": {"a": torch.zeros(2, 3)},
           "shape": {"a": torch.zeros(3, 2), "b": torch.zeros(4)},
           "name": {"a": torch.zeros(2, 3), "c": torch.zeros(4)}}[change]
    with pytest.raises(ValueError, match="leaves" if change == "leaves" else "target"):
        ck.restore(bad)


# --------------------------------------------------------------------------
# fault tolerance: the trainer's side (tests/test_infra.py's cases)
# --------------------------------------------------------------------------

def test_straggler_detection_and_mitigation_match_jax():
    dets = (StragglerDetector(threshold=1.5, patience=2), JStragglerDetector(threshold=1.5,
                                                                            patience=2))
    outs = []
    for sd in dets:
        for _ in range(5):
            for w in range(4):
                sd.record(w, 1.0 if w != 2 else 3.0)
            out = sd.stragglers()
        outs.append((out, sd.mitigation(2), sd.mitigation(0)))
    assert outs[0] == outs[1]
    assert outs[0][0] == [2] and outs[0][1] in ("reshard-away", "evict-and-shrink")
    assert outs[0][2] == "monitor"


@pytest.mark.parametrize("failed", [[3, 7], list(range(200)), [1]])
def test_elastic_plan_matches_jax(failed):
    plan = ElasticPlanner(model_parallel=16, pods=2, data=16).plan_after_failures(
        failed, devices_per_worker=4)
    want = JElasticPlanner(model_parallel=16, pods=2, data=16).plan_after_failures(
        failed, devices_per_worker=4)
    assert dataclasses.asdict(plan) == dataclasses.asdict(want) and plan.valid == want.valid
    if plan.valid:
        assert plan.mesh_shape[2] == 16 and plan.n_devices < 512  # TP axis intact
        assert "grad accumulation" in plan.note
        regrown = ElasticPlanner(16, 2, 16).regrow(plan, 1)
        assert dataclasses.asdict(regrown) == dataclasses.asdict(
            JElasticPlanner(16, 2, 16).regrow(want, 1))
    else:
        assert len(failed) == 200


# --------------------------------------------------------------------------
# the trainer: tests/test_training_serving.py's three, on the port
# --------------------------------------------------------------------------

def test_loss_decreases(tmp_path, tiny_arch):
    tr = _port_trainer(tiny_arch, tmp_path, 50, stream_seed=1, batch=8, seq=33,
                       opt=AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=150))
    out = tr.run()
    first, last = out["log"][0]["loss"], out["log"][-1]["loss"]
    assert last < first - 0.1, f"no learning: {first} -> {last}"
    assert tr.stragglers.stragglers() == [] and tr.heartbeats.laggards() == []


def test_checkpoint_resume_is_exact(tmp_path, tiny_arch):
    t1 = _port_trainer(tiny_arch, tmp_path / "a", 10, stream_seed=2, ckpt_every=5)
    t1.run(steps=10)
    # crash after step 5, restore, continue to 10
    t2 = _port_trainer(tiny_arch, tmp_path / "b", 10, stream_seed=2, ckpt_every=5)
    t2.run(steps=5)
    t3 = _port_trainer(tiny_arch, tmp_path / "b", 10, stream_seed=2, ckpt_every=5)
    assert t3.step == 5 and t3.stream.step == 5  # restored, data stream included
    t3.run(steps=10)
    for (path, a), (_, b) in zip(_leaves(t1.params), _leaves(t3.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=str(path))
    assert int(t3.opt_state["step"]) == 10


def test_two_timescale_installs(tmp_path, tiny_arch):
    cfg = _codebook(tiny_arch)
    tr = _port_trainer(cfg, tmp_path, 25, stream_seed=3,
                       two_timescale=TwoTimescaleConfig(t_cp_steps=10, tau_map=1e-4))
    before = tr.params["blocks"]["b0"]["attn"]["chimera"]["fm"]["centroids"].clone()
    # beside every recluster, the host path: the numpy reservoir clustered
    # by kmeans on the CPU, and delta_map against host centroids
    real, seen = tr.controller.maybe_recluster, []

    def recluster(step, centroids, occupancy, key):
        got = real(step, centroids, occupancy, key)
        assert got[0].device == tr.device  # k-means on the trainer's device
        if got[1] is not None:
            ctl = tr.controller
            want, _ = kmeans(np.concatenate(ctl._reservoir), ctl.n_centroids,
                             ctl.cfg.kmeans_iters, key)
            seen.append((got, want, delta_map(centroids.cpu(), want)))
        return got

    tr.controller.maybe_recluster = recluster
    tr.run()
    assert len(seen) == len(tr.controller.history) == 2
    for (cent, rec), want, dm in seen:
        assert rec.delta_map == dm and rec.installed == (dm > 1e-4)
        if rec.installed:
            assert torch.equal(cent, want)
    assert tr.controller is not None
    assert len(tr.controller.history) >= 1
    assert any(r.installed for r in tr.controller.history)
    assert all(r.churn_ok for r in tr.controller.history)  # Eq. 18
    cent = tr.params["blocks"]["b0"]["attn"]["chimera"]["fm"]["centroids"]
    assert not torch.equal(cent, before)
    assert all(torch.equal(cent[i], cent[0]) for i in range(cent.shape[0]))  # broadcast


def _recluster_once(device, feats, cfg):
    ctl = TwoTimescaleController(cfg, 8)
    for f in feats:
        ctl.observe(f)
    return ctl.maybe_recluster(cfg.t_cp_steps, torch.zeros((8, feats[0].shape[1]), device=device),
                               None, prng_key(cfg.t_cp_steps))


def test_controller_clusters_where_the_centroids_lie():
    g = np.random.default_rng(5)
    feats = [(g.normal(size=(40, 16)) + 2.0 * g.integers(0, 4, size=(40, 1))).astype(np.float32)
             for _ in range(3)]
    cfg = TwoTimescaleConfig(t_cp_steps=2, tau_map=1e-4)
    cent, rec = _recluster_once("cpu", feats, cfg)
    want, _ = kmeans(np.concatenate(feats), 8, cfg.kmeans_iters, prng_key(2))
    assert cent.device == torch.device("cpu") and torch.equal(cent, want)
    assert rec.installed and rec.delta_map == delta_map(torch.zeros((8, 16)), want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_controller_on_the_card_matches_the_host_path(cuda):
    """The same recluster on the card and on the CPU: centroids within 1e-5
    (no farthest-point pick here is a near tie that another summation
    order could flip)."""
    g = np.random.default_rng(5)
    feats = [(g.normal(size=(40, 16)) + 2.0 * g.integers(0, 4, size=(40, 1))).astype(np.float32)
             for _ in range(3)]
    cfg = TwoTimescaleConfig(t_cp_steps=2, tau_map=1e-4)
    cent, rec = _recluster_once(cuda, feats, cfg)
    want, host = _recluster_once("cpu", feats, cfg)
    assert cent.device.type == "cuda" and rec.installed == host.installed
    np.testing.assert_allclose(cent.cpu().numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert rec.delta_map == pytest.approx(host.delta_map, rel=1e-5)


# --------------------------------------------------------------------------
# the trainer against a live JAX Trainer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_lm_run(tiny_arch, tmp_path_factory):
    """A JAX Trainer's 10 steps (checkpoints at 5 and 10), with its start."""
    tmp = tmp_path_factory.mktemp("jax_lm")
    tr = _jax_trainer(tiny_arch, tmp, 10, stream_seed=4, ckpt_every=5,
                      opt=JAdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30))
    start = (_np_tree(tr.params), _np_tree(tr.opt_state))
    out = tr.run()
    return tr, start, out, tmp


def test_losses_match_a_live_jax_trainer(tmp_path, tiny_arch, jax_lm_run):
    tr_j, (params, opt), out_j, _ = jax_lm_run
    tr = _port_trainer(tiny_arch, tmp_path, 10, stream_seed=4,
                       opt=AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30))
    tr.params = bridge.params_from_jax(params, device="cpu")
    tr.opt_state = bridge.params_from_jax(opt, device="cpu")
    out = tr.run()
    assert [r["step"] for r in out["log"]] == [r["step"] for r in out_j["log"]]
    for k in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose([r[k] for r in out["log"]], [r[k] for r in out_j["log"]],
                                   rtol=LOSS_RTOL, err_msg=k)


def test_port_resumes_a_jax_trainer_checkpoint(tmp_path, tiny_arch, jax_lm_run):
    tr_j, _, _, jdir = jax_lm_run
    shutil.copytree(jdir / "step_00000005", tmp_path / "step_00000005")
    tr = _port_trainer(tiny_arch, tmp_path, 10, stream_seed=4,
                       opt=AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30))
    assert tr.step == 5 and tr.stream.step == 5
    assert tr.opt_state["step"].dtype == torch.int32 and int(tr.opt_state["step"]) == 5
    tr.run()
    want = dict(_leaves(_np_tree(tr_j.params)))
    for path, a in _leaves(tr.params):
        np.testing.assert_allclose(a.numpy(), want[path], atol=RESUME_ATOL, err_msg=str(path))


def test_custom_loss_fn_matches_a_live_jax_trainer(tmp_path, tiny_arch):
    """The loss_fn route: half the next-token NLL (no z-loss), both packages."""
    from repro.models import model as JM
    from repro_torch.models import model as TM

    arch_t = bridge.arch_from_reference(tiny_arch)

    def half_nll(loss_fn, cfg):
        def fn(params, batch):
            _, metrics = loss_fn(cfg, params, batch)
            return 0.5 * metrics["nll"], {"nll": metrics["nll"]}
        return fn

    kw = dict(total_steps=3, log_every=1, ckpt_every=100)
    tr_j = JTrainer(tiny_arch, JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **kw),
                    JTokenStream(tiny_arch.vocab_size, 4, 17, seed=6),
                    opt_cfg=JAdamWConfig(lr=1e-3), loss_fn=half_nll(JM.loss_fn, tiny_arch))
    tr = Trainer(arch_t, TrainerConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                 TokenStream(tiny_arch.vocab_size, 4, 17, seed=6), opt_cfg=AdamWConfig(lr=1e-3),
                 loss_fn=half_nll(TM.loss_fn, arch_t), device="cpu")
    _carry(tr, tr_j)
    out_j, out = tr_j.run(), tr.run()
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose([r[k] for r in out["log"]], [r[k] for r in out_j["log"]],
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose([r["loss"] for r in out["log"]],
                               [0.5 * r["nll"] for r in out["log"]], rtol=1e-6)


def test_controller_history_matches_a_live_jax_run(tmp_path, tiny_arch):
    cfg = _codebook(tiny_arch)
    tt = dict(t_cp_steps=10, tau_map=1e-4)
    tr_j = _jax_trainer(cfg, tmp_path / "j", 25, stream_seed=3,
                        two_timescale=JTwoTimescaleConfig(**tt))
    tr = _port_trainer(cfg, tmp_path / "t", 25, stream_seed=3,
                       two_timescale=TwoTimescaleConfig(**tt))
    _carry(tr, tr_j)
    out_j, out = tr_j.run(), tr.run()
    np.testing.assert_allclose([r["loss"] for r in out["log"]],
                               [r["loss"] for r in out_j["log"]], rtol=LOSS_RTOL)
    hj, ht = tr_j.controller.history, tr.controller.history
    assert [(r.step, r.installed, r.churn_ok, r.n_entries) for r in ht] == [
        (r.step, r.installed, r.churn_ok, r.n_entries) for r in hj]
    assert any(r.installed for r in ht)
    np.testing.assert_allclose([r.delta_map for r in ht], [r.delta_map for r in hj],
                               rtol=DELTA_RTOL)
    cent_j = np.asarray(tr_j.params["blocks"]["b0"]["attn"]["chimera"]["fm"]["centroids"])
    np.testing.assert_allclose(
        tr.params["blocks"]["b0"]["attn"]["chimera"]["fm"]["centroids"].numpy(), cent_j,
        atol=RESUME_ATOL)


def test_integer_codebook_table_refuses_training_in_both_packages(tmp_path, tiny_arch):
    """A compiled 8-bit codebook in the tree: both trainers' first step
    raises TypeError (jax.value_and_grad's refusal of integer leaves)."""
    cfg = _codebook(tiny_arch, codebook_bits=8)
    tr_j = _jax_trainer(cfg, tmp_path / "j", 2, stream_seed=5)
    fm = tr_j.params["blocks"]["b0"]["attn"]["chimera"]["fm"]
    qt = JQ.quantize_per_channel(fm["table"], 8, axis=None)
    fm["table"] = qt.values
    tr = _port_trainer(cfg, tmp_path / "t", 2, stream_seed=5)
    tr.params = bridge.params_from_jax(_np_tree(tr_j.params), device="cpu")
    assert tr.params["blocks"]["b0"]["attn"]["chimera"]["fm"]["table"].dtype == torch.int8
    with pytest.raises(TypeError, match="int8"):
        tr_j.run()
    with pytest.raises(TypeError, match="int8"):
        tr.run()


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_smoke_on_cpu_trains_and_resumes(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)]
    out = LT.main(argv)
    assert out["step"] == 4 and [r["step"] for r in out["log"]] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in out["log"])
    assert capsys.readouterr().out.count("loss") == 4
    assert Checkpointer(str(tmp_path)).latest_step() == 4
    again = LT.main(argv)  # resumes at step 4: nothing left to train
    assert again["step"] == 4 and again["log"] == []
    args = LT.parse_args([])
    assert (args.arch, args.steps, args.batch, args.seq, args.lr, args.device) == (
        "chimera-dataplane", 100, 8, 128, 3e-4, "cuda")
    assert "repro_torch_ckpt" in args.ckpt_dir


def test_trainer_without_device_raises_on_a_host_without_gpu(tmp_path, tiny_arch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(bridge.arch_from_reference(tiny_arch), TrainerConfig(ckpt_dir=str(tmp_path)),
                TokenStream(tiny_arch.vocab_size, 2, 17))
