"""The port's Mamba and xLSTM blocks against the JAX package, on the CPU:
``mamba_layer`` (whole chunks and a ragged tail, with and without the decode
cache, continued from a cache), ``mamba_decode`` step by step, the mLSTM and
sLSTM layers and decode steps, then the smoke configs of Jamba-1.5-Large
(Mamba, Chimera attention, MoE) and xLSTM-125M through ``forward``,
``prefill_with_caches``, ``decode_step``, ``ServeEngine`` (submit/step with
a refilled slot, and ``prefill_batch``) and the LM launcher; the bridge's
new leaves; the bridge crossing the enc-dec stack; the Jamba cut that the
card serves.

The same inputs, made with numpy from a seed or drawn by the JAX package and
carried through ``bridge.py``, go through both packages.  The JAX package
scans each chunk with ``associative_scan``, the port token by token, so
the sums run in other orders.  Tolerances: layer outputs and caches within
1e-5 abs + 1e-4 rel; logits within 1e-4 abs (the JAX package's own
``test_fast_prefill.py`` holds its prefill to decode at 1e-4); greedy
generations identical up to a near-tie, a top-2 logit margin of 1e-4 or
less.
"""

import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.configs import smoke_config as j_smoke
from repro.models import mamba as JMa
from repro.models import model as JM
from repro.models import xlstm as JX
from repro.serve import engine as JE
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as TL
from repro_torch.models import mamba as TMa
from repro_torch.models import model as TM
from repro_torch.models import xlstm as TX
from repro_torch.optim.optimizer import tree_map
from repro_torch.serve import engine as TE

ATOL, RTOL = 1e-5, 1e-4  # layer outputs and caches
LOGIT_TOL = 1e-4
MARGIN = 1e-4  # a top-2 logit margin at or below it is a near-tie
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


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def _caches_close(got, want, msg=""):
    assert got.keys() == want.keys(), msg
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, f"{msg} {k}"
        _close(got[k], want[k], msg=f"{msg} {k}")


def _x(T, d, seed, B=2):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(np.float32)


def _block(name, init, seed=0):
    """(JAX config, JAX block params, port config, port block params)."""
    jcfg = j_smoke(name)
    jp, _ = init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, bridge.arch_from_reference(jcfg), bridge.params_from_jax(_np(jp),
                                                                            device="cpu")


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_block():
    return _block(JAMBA, JMa.init_mamba)


@pytest.mark.parametrize("T", [24, 27])  # whole chunks of 8, and a ragged tail
def test_mamba_layer_matches_jax(mamba_block, T):
    jcfg, jp, tcfg, tp = mamba_block
    x = _x(T, jcfg.d_model, seed=T)
    _close(TMa.mamba_layer(tcfg, tp, _t(x)), JMa.mamba_layer(jcfg, jp, jnp.asarray(x)))
    y_j, c_j = JMa.mamba_layer(jcfg, jp, jnp.asarray(x), return_cache=True)
    y_t, c_t = TMa.mamba_layer(tcfg, tp, _t(x), return_cache=True)
    _close(y_t, y_j)
    _caches_close(c_t, c_j, "mamba cache")


@pytest.mark.parametrize("T0,T1", [(16, 11), (13, 2)])  # the second segment: long, and
def test_mamba_layer_continues_from_a_cache_as_jax(mamba_block, T0, T1):  # shorter than the conv
    jcfg, jp, tcfg, tp = mamba_block
    x = _x(T0 + T1, jcfg.d_model, seed=T0)
    _, c_j = JMa.mamba_layer(jcfg, jp, jnp.asarray(x[:, :T0]), return_cache=True)
    y_j, c2_j = JMa.mamba_layer(jcfg, jp, jnp.asarray(x[:, T0:]), return_cache=True,
                                init_cache=c_j)
    _, c_t = TMa.mamba_layer(tcfg, tp, _t(x[:, :T0]), return_cache=True)
    y_t, c2_t = TMa.mamba_layer(tcfg, tp, _t(x[:, T0:]), return_cache=True, init_cache=c_t)
    _close(y_t, y_j)
    _caches_close(c2_t, c2_j, "continued cache")
    # and the two segments together are the whole sequence in one call
    _close(torch.cat([TMa.mamba_layer(tcfg, tp, _t(x[:, :T0])), y_t], 1),
           TMa.mamba_layer(tcfg, tp, _t(x)).numpy())


def test_mamba_decode_step_by_step_matches_jax(mamba_block):
    """From the zero cache and from a prefill's cache, 6 steps each; the
    cache (float32, as the engine keeps it) leaf by leaf after each."""
    jcfg, jp, tcfg, tp = mamba_block
    x = _x(18, jcfg.d_model, seed=3)
    for T0 in (0, 12):
        if T0:
            _, c_j = JMa.mamba_layer(jcfg, jp, jnp.asarray(x[:, :T0]), return_cache=True)
            c_t = {k: _t(v).clone() for k, v in _np(c_j).items()}
        else:
            c_j = JMa.init_mamba_cache(jcfg, 2, jnp.float32)
            c_t = TMa.init_mamba_cache(tcfg, 2, torch.float32)
        for t in range(T0, T0 + 6):
            y_j, c_j = JMa.mamba_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), c_j)
            y_t = TMa.mamba_decode(tcfg, tp, _t(x[:, t:t + 1]), c_t)
            _close(y_t, y_j, msg=f"step {t}")
            _caches_close(c_t, c_j, f"step {t}")


def test_mamba_cache_layout_and_dtypes_match_jax():
    jcfg = j_smoke(JAMBA)
    tcfg = bridge.arch_from_reference(jcfg)
    want = JMa.init_mamba_cache(jcfg, 3)
    got = TMa.init_mamba_cache(tcfg, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (v.shape, torch.bfloat16) for k, v in want.items()}
    assert all(v.dtype == jnp.bfloat16 for v in want.values())


def test_bfloat16_input_runs_as_jax_would_on_its_float32_values(mamba_block):
    """The JAX package's scans refuse a bfloat16 input (their carry starts in
    x's dtype and the body promotes it to float32); the port carries the
    promoted state, so it computes what JAX computes on the same values in
    float32, and its cache is float32."""
    jcfg, jp, tcfg, tp = mamba_block
    xb = _t(_x(24, jcfg.d_model, seed=5)).to(torch.bfloat16)
    with pytest.raises(TypeError, match="carry"):
        JMa.mamba_layer(jcfg, jp, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    y_t, c_t = TMa.mamba_layer(tcfg, tp, xb, return_cache=True)
    y_j, c_j = JMa.mamba_layer(jcfg, jp, jnp.asarray(xb.float().numpy()), return_cache=True)
    assert y_t.dtype == c_t["h"].dtype == c_t["conv"].dtype == torch.float32
    _close(y_t, y_j)
    _caches_close(c_t, c_j)


# --------------------------------------------------------------------------
# xLSTM
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mlstm_block():
    return _block(XLSTM, JX.init_mlstm)


@pytest.fixture(scope="module")
def slstm_block():
    return _block(XLSTM, JX.init_slstm, seed=1)


@pytest.mark.parametrize("T", [32, 27])  # whole chunks of 16, and a ragged tail
def test_mlstm_layer_matches_jax(mlstm_block, T):
    jcfg, jp, tcfg, tp = mlstm_block
    assert tcfg.chimera.chunk_size == 16
    x = _x(T, jcfg.d_model, seed=T)
    _close(TX.mlstm_layer(tcfg, tp, _t(x)), JX.mlstm_layer(jcfg, jp, jnp.asarray(x)))
    y_j, c_j = JX.mlstm_layer(jcfg, jp, jnp.asarray(x), return_cache=True)
    y_t, c_t = TX.mlstm_layer(tcfg, tp, _t(x), return_cache=True)
    _close(y_t, y_j)
    _caches_close(c_t, c_j, "mlstm cache")


def test_mlstm_chunk_where_jax_overflows_is_finite_and_equals_decode(mlstm_block):
    """Forget gates near 0 (log f ~ -30 a token): above the diagonal of a
    chunk of 16 the decay exponent reaches ~450, whose exp overflows, and
    JAX's exp-then-mask returns NaN; the port masks first, and its chunked
    layer equals its own token-by-token recurrence (which has no such
    exponent)."""
    jcfg, jp, tcfg, tp = mlstm_block
    H = jcfg.n_heads
    jp = dict(jp, w_if=dict(jp["w_if"], b=jnp.concatenate([jnp.zeros(H), jnp.full(H, -30.0)])))
    tp = dict(tp, w_if=dict(tp["w_if"], b=_t(np.asarray(jp["w_if"]["b"]))))
    x = _x(32, jcfg.d_model, seed=12)
    assert bool(jnp.isnan(JX.mlstm_layer(jcfg, jp, jnp.asarray(x))).any())
    y = TX.mlstm_layer(tcfg, tp, _t(x))
    cache = TX.init_mlstm_cache(tcfg, 2, torch.float32)
    seq = torch.cat([TX.mlstm_decode(tcfg, tp, _t(x[:, t:t + 1]), cache) for t in range(32)], 1)
    assert bool(torch.isfinite(y).all())
    _close(y, seq.numpy())


@pytest.mark.parametrize("T", [32, 27])
def test_slstm_layer_matches_jax(slstm_block, T):
    jcfg, jp, tcfg, tp = slstm_block
    x = _x(T, jcfg.d_model, seed=T + 1)
    _close(TX.slstm_layer(tcfg, tp, _t(x)), JX.slstm_layer(jcfg, jp, jnp.asarray(x)))
    y_j, c_j = JX.slstm_layer(jcfg, jp, jnp.asarray(x), return_cache=True)
    y_t, c_t = TX.slstm_layer(tcfg, tp, _t(x), return_cache=True)
    _close(y_t, y_j)
    _caches_close(c_t, c_j, "slstm cache")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_decode_step_by_step_matches_jax(mlstm_block, slstm_block, kind):
    """6 steps from a 20-token prefill's cache (float32), each cache leaf
    held after each step; and the layer's prefill equals its decode."""
    jcfg, jp, tcfg, tp = mlstm_block if kind == "mlstm" else slstm_block
    J = (JX.mlstm_layer, JX.mlstm_decode) if kind == "mlstm" else (JX.slstm_layer,
                                                                    JX.slstm_decode)
    T = TX.mlstm_decode if kind == "mlstm" else TX.slstm_decode
    x = _x(26, jcfg.d_model, seed=7)
    _, c_j = J[0](jcfg, jp, jnp.asarray(x[:, :20]), return_cache=True)
    c_t = {k: _t(v).clone() for k, v in _np(c_j).items()}
    for t in range(20, 26):
        y_j, c_j = J[1](jcfg, jp, jnp.asarray(x[:, t:t + 1]), c_j)
        y_t = T(tcfg, tp, _t(x[:, t:t + 1]), c_t)
        _close(y_t, y_j, msg=f"step {t}")
        _caches_close(c_t, c_j, f"step {t}")
    layer = TX.mlstm_layer if kind == "mlstm" else TX.slstm_layer
    init = TX.init_mlstm_cache if kind == "mlstm" else TX.init_slstm_cache
    cache = init(tcfg, 2, torch.float32)
    ys = [T(tcfg, tp, _t(x[:, t:t + 1]), cache) for t in range(26)]
    _close(torch.cat(ys, 1), layer(tcfg, tp, _t(x)).numpy())


def test_xlstm_cache_layouts_match_jax():
    jcfg = j_smoke(XLSTM)
    tcfg = bridge.arch_from_reference(jcfg)
    for J, T in ((JX.init_mlstm_cache, TX.init_mlstm_cache),
                 (JX.init_slstm_cache, TX.init_slstm_cache)):
        want, got = J(jcfg, 3), T(tcfg, 3)
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in
                                                                want.items()}
        assert all(v.dtype == torch.bfloat16 for v in got.values())


def test_slstm_bfloat16_input_runs_as_jax_would_on_its_float32_values(slstm_block):
    jcfg, jp, tcfg, tp = slstm_block
    xb = _t(_x(20, jcfg.d_model, seed=9)).to(torch.bfloat16)
    with pytest.raises(TypeError, match="carry"):
        JX.slstm_layer(jcfg, jp, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    y_t, c_t = TX.slstm_layer(tcfg, tp, xb, return_cache=True)
    y_j, c_j = JX.slstm_layer(jcfg, jp, jnp.asarray(xb.float().numpy()), return_cache=True)
    assert all(v.dtype == torch.float32 for v in c_t.values())
    _close(y_t, y_j)
    _caches_close(c_t, c_j)


# --------------------------------------------------------------------------
# the whole models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[JAMBA, XLSTM], ids=["jamba", "xlstm"])
def model(request):
    jcfg = j_smoke(request.param)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(2))
    return jcfg, params, bridge.arch_from_reference(jcfg), bridge.params_from_jax(
        _np(params), device="cpu")


def test_smoke_config_matches_jax(model):
    jcfg, _, tcfg, _ = model
    assert tcfg == smoke_config(jcfg.name)
    assert tcfg.param_count() == jcfg.param_count()
    assert [tcfg.layer_is_moe(j) for j in range(len(tcfg.pattern))] == [
        jcfg.layer_is_moe(j) for j in range(len(jcfg.pattern))]


def test_forward_and_loss_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 32))
    labels = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 32))
    lg_j, aux_j = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    lg_t, aux_t = TM.forward(tcfg, tparams, {"tokens": _t(toks).long()})
    _close(lg_t, lg_j, atol=LOGIT_TOL, rtol=0)
    _close(aux_t, aux_j, atol=LOGIT_TOL, rtol=0)
    batch = {"tokens": toks, "labels": labels}
    loss_j, _ = JM.loss_fn(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, _ = TM.loss_fn(tcfg, tparams, {k: _t(v).long() for k, v in batch.items()})
    _close(loss_t, loss_j, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("prompt_len", [24, 27])  # Jamba: whole Mamba chunks, and ragged
def test_prefill_and_decode_match_jax(model, prompt_len):
    """prefill_with_caches (logits and every cache leaf), then 8 decode steps
    from its caches, against the JAX package's."""
    jcfg, jparams, tcfg, tparams = model
    B, T = 2, prompt_len + 8
    toks = np.random.default_rng(prompt_len).integers(0, jcfg.vocab_size, (B, T))
    lg_j, c_j = JM.prefill_with_caches(jcfg, jparams, jnp.asarray(toks[:, :prompt_len]),
                                       max_len=T)
    lg_t, c_t = TM.prefill_with_caches(tcfg, tparams, _t(toks[:, :prompt_len]).long(),
                                       max_len=T)
    _close(lg_t, lg_j, atol=LOGIT_TOL, rtol=0)
    for j, kind in enumerate(tcfg.pattern):
        if kind != "attn":
            _caches_close(c_t[f"b{j}"], c_j[f"b{j}"], f"{kind} b{j}")
    step = jax.jit(lambda tok, pos, c: JM.decode_step(jcfg, jparams, tok, pos, c))
    for t in range(prompt_len, T):
        lg_j, c_j = step(jnp.asarray(toks[:, t]), jnp.full((B,), t, jnp.int32), c_j)
        lg_t = TM.decode_step(tcfg, tparams, _t(toks[:, t]).long(),
                              torch.full((B,), t, dtype=torch.int32), c_t)
        _close(lg_t, lg_j, atol=LOGIT_TOL, rtol=0, msg=f"decode step {t}")


@pytest.mark.parametrize("prompt_len", [24, 27])
def test_prefill_with_caches_equals_sequential_decode(model, prompt_len):
    """tests/test_fast_prefill.py in the port: the prefill's logits and the
    next step from its caches equal token-by-token decode's."""
    _, _, tcfg, tparams = model
    B, T = 2, 32
    tt = _t(np.random.default_rng(prompt_len + 1).integers(0, tcfg.vocab_size, (B, T))).long()
    lg_fast, c_fast = TM.prefill_with_caches(tcfg, tparams, tt[:, :prompt_len], max_len=T)
    c_seq = TM.init_caches(tcfg, B, T, dtype=torch.float32, device="cpu")
    for t in range(prompt_len):
        lg_seq = TM.decode_step(tcfg, tparams, tt[:, t], torch.full((B,), t, dtype=torch.int32),
                                c_seq)
    _close(lg_fast, lg_seq.numpy(), atol=LOGIT_TOL, rtol=0)
    pos = torch.full((B,), prompt_len, dtype=torch.int32)
    lg2_fast = TM.decode_step(tcfg, tparams, tt[:, prompt_len], pos, c_fast)
    lg2_seq = TM.decode_step(tcfg, tparams, tt[:, prompt_len], pos, c_seq)
    _close(lg2_fast, lg2_seq.numpy(), atol=LOGIT_TOL, rtol=0)


def _replay_logits(cfg, params, prompt, gen):
    """The port's next-token logits before each generated token of one
    request, through decode_step."""
    caches = TM.init_caches(cfg, 1, 128, dtype=torch.float32, device="cpu")
    seq = list(prompt) + list(gen)
    out = []
    for t, tok in enumerate(seq[:-1]):
        lg = TM.decode_step(cfg, params, torch.tensor([tok]),
                            torch.tensor([t], dtype=torch.int32), caches)
        if t >= len(prompt) - 1:
            out.append(lg[0, :cfg.vocab_size])
    return torch.stack(out)


def _hold_greedy(cfg, params, prompt, got, want):
    """Identical generations, but for a near-tie: at the first token where
    they differ the port's top-2 margin must be at most MARGIN."""
    if got == want:
        return
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    top = torch.topk(_replay_logits(cfg, params, prompt, want[: i + 1])[i], 2).values
    assert float(top[0] - top[1]) <= MARGIN, (got, want, i)


def test_serve_engine_refills_a_slot_as_jax(model):
    """Three requests through two slots (submit/step): the third refills a
    slot, whose Mamba or xLSTM state the engine zeroes, as JAX's does."""
    jcfg, jparams, tcfg, tparams = model
    ej = JE.ServeEngine(jcfg, jparams, batch_slots=2, max_len=64)
    et = TE.ServeEngine(tcfg, tparams, batch_slots=2, max_len=64, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (5, 9, 7)]
    reqs = {E: [E.Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, (6, 4, 5)))] for E in (JE, TE)}
    for eng, E in ((ej, JE), (et, TE)):
        for r in reqs[E]:
            eng.submit(r)
        eng.run_until_done()
    assert all(r.done for r in reqs[TE])
    assert dataclasses.asdict(et.stats) == dataclasses.asdict(ej.stats)
    for a, b in zip(reqs[TE], reqs[JE]):
        _hold_greedy(tcfg, tparams, a.prompt, a.generated, b.generated)
    assert all(leaf.dtype == torch.float32 for leaf in TE._cache_leaves(et.caches)
               if leaf.is_floating_point())


def test_serve_engine_prefill_batch_matches_jax(model):
    """Ragged prompts (41, 36, 48 tokens: a 35-token prefill, ragged for the
    Mamba chunk of 8 and the mLSTM chunk of 16) through prefill_batch, every
    cache leaf held after it, then 6 greedy tokens: the same as JAX's."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (41, 36, 48)]
    ej = JE.ServeEngine(jcfg, jparams, batch_slots=3, max_len=128)
    et = TE.ServeEngine(tcfg, tparams, batch_slots=3, max_len=128, device="cpu")
    rj = [JE.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    rt = [TE.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    ej.prefill_batch(rj)
    et.prefill_batch(rt)
    for j, kind in enumerate(tcfg.pattern):
        if kind != "attn":
            _caches_close(et.caches[f"b{j}"], ej.caches[f"b{j}"], f"{kind} b{j}")
    assert all(leaf.dtype == torch.float32 for leaf in TE._cache_leaves(et.caches)
               if leaf.is_floating_point())
    ej.run_until_done()
    et.run_until_done()
    for a, b in zip(rt, rj):
        assert a.done and len(a.generated) == 6
        _hold_greedy(tcfg, tparams, a.prompt, a.generated, b.generated)


SUMMARY = re.compile(r"served (\d+) requests, (\d+) tokens in [\d.]+s \(\d+ tok/s, (\d+) engine "
                     r"ticks, (\d+) slots, backend=(\S+)\)")


@pytest.mark.parametrize("name", [JAMBA, XLSTM])
def test_launcher_serves_the_config_as_the_jax_launcher(capsys, monkeypatch, name):
    from repro.launch import serve as JL

    assert TL.main(["--arch", name, "--smoke", "--device", "cpu", "--requests", "3",
                    "--max-new", "4"]) == 0
    got = SUMMARY.fullmatch(capsys.readouterr().out.strip())
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", name, "--smoke", "--requests", "3",
                                      "--max-new", "4"])
    JL.main()
    want = SUMMARY.fullmatch(capsys.readouterr().out.strip().splitlines()[-1])
    assert got and want and got.groups() == want.groups() and got.group(1, 2) == ("3", "60")


def test_bridge_carries_the_mamba_and_slstm_leaves(model):
    jcfg, jparams, tcfg, tparams = model
    blocks = {j: kind for j, kind in enumerate(jcfg.pattern)}
    names = {"mamba": ("A_log", "D", "conv_w", "conv_b"), "slstm": ("r",)}
    seen = set()
    for j, kind in blocks.items():
        for leaf in names.get(kind, ()):
            got = tparams["blocks"][f"b{j}"]["attn"][leaf]
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jparams["blocks"][f"b{j}"]["attn"][leaf]))
            seen.add(leaf)
        if kind == "mamba":
            np.testing.assert_array_equal(
                tparams["blocks"][f"b{j}"]["attn"]["dt_proj"]["b"].numpy(),
                np.asarray(jparams["blocks"][f"b{j}"]["attn"]["dt_proj"]["b"]))
            seen.add("dt_proj.b")
    assert seen == ({"A_log", "D", "conv_w", "conv_b", "dt_proj.b"} if jcfg.name == JAMBA
                    else {"r"})
    own = TM.init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)  # noqa: E731
    assert shapes(_np(jparams)) == shapes(tree_map(lambda t: t.numpy(), own))


# --------------------------------------------------------------------------
# configs, the card's cut, and the refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [JAMBA, XLSTM])
def test_full_configs_match_jax(name):
    assert get_config(name) == bridge.arch_from_reference(j_get(name))
    assert get_config(name).param_count() == j_get(name).param_count()


def test_jamba_cut_the_card_serves():
    """Two layers at full width: pattern position 0 (Mamba with MoE) and an
    attention block with a dense MLP (position 3's): 11.91 G parameters,
    47.65 GB in float32, which one 80 GB card holds."""
    cut = dataclasses.replace(get_config(JAMBA), n_layers=2, block_pattern=("mamba", "attn"))
    assert [cut.layer_is_moe(j) for j in range(2)] == [True, False]
    assert j_get(JAMBA).layer_is_moe(3) is False
    n = cut.param_count()
    assert n == dataclasses.replace(j_get(JAMBA), n_layers=2,
                                    block_pattern=("mamba", "attn")).param_count()
    assert 11.9e9 < n < 11.92e9 and 4 * n < 48e9


def test_one_layer_group_is_stacked_without_a_copy():
    """Jamba's cut is one layer group of 47.65 GB: stacking it must view the
    leaves with the layer axis added, not copy them (a copy ran the card out
    of memory); more groups are stacked as before."""
    cut = dataclasses.replace(smoke_config(JAMBA), n_layers=2, block_pattern=("mamba", "attn"))
    assert cut.n_groups == 1
    tree = {"w": torch.ones(3, 4), "c": {"x": torch.zeros(2)}}
    one = TM.stack_params([tree])
    assert one["w"].shape == (1, 3, 4) and one["w"].data_ptr() == tree["w"].data_ptr()
    assert one["c"]["x"].data_ptr() == tree["c"]["x"].data_ptr()
    two = TM.stack_params([tree, tree])
    assert two["w"].shape == (2, 3, 4) and two["w"].data_ptr() != tree["w"].data_ptr()
    params = TM.init_model(cut, torch.Generator().manual_seed(0), device="cpu")
    assert params["blocks"]["b0"]["mlp"]["wi"].shape[0] == 1
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cut.vocab_size, (2, 16)))
    assert bool(torch.isfinite(TM.forward(cut, params, {"tokens": toks})[0]).all())


def test_the_enc_dec_stack_crosses_the_bridge():
    """The enc-dec stack is ported (tests/test_torch_encdec.py): the bridge
    crosses whisper-tiny and an enc-dec variant of Jamba's smoke config (a
    decoder of Mamba and attention blocks, each with cross-attention), and
    the registry resolves whisper-tiny."""
    assert bridge.arch_from_reference(j_smoke("whisper-tiny")) == smoke_config("whisper-tiny")
    jcfg = dataclasses.replace(j_smoke(JAMBA), encoder_layers=2)
    cfg = bridge.arch_from_reference(jcfg)
    assert cfg == dataclasses.replace(smoke_config(JAMBA), encoder_layers=2)
    assert get_config("whisper-tiny").encoder_layers == 4
    params = TM.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert "cross" in params["blocks"]["b0"] and params["enc_blocks"]["b0"]["attn"]["wq"]["w"] \
        .shape[0] == 2
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))),
             "enc_embeds": torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model))
                                            .astype(np.float32))}
    with torch.no_grad():
        logits, _ = TM.forward(cfg, params, batch)
    assert tuple(logits.shape) == (2, 16, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
