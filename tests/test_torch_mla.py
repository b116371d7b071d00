"""The port's MLA attention and full-causal softmax attention against the
JAX package, on the CPU: ``blockwise_softmax_attention`` (the blockwise
form, its masked fallback, GQA, d != dv), the window kernel's route at
W >= T against it, ``_mla_qkv``, ``mla_attention_layer``, ``mla_prefill``
and ``mla_decode`` in both modes (Chimera and the softmax latent cache),
then MiniCPM3-4B's smoke config in both modes and Yi-9B's smoke softmax
variant through ``forward``, ``loss_fn``, ``prefill_with_caches``,
``decode_step``, ``ServeEngine.prefill_batch`` and the LM launcher, and the
configs and ``param_count`` against the JAX registry.

The same inputs, made with numpy from a seed or drawn by the JAX package and
carried through ``bridge.py``, go through both packages; the JAX package
runs its jnp path, the port the plain versions of its kernels (the tensors
lie on the CPU).  Tolerances: float32 on both sides in other summation
orders, so attention outputs and decode caches agree within 1e-5 (rtol and
atol) and logits and losses within 1e-4 (the JAX package's own
``test_fast_prefill.py`` holds its prefill to decode at 1e-4); greedy
generations are identical up to a near-tie, a top-2 logit margin of 1e-4
or less.
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
from repro.models import attention as JA
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.chimera_attention import ChimeraState
from repro_torch.kernels.window_attention import ops as wops
from repro_torch.launch import serve as TL
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE

ATTN_TOL = 1e-5  # attention outputs and decode caches
LOGIT_TOL = 1e-4  # logits and losses
MARGIN = 1e-4  # a top-2 logit margin at or below it is a near-tie
# MiniCPM3-4B in both modes, and Yi-9B's softmax variant (GQA, Gq 2 at the
# smoke size)
MODELS = (("minicpm3-4b", True), ("minicpm3-4b", False), ("yi-9b", False))
MODEL_IDS = ("minicpm3-chimera", "minicpm3-softmax", "yi9b-softmax")


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


def _close(got, want, tol, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


def _caches_close(got, want, msg):
    """A port cache (ChimeraState or dict) against JAX's (pytree of arrays)."""
    if isinstance(got, ChimeraState):
        for name in ("S", "Z", "k_buf", "v_buf"):
            _close(getattr(got, name), getattr(want, name), ATTN_TOL, msg=f"{msg} {name}")
        np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
        return
    assert got.keys() == want.keys()
    for name in got:
        _close(got[name], want[name], ATTN_TOL, msg=f"{msg} {name}")


def _jcfg(name, use_chimera, **replace):
    return dataclasses.replace(j_smoke(name), use_chimera=use_chimera, **replace)


def _model(name, use_chimera, seed=0):
    jcfg = _jcfg(name, use_chimera)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, bridge.arch_from_reference(jcfg), bridge.params_from_jax(
        _np(params), device="cpu")


# --------------------------------------------------------------------------
# blockwise_softmax_attention and its route through the window kernel
# --------------------------------------------------------------------------

# (T, H, Hkv, dh, dv, blk): the blockwise form (Tk % blk == 0, Tk > blk) at
# GQA and at MLA's d != dv, the masked fallback (Tk % blk != 0, and Tk <= blk)
SOFTMAX_CASES = ((128, 4, 2, 16, 16, 32), (96, 4, 4, 24, 16, 16), (64, 8, 2, 32, 32, 16),
                 (40, 4, 2, 16, 16, 32), (32, 4, 1, 24, 16, 32))


def _qkv(T, H, Hkv, dh, dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, H, T, dh), (2, Hkv, T, dh), (2, Hkv, T, dv))]


@pytest.mark.parametrize("T,H,Hkv,dh,dv,blk", SOFTMAX_CASES)
def test_blockwise_softmax_attention_matches_jax(T, H, Hkv, dh, dv, blk):
    q, k, v = _qkv(T, H, Hkv, dh, dv, seed=T + dh)
    want = JA.blockwise_softmax_attention(*(jnp.asarray(x) for x in (q, k, v)), blk=blk)
    got = TA.blockwise_softmax_attention(_t(q), _t(k), _t(v), blk)
    assert tuple(got.shape) == (2, H, T, dv) and got.dtype == torch.float32
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("extra", [0, 1])  # W = T and W = T + 1
@pytest.mark.parametrize("T,H,Hkv,dh,dv,blk", SOFTMAX_CASES[:3])
def test_window_route_at_w_covering_t_equals_blockwise_plain(T, H, Hkv, dh, dv, blk, extra):
    """The card's route (window_attention with the window at T or beyond),
    here through the wrapper's plain version, is the blockwise plain version."""
    q, k, v = (_t(x) for x in _qkv(T, H, Hkv, dh, dv, seed=T + 1))
    _close(wops.sliding_window_attention(q, k, v, T + extra),
           TA.blockwise_softmax_attention_plain(q, k, v, blk).numpy(), ATTN_TOL)


def test_non_causal_softmax_raises():
    """Non-causal softmax runs on the CPU (tests/test_torch_encdec.py); off
    the CPU it is the window kernels' non-causal mode, which a call that
    needs a gradient reaches through their autograd Function: where no
    kernel runs (meta tensors stand in for the card's) it raises before any
    launch rather than falling back to the plain version, which would
    return meta tensors."""
    q, k, v = (_t(x).to("meta") for x in _qkv(32, 4, 2, 16, 16, seed=0))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        TA.blockwise_softmax_attention(q.requires_grad_(True), k, v, 16, causal=False)


# --------------------------------------------------------------------------
# the MLA layer, both modes
# --------------------------------------------------------------------------

def _mla_case(use_chimera, seed=0, **replace):
    """MiniCPM3-4B's smoke config (q_lora 32, kv_lora 16, nope 16, rope 8, v
    16), its MLA parameters drawn by JAX, and a numpy input (2, 32, 64)."""
    jcfg = _jcfg("minicpm3-4b", use_chimera, **replace)
    jp, _ = JA.init_mla(jcfg, jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed + 1).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, bridge.arch_from_reference(jcfg), bridge.params_from_jax(
        _np(jp), device="cpu"), x


@pytest.mark.parametrize("q_lora", [32, 0])
def test_mla_qkv_matches_jax(q_lora):
    jcfg, jp, tcfg, tp, x = _mla_case(True, q_lora_rank=q_lora)
    assert ("q_down" in tp) == bool(q_lora)
    pos = np.broadcast_to(np.arange(32) + 3, (2, 32))
    want = JA._mla_qkv(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = TA._mla_qkv(tcfg, tp, _t(x), _t(pos))
    for name, g, w in zip(("q", "k", "v", "c_kv", "k_r"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, ATTN_TOL, msg=name)


@pytest.mark.parametrize("use_chimera", [True, False], ids=["chimera", "softmax"])
def test_mla_attention_layer_matches_jax(use_chimera):
    jcfg, jp, tcfg, tp, x = _mla_case(use_chimera)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    want = JA.mla_attention_layer(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    _close(TA.mla_attention_layer(tcfg, tp, _t(x), _t(pos)), want, ATTN_TOL)


@pytest.mark.parametrize("T", [16, 27])  # a chunk, and a ragged tail (L 16)
@pytest.mark.parametrize("use_chimera", [True, False], ids=["chimera", "softmax"])
def test_mla_prefill_and_decode_match_jax(use_chimera, T):
    jcfg, jp, tcfg, tp, x = _mla_case(use_chimera)
    max_len = 32
    pos = np.broadcast_to(np.arange(T), (2, T))
    y_j, c_j = JA.mla_prefill(jcfg, jp, jnp.asarray(x[:, :T]), jnp.asarray(pos), max_len)
    y_t, c_t = TA.mla_prefill(tcfg, tp, _t(x[:, :T]), _t(pos), max_len)
    _close(y_t, y_j, ATTN_TOL, msg="prefill output")
    _caches_close(c_t, c_j, "prefill cache")
    # one decode step from each package's cache
    p = np.full((2,), T, np.int32)
    y2_j, c2_j = JA.mla_decode(jcfg, jp, jnp.asarray(x[:, T:T + 1]), jnp.asarray(p), c_j)
    y2_t = TA.mla_decode(tcfg, tp, _t(x[:, T:T + 1]), _t(p), c_t)
    _close(y2_t, y2_j, ATTN_TOL, msg="decode output")
    _caches_close(c_t, c2_j, "decode cache")


@pytest.mark.parametrize("use_chimera", [True, False], ids=["chimera", "softmax"])
def test_mla_caches_match_jax_layout(use_chimera):
    jcfg = _jcfg("minicpm3-4b", use_chimera)
    tcfg = bridge.arch_from_reference(jcfg)
    want = JA.init_mla_cache(jcfg, 3, 40, jnp.float32)
    got = TA.init_mla_cache(tcfg, 3, 40, torch.float32, "cpu")
    got_leaves = got.leaves() if isinstance(got, ChimeraState) else tuple(got.values())
    want_leaves = jax.tree_util.tree_leaves(want)
    assert [tuple(g.shape) for g in got_leaves] == [w.shape for w in want_leaves]


# --------------------------------------------------------------------------
# the model: forward, loss, prefill against decode, the serving engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MODELS, ids=MODEL_IDS)
def model(request):
    return _model(*request.param)


def test_forward_and_loss_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 32))
    labels = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 32))
    lg_j, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    lg_t, _ = TM.forward(tcfg, tparams, {"tokens": _t(toks).long()})
    _close(lg_t, lg_j, LOGIT_TOL)
    batch = {"tokens": toks, "labels": labels}
    loss_j, parts_j = JM.loss_fn(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, parts_t = TM.loss_fn(tcfg, tparams, {k: _t(v).long() for k, v in batch.items()})
    _close(loss_t, loss_j, LOGIT_TOL)
    for name in ("nll", "zloss"):
        _close(parts_t[name], parts_j[name], LOGIT_TOL, msg=name)


@pytest.mark.parametrize("prompt_len", [24, 27])  # chunk-aligned-ish and ragged (L 16)
def test_prefill_with_caches_equals_sequential_decode_and_jax(model, prompt_len):
    """tests/test_fast_prefill.py in the port, for MiniCPM3-4B (both modes)
    and Yi-9B's softmax variant: the prefill's logits and the next step from
    its caches equal token-by-token decode's, and JAX's."""
    jcfg, jparams, tcfg, tparams = model
    B, T = 2, 32
    toks = np.random.default_rng(prompt_len).integers(0, jcfg.vocab_size, (B, T))
    tt = _t(toks).long()
    lg_fast, c_fast = TM.prefill_with_caches(tcfg, tparams, tt[:, :prompt_len], max_len=T)
    c_seq = TM.init_caches(tcfg, B, T, device="cpu")
    for t in range(prompt_len):
        lg_seq = TM.decode_step(tcfg, tparams, tt[:, t], torch.full((B,), t, dtype=torch.int32),
                                c_seq)
    _close(lg_fast, lg_seq.numpy(), LOGIT_TOL)
    lg_j, c_j = JM.prefill_with_caches(jcfg, jparams, jnp.asarray(toks[:, :prompt_len]),
                                       max_len=T)
    _close(lg_fast, lg_j, LOGIT_TOL)
    for j in c_j:
        _caches_close(c_fast[j], c_j[j], f"{jcfg.name} {j}")
    pos = torch.full((B,), prompt_len, dtype=torch.int32)
    lg2_fast = TM.decode_step(tcfg, tparams, tt[:, prompt_len], pos, c_fast)
    lg2_seq = TM.decode_step(tcfg, tparams, tt[:, prompt_len], pos, c_seq)
    lg2_j, _ = JM.decode_step(jcfg, jparams, jnp.asarray(toks[:, prompt_len]),
                              jnp.full((B,), prompt_len, jnp.int32), c_j)
    _close(lg2_fast, lg2_seq.numpy(), LOGIT_TOL)
    _close(lg2_fast, lg2_j, LOGIT_TOL)


def _replay_logits(cfg, params, prompt, gen):
    """The port's next-token logits before each generated token of one
    request: the prompt, then the generations, through decode_step."""
    caches = TM.init_caches(cfg, 1, 128, dtype=torch.float32, device="cpu")
    seq = list(prompt) + list(gen)
    out = []
    for t, tok in enumerate(seq[:-1]):
        lg = TM.decode_step(cfg, params, torch.tensor([tok]), torch.tensor([t],
                                                                          dtype=torch.int32),
                            caches)
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


def test_serve_engine_prefill_batch_matches_jax(model):
    """Ragged prompts (41, 36, 48 tokens: a 35-token prefill) through
    prefill_batch, then 6 greedy tokens: the same as JAX's engine."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (41, 36, 48)]
    ej = JE.ServeEngine(jcfg, jparams, batch_slots=3, max_len=128)
    et = TE.ServeEngine(tcfg, tparams, batch_slots=3, max_len=128, device="cpu")
    rj = [JE.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    rt = [TE.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    ej.prefill_batch(rj)
    et.prefill_batch(rt)
    ej.run_until_done()
    et.run_until_done()
    for a, b in zip(rt, rj):
        assert a.done and len(a.generated) == 6
        _hold_greedy(tcfg, tparams, a.prompt, a.generated, b.generated)


SUMMARY = re.compile(r"served (\d+) requests, (\d+) tokens in [\d.]+s \(\d+ tok/s, (\d+) engine "
                     r"ticks, (\d+) slots, backend=(\S+)\)")


def test_launcher_serves_minicpm3_4b_as_the_jax_launcher(capsys, monkeypatch):
    from repro.launch import serve as JL

    assert TL.main(["--arch", "minicpm3-4b", "--smoke", "--device", "cpu"]) == 0
    got = SUMMARY.fullmatch(capsys.readouterr().out.strip())
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "minicpm3-4b", "--smoke"])
    JL.main()
    want = SUMMARY.fullmatch(capsys.readouterr().out.strip().splitlines()[-1])
    assert got and want and got.groups() == want.groups() == ("8", "256", "62", "4", "xla")


@pytest.mark.parametrize("use_chimera", [True, False], ids=["chimera", "softmax"])
def test_launcher_prefill_path_serves_minicpm3_4b(use_chimera):
    """``--prefill`` in both modes (the softmax variant has no flag, in
    either package: ``build`` takes the config)."""
    args = TL.parse_args(["--arch", "minicpm3-4b", "--smoke", "--device", "cpu", "--prefill",
                          "--requests", "6", "--slots", "4", "--prompt-len", "40"])
    dep = TL.build(args, arch=dataclasses.replace(smoke_config("minicpm3-4b"),
                                                  use_chimera=use_chimera))
    res = TL.serve(dep)
    assert [len(r.generated) for r in res.requests] == [16] * 6
    assert 0 < res.prefill_seconds < res.seconds and res.ticks == 2 * 16


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_config_and_param_count_match_jax_registry(name, size):
    jcfg = j_get(name) if size == "full" else j_smoke(name)
    tcfg = get_config(name) if size == "full" else smoke_config(name)
    assert bridge.arch_from_reference(jcfg) == tcfg
    assert tcfg.param_count() == jcfg.param_count()


def test_minicpm3_4b_full_depth_fits_one_card_in_float32():
    """4.26 B parameters at full depth: ~17 GB of float32 weights."""
    n = get_config("minicpm3-4b").param_count()
    assert 4.2e9 < n < 4.3e9 and 4 * n < 80e9 / 4
