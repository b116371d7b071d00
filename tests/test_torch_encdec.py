"""The port's encoder-decoder stack (whisper-tiny) against the JAX package,
on the CPU: LayerNorm, the non-causal blockwise softmax (both of JAX's
forms, Tq != Tk, Tq = 1) and its window wrapper's plain version, the
non-causal ``attention_layer``, ``encode_cross_kv`` and
``cross_attention_layer`` in both branches, then smoke whisper-tiny's
``encode``, ``forward``, ``loss_fn``, ``init_encdec_caches`` and
``decode_step`` over three Chimera ring folds, with the Chimera
cross-attention (the config's) and the softmax one (``use_chimera=False``);
the bridge and the registry for whisper-tiny; the refusals that remain
(the enc-dec prefill, hidden-state decode, LM engine and launcher, which the
JAX package lacks too); and the non-causal mode's gradient off the CPU,
which goes through the kernels' autograd Function.

The same inputs, made with numpy from a seed or drawn by the JAX package and
carried through ``bridge.py``, go through both packages, in float32.
Tolerances: 1e-4 abs + 1e-4 rel for layer outputs, caches and logits (fp32
sums in other orders); bfloat16 LayerNorm within one bf16 rounding
(2^-7 abs + rel at values of order 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.configs import smoke_config as j_smoke
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.chimera_attention import ChimeraState
from repro_torch.kernels.window_attention import ops as wops
from repro_torch.launch import serve as TL
from repro_torch.models import attention as TA
from repro_torch.models import layers as TLy
from repro_torch.models import model as TM
from repro_torch.serve.engine import ServeEngine

TOL = 1e-4
BF16_TOL = 2.0 ** -7
WHISPER = "whisper-tiny"
B, T_DEC, T_ENC = 2, 48, 128  # T_DEC: 3 smoke chunks of 16; T_ENC: 2 kv blocks of 64


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


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


def _flat(tree, prefix=()):
    """{path: leaf} of a cache tree of either package (dicts, tuples,
    ChimeraStates)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "S"):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    if hasattr(tree, "S"):  # a ChimeraState of either package
        return {prefix + (f,): getattr(tree, f) for f in ("S", "Z", "k_buf", "v_buf", "count")}
    return {prefix: tree}


def _caches_close(got, want, msg):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), msg
    for path in g:
        assert tuple(g[path].shape) == np.asarray(w[path]).shape, f"{msg} {path}"
        if path[-1] == "count":
            np.testing.assert_array_equal(g[path].numpy(), np.asarray(w[path]))
        else:
            _close(g[path], w[path], msg=f"{msg} {path}")


def _cfgs(use_chimera):
    jcfg = dataclasses.replace(j_smoke(WHISPER), use_chimera=use_chimera)
    return jcfg, bridge.arch_from_reference(jcfg)


# --------------------------------------------------------------------------
# LayerNorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = JL.apply_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jx,
                         "layernorm")
    got = TLy.apply_norm({"scale": _t(scale), "bias": _t(bias)},
                         _t(x).to(getattr(torch, dtype)), "layernorm")
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    _close(got, np.asarray(want.astype(jnp.float32)), tol)
    p = TLy.init_norm(64, "cpu", "layernorm")
    assert set(p) == {"scale", "bias"} and set(TLy.init_norm(64, "cpu")) == {"scale"}
    assert set(JL.init_norm(64, "layernorm")[0]) == set(p)


# --------------------------------------------------------------------------
# non-causal softmax attention
# --------------------------------------------------------------------------

# (Tq, Tk, H, Hkv, blk): JAX's dense form (Tk not a multiple of blk; Tk <=
# blk) and its online kv-block form (Tk % blk == 0, Tk > blk), Tq != Tk both
# ways, Tq = 1 (a decode tick's cross-attention), 2 query heads a kv-head
NONCAUSAL_CASES = [
    (40, 40, 4, 4, 16), (24, 24, 4, 2, 32), (32, 128, 4, 4, 32), (128, 32, 4, 2, 16),
    (1, 128, 4, 4, 32), (1, 37, 4, 4, 16), (20, 77, 4, 4, 64),
]


def _qkv(Tq, Tk, H, Hkv, d=16, dv=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, H, Tq, d)).astype(np.float32),
            rng.standard_normal((2, Hkv, Tk, d)).astype(np.float32),
            rng.standard_normal((2, Hkv, Tk, dv)).astype(np.float32))


@pytest.mark.parametrize("Tq,Tk,H,Hkv,blk", NONCAUSAL_CASES)
def test_noncausal_blockwise_softmax_matches_jax(Tq, Tk, H, Hkv, blk):
    q, k, v = _qkv(Tq, Tk, H, Hkv, seed=Tq + Tk)
    want = JA.blockwise_softmax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), blk,
                                          causal=False)
    got = TA.blockwise_softmax_attention(_t(q), _t(k), _t(v), blk, causal=False)
    assert tuple(got.shape) == (2, H, Tq, 16) and got.dtype == torch.float32
    _close(got, want, msg="blockwise")
    # the card's route, here through the wrapper's plain version
    _close(wops.noncausal_attention(_t(q), _t(k), _t(v)), want, msg="wrapper")


def test_noncausal_plain_versions_agree_and_the_contract_names_the_mode():
    q, k, v = _qkv(33, 70, 4, 2, d=24, dv=16, seed=3)
    flat = wops.window_attention_noncausal_plain(
        _t(q).reshape(8, 33, 24), _t(k).repeat_interleave(2, 1).reshape(8, 70, 24),
        _t(v).repeat_interleave(2, 1).reshape(8, 70, 16))
    _close(wops.noncausal_attention_plain(_t(q), _t(k), _t(v)), flat.reshape(2, 4, 33, 16))
    assert wops.contract(d=64, dv=64, H=6, Hkv=6, causal=False, n_k=1536) is None
    assert "keys" in wops.contract(d=64, dv=64, H=6, Hkv=6, causal=False, n_k=0)
    assert "window" in wops.contract(d=64, dv=64, H=6, Hkv=6, window=0)
    with pytest.raises(ValueError, match="do not fit"):  # the causal mode keeps Tk == T
        wops.sliding_window_attention(_t(q), _t(k), _t(v), 8)


def test_non_causal_gradient_off_the_cpu_raises(monkeypatch):
    """A call that needs a gradient on a device with the kernels (a meta
    tensor stands in for the card here) goes through
    ``_NonCausalAttention`` (the forward kernel with lse, the backward
    kernels), never the plain version, and raises where no kernel runs;
    and ``contract(causal=False)`` refuses what the non-causal launchers
    refuse."""
    q, k, v = (torch.empty(s, device="meta") for s in ((1, 6, 8, 64), (1, 6, 16, 64),
                                                       (1, 6, 16, 64)))
    calls = []

    def plain(*a):
        raise AssertionError("the plain version ran for a tensor off the CPU")

    monkeypatch.setattr(wops, "noncausal_attention_plain", plain)
    monkeypatch.setattr(wops._NonCausalAttention, "apply",
                        lambda *a: calls.append(a) or a[0].new_empty((1, 6, 8, 64)))
    wops.noncausal_attention(q.requires_grad_(True), k, v)
    assert len(calls) == 1 and calls[0][0] is q
    monkeypatch.undo()
    # the Function itself launches and has no route for the meta device
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        wops.noncausal_attention(q, k, v)
    # the launchers' checks: (d, dv), heads over kv-heads, Tq >= 1, Tk >= 1
    base = dict(d=64, dv=64, H=6, Hkv=6, causal=False, n_q=2048, n_k=2048)
    assert wops.contract(**base) is None
    assert wops.contract(**dict(base, H=6, Hkv=3)) is None
    for bad, word in ((dict(n_q=0), "query rows"), (dict(n_k=0), "keys"),
                      (dict(d=48, dv=48), "not in"), (dict(Hkv=4), "kv-heads")):
        assert word in wops.contract(**dict(base, **bad)), bad


# --------------------------------------------------------------------------
# the layers: non-causal self-attention, cross-attention
# --------------------------------------------------------------------------

def _x(T, seed):
    return np.random.default_rng(seed).standard_normal((B, T, 64)).astype(np.float32)


@pytest.mark.parametrize("use_chimera", [True, False])
def test_non_causal_attention_layer_matches_jax(use_chimera):
    """The encoder's attention: non-causal whatever use_chimera says (JAX
    routes Chimera and SWA only when causal)."""
    jcfg, tcfg = _cfgs(use_chimera)
    jp, _ = JA.init_attention(jcfg, jax.random.PRNGKey(1))
    tp = bridge.params_from_jax(_np(jp), device="cpu")
    x = _x(T_ENC, 4)
    pos = np.broadcast_to(np.arange(T_ENC), (B, T_ENC))
    want = JA.attention_layer(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), causal=False)
    got = TA.attention_layer(tcfg, tp, _t(x), _t(pos), causal=False)
    _close(got, want)


@pytest.mark.parametrize("Tq", [T_DEC, 1])
@pytest.mark.parametrize("use_chimera", [True, False])
def test_cross_attention_matches_jax(use_chimera, Tq):
    jcfg, tcfg = _cfgs(use_chimera)
    jp, _ = JA.init_cross_attention(jcfg, jax.random.PRNGKey(2))
    tp = bridge.params_from_jax(_np(jp), device="cpu")
    assert ("fm" in tp) == use_chimera
    enc, x = _x(T_ENC, 5), _x(Tq, 6)
    jkv = JA.encode_cross_kv(jcfg, jp, jnp.asarray(enc))
    tkv = TA.encode_cross_kv(tcfg, tp, _t(enc))
    for got, want in zip(tkv, jkv):
        assert tuple(got.shape) == (B, 4, T_ENC, 16)
        _close(got, want, msg="encode_cross_kv")
    want = JA.cross_attention_layer(jcfg, jp, jnp.asarray(x), jkv)
    got = TA.cross_attention_layer(tcfg, tp, _t(x), tkv)
    assert tuple(got.shape) == (B, Tq, 64)
    _close(got, want, msg="cross_attention_layer")


# --------------------------------------------------------------------------
# the model: encode, forward, loss_fn, init_encdec_caches, decode_step
# --------------------------------------------------------------------------

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


def _batch(c, pkg):
    arr = jnp.asarray if pkg == "jax" else (lambda a: torch.from_numpy(np.array(a)))
    toks = c["toks"].astype(np.int64) if pkg == "torch" else c["toks"]
    return {"tokens": arr(toks[:, :-1]), "labels": arr(toks[:, 1:]),
            "enc_embeds": arr(c["emb"])}


def test_encode_matches_jax(case):
    want = JM.encode(case["jcfg"], case["jp"], jnp.asarray(case["emb"]))
    with torch.no_grad():
        got = TM.encode(case["tcfg"], case["tp"], _t(case["emb"]))
    assert tuple(got.shape) == (B, T_ENC, 64)
    _close(got, want)


def test_forward_and_loss_match_jax(case):
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    jl, jaux = JM.forward(jcfg, case["jp"], _batch(case, "jax"))
    jloss, jparts = JM.loss_fn(jcfg, case["jp"], _batch(case, "jax"))
    with torch.no_grad():
        tl, taux = TM.forward(tcfg, case["tp"], _batch(case, "torch"))
        tloss, tparts = TM.loss_fn(tcfg, case["tp"], _batch(case, "torch"))
    assert tuple(tl.shape) == (B, T_DEC, tcfg.padded_vocab)
    _close(tl, jl, msg="logits")
    _close(taux, jaux, msg="aux")
    _close(tloss, jloss, msg="loss")
    for k in ("nll", "aux", "zloss"):
        _close(tparts[k], jparts[k], msg=k)


def test_init_encdec_caches_match_jax(case):
    want = JM.init_encdec_caches(case["jcfg"], case["jp"], jnp.asarray(case["emb"]), B, T_DEC)
    with torch.no_grad():
        got = TM.init_encdec_caches(case["tcfg"], case["tp"], _t(case["emb"]), B, T_DEC)
    _caches_close(got, want, "init_encdec_caches")
    assert set(got["b0"]) == {"self", "cross_kv"}
    assert isinstance(got["b0"]["self"], ChimeraState) == case["tcfg"].use_chimera


def test_decode_step_matches_jax_over_three_folds(case):
    """All T_DEC = 3 L ticks (the Chimera ring folds at 16, 32 and 48): each
    tick's logits and every cache leaf after it against JAX's decode_step;
    the port's decode against its own teacher-forced forward too."""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    jc = JM.init_encdec_caches(jcfg, case["jp"], jnp.asarray(case["emb"]), B, T_DEC)
    step = jax.jit(lambda tok, pos, c: JM.decode_step(jcfg, case["jp"], tok, pos, c))
    with torch.no_grad():
        tc = TM.init_encdec_caches(tcfg, case["tp"], _t(case["emb"]), B, T_DEC)
        fwd, _ = TM.forward(tcfg, case["tp"], _batch(case, "torch"))
    toks = case["toks"]
    for t in range(T_DEC):
        jl, jc = step(jnp.asarray(toks[:, t]), jnp.full((B,), t, jnp.int32), jc)
        with torch.no_grad():
            tl = TM.decode_step(tcfg, case["tp"], torch.from_numpy(toks[:, t].astype(np.int64)),
                                torch.full((B,), t, dtype=torch.int32), tc)
        _close(tl, jl, msg=f"logits at tick {t}")
        _caches_close(tc, jc, f"caches after tick {t}")
        _close(tl, fwd[:, t], 1e-3, msg=f"decode vs forward at tick {t}")


# --------------------------------------------------------------------------
# bridge, registry, refusals
# --------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_bridge_and_registry_cross_whisper_tiny(size):
    jcfg = j_get(WHISPER) if size == "full" else j_smoke(WHISPER)
    tcfg = get_config(WHISPER) if size == "full" else smoke_config(WHISPER)
    assert bridge.arch_from_reference(jcfg) == tcfg
    assert tcfg.encoder_layers == (4 if size == "full" else 2)
    assert tcfg.norm_type == "layernorm" and tcfg.family == "audio"
    if size == "full":
        assert 3e7 <= tcfg.param_count() <= 9e7  # the JAX package's bound (test_models_smoke)
        return
    jp, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    got = dict(_leaves(bridge.params_from_jax(_np(jp), device="cpu")))
    want = dict(_leaves(_np(jp)))
    assert got.keys() == want.keys()
    for path in (("enc_in", "w"), ("enc_blocks", "b0", "attn", "wq", "w"), ("enc_norm", "bias"),
                 ("blocks", "b0", "cross", "fm", "w"), ("blocks", "b0", "ln_x", "bias")):
        assert path in got
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=str(path))
    own = TM.init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {p: tuple(t.shape) for p, t in _leaves(own)} == {
        p: tuple(t.shape) for p, t in got.items()}


def test_enc_dec_refusals_name_the_missing_counterpart():
    """What the JAX package lacks for an enc-dec config the port refuses
    too, with a message that says so: prefill, the hidden-state decode, the
    LM engine and its launcher."""
    cfg = smoke_config(WHISPER)
    toks = torch.zeros((1, 16), dtype=torch.long)
    for call in (lambda: TM.prefill_with_caches(cfg, {}, toks, 16),
                 lambda: TM.decode_hidden_step(cfg, {}, toks[:, 0], toks[:, 0], {}),
                 lambda: ServeEngine(cfg, {}, batch_slots=1, max_len=16, device="cpu"),
                 lambda: TL.build(TL.parse_args(["--arch", WHISPER, "--smoke", "--device",
                                                 "cpu"]))):
        with pytest.raises(NotImplementedError, match="no encoder-decoder"):
            call()


# --------------------------------------------------------------------------
# the card (skips without a GPU)
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("edge", range(3))
def test_noncausal_mode_matches_plain_on_card(cuda, edge):
    import os
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    for d, dv in chip_smoke.WINDOW_EDGE_DIMS:
        chip_smoke.check_noncausal_edge(*chip_smoke.NONCAUSAL_EDGES[edge], d, dv, seed=edge)
