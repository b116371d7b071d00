"""The port's Chimera prefill and LM-serving slice against the JAX package,
on the CPU: ``prefill_into_state``, ``chimera_prefill`` and
``reference_attention``; ``prefill_with_caches`` on Chimera stacks (dense
and MoE) against token-by-token decode; ``ServeEngine.prefill_batch`` and
``from_program``; the LM launcher ``repro_torch.launch.serve``; the kernel
wrappers' widths (L 256, d = dv = m 128) and their stated bfloat16 cast.

The same inputs, made with numpy from a seed or drawn by the JAX package and
carried through ``bridge.py``, go through both packages; the JAX package
runs its jnp path (``use_pallas=False``), the port the plain versions of its
kernels.  Tolerances: float32 on both sides in other summation orders, so
attention outputs and the decode state agree within 1e-5 (rtol and atol)
and logits within 1e-4 (as the JAX package's own ``test_fast_prefill.py``
holds its prefill); greedy generations are identical up to a near-tie, a
top-2 logit margin of 1e-4 or less.
"""

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import chimera_attention as JCA
from repro.core.feature_maps import FeatureMapConfig as JFeatureMapConfig
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import bridge
from repro_torch.compile import compile_program
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import chimera_attention as TCA
from repro_torch.core.feature_maps import FeatureMapConfig
from repro_torch.kernels.chimera_attention import ops as cops
from repro_torch.kernels.decode_step import ops as dops
from repro_torch.launch import serve as TL
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE
from repro_torch.serve.deploy import DeploySpec
from repro_torch.train import classifier as TC

STATE_TOL = 1e-5  # attention outputs and the decode state
LOGIT_TOL = 1e-4  # logits (test_fast_prefill.py's bar)
MARGIN = 1e-4  # a top-2 logit margin at or below it is a near-tie
ARCHS = ("chimera-dataplane", "mixtral-8x7b", "codeqwen1.5-7b", "yi-9b", "qwen3-32b",
         "moonshot-v1-16b-a3b", "chameleon-34b")
KEY = jax.random.PRNGKey(0)


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


def _model(name, seed=0):
    jcfg = j_smoke(name)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, bridge.arch_from_reference(jcfg), bridge.params_from_jax(
        _np(params), device="cpu")


# --------------------------------------------------------------------------
# core: prefill_into_state, chimera_prefill, reference_attention
# --------------------------------------------------------------------------

def _attn_case(n_global, T, seed=0):
    """A Chimera attention config of both packages (exp_prf m 32, L 16), its
    parameters drawn by JAX, and numpy q (2, 4, T, 16), k and v (2, 2, T, 16)."""
    kw = dict(chunk_size=16, n_global=n_global, sig_bits=16, match_hamming=6)
    jcfg = JCA.ChimeraAttentionConfig(feature_map=JFeatureMapConfig(kind="exp_prf", m=32), **kw)
    tcfg = TCA.ChimeraAttentionConfig(feature_map=FeatureMapConfig(kind="exp_prf", m=32), **kw)
    params = JCA.init_chimera_attention(jcfg, 2, 16, 16, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + T)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, T, 16), (2, 2, T, 16), (2, 2, T, 16)))
    return jcfg, tcfg, params, bridge.params_from_jax(_np(params), device="cpu"), q, k, v


def _state_close(got, want, msg):
    for name in ("S", "Z", "k_buf", "v_buf"):
        _close(getattr(got, name), getattr(want, name), STATE_TOL, msg=f"{msg} {name}")
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert got.count.dtype == torch.int32


@pytest.mark.parametrize("n_global", [0, 8])
@pytest.mark.parametrize("T", [16, 48, 53])  # T = L, 3L and a ragged 3L + 5
def test_prefill_into_state_and_chimera_prefill_match_jax(T, n_global):
    jcfg, tcfg, jp, tp, q, k, v = _attn_case(n_global, T)
    _state_close(TCA.prefill_into_state(tcfg, tp, _t(k), _t(v)),
                 JCA.prefill_into_state(jcfg, jp, jnp.asarray(k), jnp.asarray(v)),
                 f"prefill_into_state T={T}")
    out_j, st_j = JCA.chimera_prefill(jcfg, jp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out_t, st_t = TCA.chimera_prefill(tcfg, tp, _t(q), _t(k), _t(v))
    assert tuple(out_t.shape) == (2, 4, T, 16) and out_t.dtype == torch.float32
    _close(out_t, out_j, STATE_TOL, msg=f"chimera_prefill T={T}")
    _state_close(st_t, st_j, f"chimera_prefill T={T}")
    # the O(T^2) oracle, ragged tails included
    _close(TCA.reference_attention(tcfg, tp, _t(q), _t(k), _t(v)), out_j, STATE_TOL,
           msg="reference_attention")


@pytest.mark.parametrize("n_global", [0, 8])
def test_reference_attention_matches_jax(n_global):
    jcfg, tcfg, jp, tp, q, k, v = _attn_case(n_global, 64, seed=1)
    want = JCA.reference_attention(jcfg, jp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(TCA.reference_attention(tcfg, tp, _t(q), _t(k), _t(v)), want, STATE_TOL)
    _close(TCA.chimera_attention(tcfg, tp, _t(q), _t(k), _t(v)), want, STATE_TOL)


def test_prefill_state_continues_decode():
    """prefill_into_state(prompt) then one decode step equals the decode
    step after the prompt went through decode token by token (the JAX
    package's test_chimera_attention.py:66, in the port)."""
    _, tcfg, _, tp, q, k, v = _attn_case(8, 41, seed=2)
    Tp = 40
    q, k, v = _t(q), _t(k), _t(v)
    state = TCA.prefill_into_state(tcfg, tp, k[:, :, :Tp], v[:, :, :Tp])
    ref = TCA.init_decode_state(tcfg, 2, 2, 16, 16)
    for t in range(Tp):
        TCA.chimera_decode_step(tcfg, tp, q[:, :, t], k[:, :, t], v[:, :, t], ref)
    o1 = TCA.chimera_decode_step(tcfg, tp, q[:, :, Tp], k[:, :, Tp], v[:, :, Tp], state)
    o2 = TCA.chimera_decode_step(tcfg, tp, q[:, :, Tp], k[:, :, Tp], v[:, :, Tp], ref)
    _close(o1, o2.numpy(), STATE_TOL)
    _state_close(state, ref, "continued state")


# --------------------------------------------------------------------------
# model: prefill_with_caches on Chimera stacks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


@pytest.mark.parametrize("prompt_len", [24, 27])  # chunk-aligned-ish and ragged (L 16)
def test_prefill_with_caches_equals_sequential_decode_and_jax(model, prompt_len):
    """The port's prefill then one decode step equals token-by-token decode
    (tests/test_fast_prefill.py:21 in the port), and both equal JAX's."""
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
        _state_close(c_fast[j], c_j[j], f"{jcfg.name} {j}")
    # continuation: both cache sets give the same next step, and JAX's
    pos = torch.full((B,), prompt_len, dtype=torch.int32)
    lg2_fast = TM.decode_step(tcfg, tparams, tt[:, prompt_len], pos, c_fast)
    lg2_seq = TM.decode_step(tcfg, tparams, tt[:, prompt_len], pos, c_seq)
    lg2_j, _ = JM.decode_step(jcfg, jparams, jnp.asarray(toks[:, prompt_len]),
                              jnp.full((B,), prompt_len, jnp.int32), c_j)
    _close(lg2_fast, lg2_seq.numpy(), LOGIT_TOL)
    _close(lg2_fast, lg2_j, LOGIT_TOL)


# --------------------------------------------------------------------------
# ServeEngine: prefill_batch, from_program
# --------------------------------------------------------------------------

def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


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
    they differ the port's top-2 margin must be at most MARGIN (the tokens
    after it follow another context and are not held)."""
    if got == want:
        return
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    top = torch.topk(_replay_logits(cfg, params, prompt, want[: i + 1])[i], 2).values
    assert float(top[0] - top[1]) <= MARGIN, (got, want, i)


@pytest.mark.parametrize("name", ["chimera-dataplane", "mixtral-8x7b", "qwen3-32b",
                                  "moonshot-v1-16b-a3b", "chameleon-34b"])
def test_serve_engine_prefill_batch_matches_jax_and_teacher_forcing(name):
    """Ragged prompts (41, 36, 48 tokens: a 35-token prefill of 2 chunks and
    a 3-token tail) through prefill_batch, then 6 greedy tokens: the same as
    JAX's engine and as the port's own submit/step teacher forcing."""
    jcfg, jparams, tcfg, tparams = _model(name, seed=3)
    prompts = _prompts(jcfg.vocab_size, (41, 36, 48), 4)
    ej = JE.ServeEngine(jcfg, jparams, batch_slots=3, max_len=128)
    et = TE.ServeEngine(tcfg, tparams, batch_slots=3, max_len=128, device="cpu")
    tf = TE.ServeEngine(tcfg, tparams, batch_slots=3, max_len=128, device="cpu")
    reqs = {e: [M.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
            for e, M in ((ej, JE), (et, TE), (tf, TE))}
    ej.prefill_batch(reqs[ej])
    et.prefill_batch(reqs[et])
    assert all(c.dtype == torch.float32 for c in et.caches["b0"].leaves()[:4])
    for r in reqs[tf]:
        tf.submit(r)
    for e in (ej, et, tf):
        e.run_until_done()
    for rj, rt, rf in zip(reqs[ej], reqs[et], reqs[tf]):
        assert rt.done and len(rt.generated) == 6
        _hold_greedy(tcfg, tparams, rt.prompt, rt.generated, rj.generated)
        _hold_greedy(tcfg, tparams, rt.prompt, rt.generated, rf.generated)


def _program(arch, waivers=(), seed=0):
    ccfg = TC.ClassifierConfig(arch=arch, n_classes=2, marker_base=arch.vocab_size)
    params = TC.init_classifier(ccfg, torch.Generator().manual_seed(seed), device="cpu")
    return compile_program(ccfg, params, waivers=waivers, verify=False)


@pytest.mark.parametrize("name", ["chimera-dataplane", "mixtral-8x7b"])
def test_from_program_warns_and_deploys_the_lm_engine(name):
    program = _program(smoke_config(name))
    with pytest.warns(DeprecationWarning, match="from_program is deprecated"):
        shim = TE.ServeEngine.from_program(program, batch_slots=2, max_len=64, device="cpu")
    front = program.deploy(DeploySpec(engine="lm", batch_slots=2, max_len=64, device="cpu"))
    assert isinstance(shim, TE.ServeEngine) and isinstance(front, TE.ServeEngine)
    gens = []
    for eng in (shim, front):
        reqs = [TE.Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(_prompts(program.arch.vocab_size, (20, 18), 5))]
        eng.prefill_batch(reqs)
        eng.run_until_done()
        gens.append([r.generated for r in reqs])
    assert gens[0] == gens[1]


def test_lm_deploy_at_the_paper_width():
    """build_serve_engine on chimera-dataplane's full width (4 layers, d 256,
    m 256, L 64, n_global 64): a prefill_batch of 70-token prompts (one
    chunk and a tail), equal to teacher forcing."""
    # the full arch's per-flow state exceeds the switch budget: waived, as
    # both packages' launchers waive it
    program = _program(get_config("chimera-dataplane"), waivers=("state-quantization",))
    arch = program.arch
    assert (arch.head_dim, arch.chimera.feature_map.m, arch.chimera.chunk_size) == (64, 256, 64)
    runs = []
    for prefill in (True, False):
        eng = program.deploy(DeploySpec(engine="lm", batch_slots=2, max_len=128, device="cpu"))
        reqs = [TE.Request(rid=i, prompt=p, max_new_tokens=3)
                for i, p in enumerate(_prompts(arch.vocab_size, (70, 71), 6))]
        if prefill:
            eng.prefill_batch(reqs)
        else:
            for r in reqs:
                eng.submit(r)
        eng.run_until_done()
        runs.append([r.generated for r in reqs])
    for p, a, b in zip(_prompts(arch.vocab_size, (70, 71), 6), *runs):
        _hold_greedy(arch, program.params["backbone"], p, a, b)


# --------------------------------------------------------------------------
# the LM launcher
# --------------------------------------------------------------------------

SUMMARY = re.compile(r"served (\d+) requests, (\d+) tokens in [\d.]+s \(\d+ tok/s, (\d+) engine "
                     r"ticks, (\d+) slots, backend=(\S+)\)")


@pytest.mark.parametrize("arch", ["chimera-dataplane", "mixtral-8x7b"])
def test_launcher_prints_the_jax_launchers_summary(arch, capsys, monkeypatch):
    from repro.launch import serve as JL

    assert TL.main(["--arch", arch, "--smoke", "--device", "cpu"]) == 0
    got = SUMMARY.fullmatch(capsys.readouterr().out.strip())
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke"])
    JL.main()
    want = SUMMARY.fullmatch(capsys.readouterr().out.strip().splitlines()[-1])
    assert got and want and got.groups() == want.groups() == ("8", "256", "62", "4", "xla")


def test_launcher_prefill_path_serves_and_refuses_without_a_gpu():
    args = TL.parse_args(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--prefill",
                          "--requests", "6", "--slots", "4", "--prompt-len", "40"])
    dep = TL.build(args)
    res = TL.serve(dep)
    assert [len(r.generated) for r in res.requests] == [16] * 6
    assert 0 < res.prefill_seconds < res.seconds and res.ticks == 2 * 16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TL.build(TL.parse_args(["--smoke"]))


# --------------------------------------------------------------------------
# the kernel wrappers: widths and the stated bfloat16 cast
# --------------------------------------------------------------------------

def _decode_args(rng, BH, Gq, d, m, L, count):
    f = lambda *s: _t(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return [f(BH, Gq, d), f(BH, d), f(BH, d), f(BH, Gq, m).abs(), f(BH, L, m).abs(),
            f(BH, L, d), f(BH, L, d), f(BH, m, d), f(BH, m).abs(), count]


def test_decode_step_casts_bfloat16_inputs_and_keeps_a_float32_state():
    rng = np.random.default_rng(7)
    BH, Gq, d, m, L = 4, 2, 16, 16, 8
    count = torch.tensor([3, L - 1], dtype=torch.int32)
    args = _decode_args(rng, BH, Gq, d, m, L, count)
    bf = [a.bfloat16() for a in args[:5]]
    want_in = [a.float() for a in bf] + [a.clone() for a in args[5:9]] + [count]
    got_in = bf + [a.clone() for a in args[5:9]] + [count]
    out_w, cnt_w = dops.decode_step(*want_in, chunk_size=L)
    out_g, cnt_g = dops.decode_step(*got_in, chunk_size=L)
    assert out_g.dtype == torch.float32
    assert torch.equal(out_g, out_w) and torch.equal(cnt_g, cnt_w)
    for a, b in zip(got_in[5:9], want_in[5:9]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    with pytest.raises(TypeError, match="S must be one of"):
        dops.decode_step(*args[:7], args[7].bfloat16(), args[8], count, chunk_size=L)


def test_chimera_attention_casts_bfloat16_inputs_and_promotes_like_jnp():
    rng = np.random.default_rng(8)
    BH, Gq, T, d, m = 2, 2, 32, 16, 16
    xs = [_t(rng.standard_normal(s).astype(np.float32)) for s in
          ((BH, Gq, T, d), (BH, T, d), (BH, T, d), (BH, Gq, T, m), (BH, T, m))]
    xs[3], xs[4] = xs[3].abs(), xs[4].abs()
    bf = [x.bfloat16() for x in xs]
    want = cops.chimera_attention_bh(*(x.float() for x in bf), chunk_size=16)
    got = cops.chimera_attention_bh(*bf, chunk_size=16)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, w in zip(got, want):
        assert torch.equal(g, w.bfloat16())
    # float32 features against bfloat16 activations: float32 partials
    mixed = cops.chimera_attention_bh(*bf[:3], *(x.float() for x in bf[3:]), chunk_size=16)
    assert all(g.dtype == torch.float32 and torch.equal(g, w) for g, w in zip(mixed, want))


@pytest.mark.parametrize("name", ["mixtral-8x7b", "yi-9b", "qwen3-32b", "codeqwen1.5-7b",
                                  "moonshot-v1-16b-a3b", "chameleon-34b"])
def test_the_zoo_widths_lie_inside_both_chimera_contracts(name):
    cfg = get_config(name)
    dh, m, L = cfg.head_dim, cfg.chimera.feature_map.m, cfg.chimera.chunk_size
    assert (dh, m, L) == (128, 128, 256) and cfg.use_chimera
    Gq = cfg.n_heads // cfg.n_kv_heads
    assert dops.contract(Gq=Gq, d=dh, dv=dh, m=m, L=L) is None
    assert dops.layout(Gq, dh, dh, m, L)[0] == "tiled"
    assert cops.contract(d=dh, dv=dh, m=m, L=L) is None
    # the paper's engine shape keeps the whole-ring layout
    assert dops.layout(4, 64, 64, 256, 64) == ("whole", 52480)


def test_chimera_attention_plain_at_l256_matches_jax_reference():
    """The wrapper's CPU route at L 256 (the long-chunk kernel's contract)
    against the JAX package's ``ref.py``, T = 512 (two chunks)."""
    from repro.kernels.chimera_attention.ref import chimera_attention_partials_ref

    rng = np.random.default_rng(9)
    B, Hkv, Gq, T, d, m = 1, 2, 2, 512, 16, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 0.3 for s in
               ((B, Hkv, Gq, T, d), (B, Hkv, T, d), (B, Hkv, T, d)))
    pq, pk = (np.abs(rng.standard_normal(s)).astype(np.float32) / 4 for s in
              ((B, Hkv, Gq, T, m), (B, Hkv, T, m)))
    num_j, den_j = chimera_attention_partials_ref(
        *(jnp.asarray(x) for x in (q, k, v, pq, pk)), chunk_size=256)
    num_t, den_t = cops.chimera_attention_partials(*(_t(x) for x in (q, k, v, pq, pk)),
                                                   chunk_size=256)
    _close(num_t, num_j, STATE_TOL)
    _close(den_t, den_j, STATE_TOL)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _chip_smoke():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
def test_zoo_width_kernels_match_plain_on_card(cuda):
    c = _chip_smoke()
    c.check_decode_wide()
    c.check_chimera_long_edges()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
def test_smoke_lm_card_matches_cpu(cuda, name):
    _chip_smoke().lm_smoke_card_vs_cpu(name)
