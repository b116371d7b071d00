"""The paper's baseline math in the port against the JAX package, on the
CPU: ``core/primitives.py`` (Partition / Map / SumReduce, Eqs. 1-3) and
``core/linear_attention.py`` (Eqs. 5-10: the recurrent, chunked and exact
forms, the readout, the state updates).

The same inputs, made with numpy from a seed, go through both packages.
Tolerance: float32 on both sides in other summation orders, so every output
and state agrees within 1e-5 (rtol and atol), as ``tests/test_core_math.py``
holds the JAX forms to each other; partitions are held exactly.  The
evicting window against its direct sum keeps that file's 1e-4 (a state
built by 12 additions and subtractions of products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear_attention as JLA
from repro.core import primitives as JP
from repro_torch.core import linear_attention as TLA
from repro_torch.core import primitives as TP

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's and XLA's CPU thread pools contend in one process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _la_inputs(B=2, H=2, T=32, m=8, dv=8, seed=0):
    """phi(q), phi(k) strictly positive (elu + 1 of a normal draw) and v."""
    rng = np.random.default_rng(seed)
    elu1 = lambda x: np.where(x > 0, x + 1, np.exp(x)).astype(np.float32)  # noqa: E731
    return (elu1(rng.standard_normal((B, H, T, m))), elu1(rng.standard_normal((B, H, T, m))),
            rng.standard_normal((B, H, T, dv)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# --------------------------------------------------------------------------
# primitives (Eqs. 1-3)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k,axis", [((32, 8), 4, 0), ((6, 12, 5), 3, 1), ((4, 6, 9), 3, -1)])
def test_partition_matches_jax(shape, k, axis):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = TP.partition(torch.from_numpy(x), k, axis)
    want = np.asarray(JP.partition(jnp.asarray(x), k, axis))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_partition_requires_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        TP.partition(torch.zeros((5, 2)), 3)


def test_partition_map_sumreduce_matches_jax_and_the_direct_sum():
    x = np.random.default_rng(1).standard_normal((32, 8)).astype(np.float32)
    got = TP.partition_map_sumreduce(torch.from_numpy(x),
                                     lambda seg: torch.sum(torch.tanh(seg), dim=0), 4)
    want = JP.partition_map_sumreduce(jnp.asarray(x), lambda seg: jnp.sum(jnp.tanh(seg), axis=0),
                                      num_segments=4)
    _close(got, want)
    _close(got, np.tanh(x).sum(0))


def test_map_segments_heterogeneous_and_vmapped_match_jax():
    x = np.random.default_rng(2).standard_normal((3, 4, 5)).astype(np.float32)
    fns_t = [lambda a: a * 2, lambda a: a.exp(), lambda a: a.abs().sqrt()]
    fns_j = [lambda a: a * 2, jnp.exp, lambda a: jnp.sqrt(jnp.abs(a))]
    _close(TP.map_segments(fns_t, torch.from_numpy(x)), JP.map_segments(fns_j, jnp.asarray(x)))
    _close(TP.map_segments(lambda a: a @ a.T, torch.from_numpy(x)),
           JP.map_segments(lambda a: a @ a.T, jnp.asarray(x)))
    with pytest.raises(ValueError, match="2 functions for 3 segments"):
        TP.map_segments(fns_t[:2], torch.from_numpy(x))
    _close(TP.sum_reduce(torch.from_numpy(x), axis=1), JP.sum_reduce(jnp.asarray(x), axis=1))


# --------------------------------------------------------------------------
# linear attention (Eqs. 5-10)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T,chunk", [(32, 8), (48, 16), (16, 16)])
def test_recurrent_chunked_and_exact_match_jax_and_each_other(T, chunk):
    pq, pk, v = _la_inputs(T=T, seed=T)
    o_r, (S_r, Z_r) = TLA.recurrent_linear_attention(*_t(pq, pk, v))
    o_c, (S_c, Z_c) = TLA.chunked_linear_attention(*_t(pq, pk, v), chunk_size=chunk)
    o_e = TLA.exact_kernel_attention(*_t(pq, pk, v))
    jo_r, (jS_r, jZ_r) = JLA.recurrent_linear_attention(*_j(pq, pk, v))
    jo_c, (jS_c, jZ_c) = JLA.chunked_linear_attention(*_j(pq, pk, v), chunk_size=chunk)
    jo_e = JLA.exact_kernel_attention(*_j(pq, pk, v))
    for got, want in ((o_r, jo_r), (S_r, jS_r), (Z_r, jZ_r), (o_c, jo_c), (S_c, jS_c),
                      (Z_c, jZ_c), (o_e, jo_e)):
        assert tuple(got.shape) == np.asarray(want).shape
        _close(got, want)
    # chunked against recurrent, and both against the O(T^2) oracle, in the port
    _close(o_c, o_r.numpy())
    _close(S_c, S_r.numpy())
    _close(o_e, o_r.numpy())


def test_chunked_requires_divisibility():
    pq, pk, v = _la_inputs(T=20)
    with pytest.raises(ValueError, match="not divisible"):
        TLA.chunked_linear_attention(*_t(pq, pk, v), chunk_size=8)


def test_carried_state_and_gamma_match_jax():
    """A state carried in from a first half, and another gamma floor."""
    pq, pk, v = _la_inputs(T=32, seed=5)
    h = 16
    state_t = TLA.recurrent_linear_attention(*_t(pq[:, :, :h], pk[:, :, :h], v[:, :, :h]))[1]
    state_j = JLA.recurrent_linear_attention(*_j(pq[:, :, :h], pk[:, :, :h], v[:, :, :h]))[1]
    for gamma in (1e-6, 0.5):
        got, (S, Z) = TLA.chunked_linear_attention(
            *_t(pq[:, :, h:], pk[:, :, h:], v[:, :, h:]), chunk_size=8, state=state_t,
            gamma=gamma)
        want, (jS, jZ) = JLA.chunked_linear_attention(
            *_j(pq[:, :, h:], pk[:, :, h:], v[:, :, h:]), chunk_size=8, state=state_j,
            gamma=gamma)
        _close(got, want)
        _close(S, jS)
        _close(Z, jZ)
    # the carried state continues the uncut run
    whole, _ = TLA.recurrent_linear_attention(*_t(pq, pk, v))
    cont, _ = TLA.recurrent_linear_attention(*_t(pq[:, :, h:], pk[:, :, h:], v[:, :, h:]),
                                             state=state_t)
    _close(cont, whole[:, :, h:].numpy())


def test_readout_matches_jax_and_the_last_step():
    pq, pk, v = _la_inputs(seed=6)
    o, (S, Z) = TLA.recurrent_linear_attention(*_t(pq, pk, v))
    got = TLA.linear_attention_readout(torch.from_numpy(pq[:, :, -1]), (S, Z))
    want = JLA.linear_attention_readout(jnp.asarray(pq[:, :, -1]),
                                        (jnp.asarray(S.numpy()), jnp.asarray(Z.numpy())))
    _close(got, want)
    _close(got, o[:, :, -1].numpy())


def test_state_updates_match_jax():
    """Eqs. 9-10 one token at a time, and the evicting window of L tokens
    (the SRAM circular overwrite): the state is the sum over the window."""
    pq, pk, v = _la_inputs(T=16, seed=7)
    L = 4
    st = TLA.init_state((2, 2), 8, 8)
    sj = JLA.init_state((2, 2), 8, 8)
    assert all(a.dtype == torch.float32 and tuple(a.shape) == b.shape for a, b in zip(st, sj))
    for t in range(16):
        if t < L:
            st = TLA.state_update(*_t(pk[:, :, t], v[:, :, t]), st)
            sj = JLA.state_update(*_j(pk[:, :, t], v[:, :, t]), sj)
        else:
            st = TLA.evicting_state_update(
                *_t(pk[:, :, t], v[:, :, t], pk[:, :, t - L], v[:, :, t - L]), st)
            sj = JLA.evicting_state_update(
                *_j(pk[:, :, t], v[:, :, t], pk[:, :, t - L], v[:, :, t - L]), sj)
        _close(st[0], sj[0])
        _close(st[1], sj[1])
    _close(st[0], np.einsum("bhtm,bhtd->bhmd", pk[:, :, -L:], v[:, :, -L:]), tol=1e-4)
