"""The soft decode's lax building blocks held against independent numpy
references at the farm decode's shapes: the zero-prefixed cumsum
(_csum0), the per-channel row alignment (_aligned_rows,
_aligned_strided) and the batched Viterbi (_viterbi_core) against a
float64 maximum-likelihood decoder written from the generator
polynomials."""

import numpy as np
import pytest

import jax.numpy as jnp

from webaudio_modem.ops import fec, soft_fsk


@pytest.mark.parametrize("n,B,scale", [
    (1000, 256, 1.0), (37, 128, 1.0), (255, 128, 1.0), (257, 128, 1.0),
    (500, 128, 1e6), (300, 4096, 1.0)])
def test_csum0_matches_float64_cumsum(n, B, scale):
    x = (np.random.RandomState(n).randn(n, B) * scale).astype(np.float32)
    got = np.asarray(soft_fsk._csum0(jnp.asarray(x)))
    assert got.shape == (n + 1, B)
    assert (got[0] == 0).all()
    want = np.cumsum(x.astype(np.float64), axis=0)
    # any f32 summation order stays within n ulps of the running |sum|
    bound = n * np.finfo(np.float32).eps * np.cumsum(np.abs(x), axis=0)
    assert (np.abs(got[1:] - want) <= bound + 1e-30).all()


@pytest.mark.parametrize("T,U,B", [
    (300, 40, 16), (1000, 257, 128), (37, 50, 8), (513, 512, 32),
    (2048, 100, 256)])
def test_aligned_rows_matches_gather(T, U, B):
    rng = np.random.RandomState(T + U)
    plane = rng.randn(T, B).astype(np.float32)
    base = rng.randint(0, max(T - U, 0) + 1, B).astype(np.int32)
    got = np.asarray(soft_fsk._aligned_rows(jnp.asarray(plane),
                                            jnp.asarray(base), U))
    padded = np.concatenate([plane, np.zeros((max(U - T, 0), B),
                                             np.float32)], 0)
    want = np.stack([padded[base[b]:base[b] + U, b] for b in range(B)], 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,n_out,ds,B", [
    (1000, 20, 8, 16), (3000, 60, 40, 32), (500, 10, 1, 8),
    (2000, 30, 20, 64)])
def test_aligned_strided_matches_gather(T, n_out, ds, B):
    rng = np.random.RandomState(T + ds)
    plane = rng.randn(T, B).astype(np.float32)
    span = (n_out - 1) * ds + 1
    base = rng.randint(0, T - span + 1, B).astype(np.int32)
    got = np.asarray(soft_fsk._aligned_strided(
        jnp.asarray(plane), jnp.asarray(base), n_out, ds))
    want = np.stack([plane[base[b]:base[b] + span:ds, b]
                     for b in range(B)], 1)
    np.testing.assert_array_equal(got, want)


def _np_viterbi(soft, n_bits):
    """Float64 maximum-likelihood decode of soft [L, T, 2] (+1 ~ coded
    bit 1), trellis from the generators: the state holds the last K-1
    input bits, newest in the LSB; starts and ends in state 0."""
    L, T, _ = soft.shape
    S = 1 << (fec.K - 1)
    par = lambda v: bin(v).count("1") & 1  # noqa: E731
    prev = np.zeros((S, 2), np.int64)        # predecessors of s2
    sign = np.zeros((S, 2, 2))               # ±1 expected coded bits
    for s2 in range(S):
        for h in (0, 1):
            s = (s2 >> 1) | (h << (fec.K - 2))
            reg = (s << 1) | (s2 & 1)
            prev[s2, h] = s
            sign[s2, h] = [2 * par(reg & fec.G0) - 1,
                           2 * par(reg & fec.G1) - 1]
    pm = np.full((L, S), -np.inf)
    pm[:, 0] = 0.0
    choice = np.zeros((T, L, S), np.int64)
    soft = soft.astype(np.float64)
    for t in range(T):
        bm = np.einsum("lk,shk->lsh", soft[:, t], sign)
        cand = pm[:, prev] + bm                   # [L, S, 2]
        choice[t] = np.argmax(cand, axis=-1)
        pm = np.max(cand, axis=-1)
    state = np.zeros(L, np.int64)
    bits = np.zeros((L, T), np.uint8)
    for t in range(T - 1, -1, -1):
        bits[:, t] = state & 1
        state = prev[state, choice[t, np.arange(L), state]]
    return bits[:, :n_bits]


def _metric(soft, bits):
    coded = fec.conv_encode_bits_batch(bits).reshape(soft.shape)
    return np.sum(soft.astype(np.float64) * (2.0 * coded - 1.0),
                  axis=(1, 2))


def _coded_soft(rng, lanes, n_bits, sigma):
    bits = rng.randint(0, 2, (lanes, n_bits)).astype(np.uint8)
    coded = fec.conv_encode_bits_batch(bits).reshape(lanes, -1, 2)
    soft = (2.0 * coded - 1.0) + sigma * rng.randn(*coded.shape)
    return soft.astype(np.float32), bits


def _check_ml(soft, n_bits, truth=None):
    got = np.asarray(fec._viterbi_core(jnp.asarray(soft), n_bits))
    ref = _np_viterbi(soft, n_bits)
    # the lax decoder returns a maximum-likelihood path: its metric
    # equals the float64 decoder's up to f32 path-metric rounding
    m_got, m_ref = _metric(soft, got), _metric(soft, ref)
    tol = 1e-5 * np.abs(soft).sum(axis=(1, 2)) + 1e-6
    assert (m_got >= m_ref - tol).all()
    if truth is not None:
        np.testing.assert_array_equal(got, truth)
    return got, ref


@pytest.mark.parametrize("n_bits", [16, 18 * 8, 7])
def test_viterbi_ml_on_coded_streams(n_bits):
    soft, _ = _coded_soft(np.random.RandomState(3 + n_bits), 256, n_bits,
                          sigma=0.7)
    got, ref = _check_ml(soft, n_bits)
    assert np.mean(got == ref) > 0.999


def test_viterbi_ml_on_pure_noise():
    soft = np.random.RandomState(5).randn(128, 38, 2).astype(np.float32)
    _check_ml(soft, 32)


def test_viterbi_ml_near_ties():
    rng = np.random.RandomState(6)
    soft = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0],
                      size=(128, 30, 2)).astype(np.float32)
    _check_ml(soft, 24)


def test_viterbi_decodes_clean_stream_exactly():
    soft, bits = _coded_soft(np.random.RandomState(8), 64, 100, sigma=0.0)
    _check_ml(soft, 100, truth=bits)


def test_viterbi_payload40_body_shape():
    n_bits = 8 * (40 + 2)                      # payload + len + CRC
    soft, _ = _coded_soft(np.random.RandomState(9), 1024, n_bits,
                          sigma=0.7)
    _check_ml(soft, n_bits)


@pytest.mark.parametrize("n_bits", [10, 4])
def test_viterbi_group_boundary_lengths(n_bits):
    # T = 16 and T = 10: a whole normalization group and a remainder
    soft, _ = _coded_soft(np.random.RandomState(n_bits), 128, n_bits,
                          sigma=1.0)
    _check_ml(soft, n_bits)


def test_viterbi_long_trellis():
    n_bits = 8 * (128 + 2)                     # payload-128 body
    soft, bits = _coded_soft(np.random.RandomState(10), 4, n_bits,
                             sigma=0.0)
    _check_ml(soft, n_bits, truth=bits)
