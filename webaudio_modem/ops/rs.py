"""Reed-Solomon block codec, batched over channels, device-native.

The reference's FEC memo lists block codes as a representative FEC
family with RS(255,223) as its worked example
(/root/reference/advanced-error-correction.md:157-160), alongside the
convolutional+Viterbi branch implemented in ops/fec.py.  This module
implements that branch as batched device code:

  * every stage is batched over a leading [B] axis — one program
    corrects a whole farm of codewords;
  * GF(256) arithmetic is log-domain table gathers (ops/gf256.py),
    so syndromes, Chien search and Forney magnitudes are pure
    elementwise/gather/reduce pipelines with static shapes;
  * the only sequential parts are a ``lax.scan`` over codeword bytes
    (syndrome Horner) and the fixed 2t-step Berlekamp-Massey
    recursion, unrolled at trace time (r <= 32 steps) with all
    branching as ``jnp.where`` masks — no data-dependent control
    flow, exactly the XLA-friendly shape of the Viterbi kernel;
  * corrections are applied by evaluating the error value at EVERY
    position and masking — never a scatter with repeated indices,
    which serializes.

Supports the standard RS(n=255, k) and shortened codes (n < 255,
same parity count): a shortened codeword is the tail of a full one
whose leading data bytes are zero.

Decode contract: ``rs_decode_batch`` returns the corrected codeword,
a per-channel ``ok`` flag (true iff the word decodes to a valid
codeword with <= t corrections — verified by re-computing syndromes
on the corrected word), and the per-channel correction count.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from webaudio_modem.ops import gf256

FCR = 0                 # first consecutive root exponent: g roots
                        # alpha^0 .. alpha^(r-1)


@functools.lru_cache(maxsize=None)
def generator_poly(r: int) -> np.ndarray:
    """g(x) = prod_{i=0..r-1} (x - alpha^(FCR+i)), coefficients
    HIGH-degree first (monic: g[0] = 1), length r + 1."""
    exp, _ = gf256.tables()
    g = np.array([1], np.int32)
    for i in range(r):
        g = gf256.np_poly_mul(g, np.array([1, exp[(FCR + i) % 255]],
                                          np.int32))
    return g


def _check_nk(n: int, k: int) -> int:
    if not (0 < k < n <= 255):
        raise ValueError(f"invalid RS code (n={n}, k={k}); need "
                         "0 < k < n <= 255")
    r = n - k
    if r % 2:
        raise ValueError(f"parity count must be even, got {r}")
    return r


@functools.partial(jax.jit, static_argnums=(1, 2))
def _encode(data, n: int, k: int):
    r = n - k
    g_low = jnp.asarray(generator_poly(r)[1:])      # [r], after the 1
    B = data.shape[0]
    data = data.astype(jnp.int32)

    def step(rem, d):
        fb = d ^ rem[:, 0]
        shifted = jnp.concatenate(
            [rem[:, 1:], jnp.zeros((B, 1), jnp.int32)], axis=1)
        return shifted ^ gf256.mul(fb[:, None], g_low[None, :]), None

    rem0 = jnp.zeros((B, r), jnp.int32)
    rem, _ = jax.lax.scan(step, rem0, data.T)
    return jnp.concatenate([data, rem], axis=1)


def rs_encode_batch(data, n: int = 255, k: int = 223):
    """Systematic RS encode: data [B, k] bytes -> codewords [B, n]
    (data followed by n - k parity bytes).  One ``lax.scan`` over the
    k data bytes; everything else elementwise over the batch."""
    _check_nk(n, k)
    data = jnp.asarray(data)
    if data.ndim != 2 or data.shape[1] != k:
        raise ValueError(f"data must be [B, {k}], got {data.shape}")
    return _encode(data, n, k)


def _syndromes(recv, n: int, r: int):
    """S_j = recv(alpha^(FCR+j)) for j in [0, r): Horner over the n
    byte columns (coefficients high-first on the wire)."""
    exp, _ = gf256.tables()
    alphas = jnp.asarray(
        np.array([exp[(FCR + j) % 255] for j in range(r)], np.int32))

    def step(S, c):
        return gf256.mul(S, alphas[None, :]) ^ c[:, None], None

    B = recv.shape[0]
    S0 = jnp.zeros((B, r), jnp.int32)
    S, _ = jax.lax.scan(step, S0, recv.T)
    return S                                         # [B, r]


def _berlekamp_massey(S, r: int):
    """Batched Massey recursion -> (Lambda [B, t+1] low-first, L [B]).

    Fixed r iterations unrolled at trace time; per-channel branching
    is ``where`` masks.  B(x) is shifted by x at the START of each
    iteration, so the x^m factor accumulates implicitly (on a length
    change B resets to the pre-update Lambda, i.e. m restarts at 1).
    """
    t = r // 2
    size = t + 1
    Bsz = S.shape[0]
    C = jnp.zeros((Bsz, size), jnp.int32).at[:, 0].set(1)
    Bp = jnp.zeros((Bsz, size), jnp.int32).at[:, 0].set(1)
    b = jnp.ones((Bsz,), jnp.int32)
    L = jnp.zeros((Bsz,), jnp.int32)

    for i in range(r):
        Bp = jnp.concatenate(
            [jnp.zeros((Bsz, 1), jnp.int32), Bp[:, :-1]], axis=1)
        # discrepancy d = sum_j C_j * S_{i-j} (j <= min(i, t))
        jmax = min(i, size - 1)
        terms = gf256.mul(C[:, :jmax + 1],
                          S[:, i - jmax:i + 1][:, ::-1])
        d = jax.lax.reduce(terms, jnp.int32(0),
                           jnp.bitwise_xor, (1,))
        coef = gf256.mul(d, gf256.inv(b))
        T = C ^ gf256.mul(coef[:, None], Bp)
        grow = (d != 0) & (2 * L <= i)
        Bp = jnp.where(grow[:, None], C, Bp)
        b = jnp.where(grow, d, b)
        L = jnp.where(grow, i + 1 - L, L)
        C = jnp.where((d != 0)[:, None], T, C)
    return C, L


@functools.lru_cache(maxsize=None)
def _eval_powers(n: int, size: int) -> np.ndarray:
    """P[idx, j] = (alpha^-(n-1-idx))^j — evaluation points for the
    codeword byte at index ``idx`` (wire order, high-first), as a
    static [n, size] gather table."""
    exp, _ = gf256.tables()
    idx = np.arange(n)[:, None]
    j = np.arange(size)[None, :]
    return exp[(-(n - 1 - idx) * j) % 255].astype(np.int32)


def _poly_eval_all(coeffs, P):
    """Evaluate low-first polynomials [B, size] at every codeword
    position: XOR-reduce of masked products against the static power
    table [n, size] -> [B, n]."""
    prod = gf256.mul(coeffs[:, None, :], P[None, :, :])
    return jax.lax.reduce(prod, jnp.int32(0), jnp.bitwise_xor, (2,))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _decode(recv, n: int, k: int):
    r = n - k
    t = r // 2
    size = t + 1
    recv = recv.astype(jnp.int32)

    S = _syndromes(recv, n, r)                       # [B, r]
    clean = jnp.all(S == 0, axis=1)

    C, L = _berlekamp_massey(S, r)                   # [B, t+1], [B]

    # Chien search: roots of Lambda over all positions
    P = jnp.asarray(_eval_powers(n, size))
    lam_eval = _poly_eval_all(C, P)                  # [B, n]
    err_mask = lam_eval == 0                         # candidate errors
    n_err = jnp.sum(err_mask.astype(jnp.int32), axis=1)

    # Forney: Omega = S(x) C(x) mod x^r (low-first), then
    # e = X * Omega(X^-1) / C'(X^-1) at each error location
    omega_cols = []
    for m in range(r):
        jmax = min(m, size - 1)
        terms = gf256.mul(C[:, :jmax + 1],
                          S[:, m - jmax:m + 1][:, ::-1])
        omega_cols.append(
            jax.lax.reduce(terms, jnp.int32(0), jnp.bitwise_xor, (1,)))
    omega = jnp.stack(omega_cols, axis=1)            # [B, r]
    # formal derivative over GF(2^m): odd-degree coefficients shift
    dC = C[:, 1::2]
    dsize = dC.shape[1]
    # C'(x) has coefficients dC_j at x^(2j)
    Pd = jnp.asarray(_eval_powers(n, 2 * dsize)[:, 0::2])
    Po = jnp.asarray(_eval_powers(n, r))
    om_eval = _poly_eval_all(omega, Po)              # [B, n]
    dC_eval = _poly_eval_all(dC, Pd)                 # [B, n]
    exp, _ = gf256.tables()
    X = jnp.asarray(exp[(np.arange(n - 1, -1, -1)) % 255]
                    .astype(np.int32))               # X_idx = a^(n-1-idx)
    mag = gf256.mul(X[None, :],
                    gf256.mul(om_eval, gf256.inv(dC_eval)))
    corrected = recv ^ jnp.where(err_mask, mag, 0)

    # validity: corrected word must be a codeword and the locator
    # degree must be consistent and within the correction radius
    S2 = _syndromes(corrected, n, r)
    ok = (jnp.all(S2 == 0, axis=1) & (n_err == L) & (L <= t)) | clean
    n_fix = jnp.where(clean, 0, n_err)
    return corrected, ok, n_fix


def rs_decode_batch(recv, n: int = 255, k: int = 223):
    """Decode a batch of (possibly corrupted) codewords [B, n].

    Returns ``(corrected [B, n], ok [B] bool, n_corrected [B])``.
    ``ok`` is true iff the corrected word re-checks as a codeword
    with at most t = (n-k)/2 symbol corrections; when false the
    channel's ``corrected`` content is unreliable (detected failure).
    """
    _check_nk(n, k)
    recv = jnp.asarray(recv)
    if recv.ndim != 2 or recv.shape[1] != n:
        raise ValueError(f"recv must be [B, {n}], got {recv.shape}")
    return _decode(recv, n, k)


# -- block interleaver --------------------------------------------------------

def block_interleave(x, depth: int):
    """[B, depth * width] byte rows -> interleaved rows: write
    row-major into a [depth, width] block, read column-major.  A
    burst of d consecutive wire errors lands <= ceil(d / depth) deep
    in any one codeword — the memo's burst-protection companion to
    block codes.  Pure reshape/transpose (free in this layout)."""
    x = jnp.asarray(x)
    B, total = x.shape
    if total % depth:
        raise ValueError(f"row length {total} not divisible by "
                         f"depth {depth}")
    w = total // depth
    return x.reshape(B, depth, w).transpose(0, 2, 1).reshape(B, total)


def block_deinterleave(x, depth: int):
    """Inverse of ``block_interleave`` (same depth)."""
    x = jnp.asarray(x)
    B, total = x.shape
    if total % depth:
        raise ValueError(f"row length {total} not divisible by "
                         f"depth {depth}")
    w = total // depth
    return x.reshape(B, w, depth).transpose(0, 2, 1).reshape(B, total)
