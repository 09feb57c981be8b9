"""LDPC codes: batched normalized-min-sum belief propagation.

The reference's FEC memo lists LDPC alongside convolutional and block
codes as the representative FEC algorithms, naming the parity-check
matrix, code/data lengths and block boundaries as the required
information (/root/reference/advanced-error-correction.md:162-165 and
its LDPC reference link).  This module implements the family
as batched device code, completing the memo's algorithm list (conv+Viterbi in
ops/fec.py, Reed-Solomon in ops/rs.py):

  * a regular Gallager (wc, wr) parity-check ensemble built at
    configure time with a deterministic seed search that minimizes
    4-cycles (the short cycles that hurt min-sum);
  * ENCODING as one GF(2) matmul: Gaussian elimination over GF(2)
    (host, configure-time) yields parity = M @ data mod 2, so a batch
    of codewords is a single int32 matmul + mask — MXU-shaped, like
    the sync correlator;
  * DECODING as fixed-iteration normalized min-sum message passing
    over dense [m, wr] / [n, wc] edge tables: every update is a
    static-shape gather + segment reduction over the batch, the
    iteration is one ``lax.fori_loop`` — no data-dependent control
    flow, no scatter;
  * a trustworthy ``ok``: the hard decision is re-checked against the
    full parity-check matrix (syndrome == 0) per channel.

LLR convention: positive = bit 0 (llr = log P(0)/P(1)), matching the
soft-decision Viterbi's correlation inputs after negation; BPSK
mapping bit b -> 1 - 2b.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

_MINSUM_SCALE = 0.75     # normalized min-sum (standard correction)


def _gallager_h(n: int, wc: int, wr: int, seed: int) -> np.ndarray:
    """Regular Gallager ensemble: wc stacked bands of n/wr rows; band 0
    is the sequential assignment, the others are column permutations."""
    if n % wr:
        raise ValueError(f"n={n} must be divisible by wr={wr} "
                         "(each band tiles the columns in wr-blocks)")
    m = n * wc // wr
    band_rows = n // wr
    rng = np.random.RandomState(seed)
    H = np.zeros((m, n), np.uint8)
    for b in range(wc):
        perm = np.arange(n) if b == 0 else rng.permutation(n)
        for i in range(band_rows):
            H[b * band_rows + i, perm[i * wr:(i + 1) * wr]] = 1
    return H


def _four_cycles(H: np.ndarray) -> int:
    """Count 4-cycles: pairs of rows sharing >= 2 columns."""
    overlap = (H.astype(np.int32) @ H.T.astype(np.int32))
    np.fill_diagonal(overlap, 0)
    return int((overlap * (overlap - 1) // 2).sum()) // 2


def _gf2_encoder_matrix(H: np.ndarray):
    """Gaussian elimination over GF(2) -> (M [r, k], pivot_cols [r],
    data_cols [k]) with parity = M @ data mod 2 placed at pivot_cols.

    Row-reduces a working copy of H to identity on the pivot columns;
    the reduced non-pivot block IS B^-1 A.  Regular Gallager matrices
    are rank-DEFICIENT by construction (each band's rows sum to the
    all-ones vector), so r = rank(H) < m and the code rate is
    k/n = (n - r)/n; the dependent rows stay in H as redundant checks
    for the decoder (solving the reduced system satisfies the full
    row space).
    """
    m, n = H.shape
    W = H.copy().astype(np.uint8)
    pivot_cols = []
    row = 0
    for col in range(n):
        if row == m:
            break
        sel = np.nonzero(W[row:, col])[0]
        if len(sel) == 0:
            continue
        pr = row + sel[0]
        if pr != row:
            W[[row, pr]] = W[[pr, row]]
        # eliminate everywhere else (full reduction)
        hits = np.nonzero(W[:, col])[0]
        hits = hits[hits != row]
        W[hits] ^= W[row]
        pivot_cols.append(col)
        row += 1
    r = len(pivot_cols)
    pivot_cols = np.asarray(pivot_cols)
    data_cols = np.setdiff1d(np.arange(n), pivot_cols)
    M = W[:r, :][:, data_cols]              # [r, k] = B^-1 A
    return M, pivot_cols, data_cols


class LDPCCode:
    """A fixed (n, wc, wr) regular LDPC code with batched device
    encode/decode.  Construction is deterministic (seeded 4-cycle
    search), so both ends of a link build the identical code from the
    same parameters — the memo's 'required information' is just
    (n, wc, wr, seed)."""

    DEFAULT_ITERS = 30

    def __init__(self, n: int = 648, wc: int = 3, wr: int = 6,
                 seeds: int = 8):
        self._key = (n, wc, wr, seeds)
        best = None
        for seed in range(seeds):
            H = _gallager_h(n, wc, wr, seed)
            c4 = _four_cycles(H)
            if best is None or c4 < best[0]:
                best = (c4, seed, H)
        self.four_cycles, self.seed, H = best
        self.H = H
        self.m, self.n = H.shape
        self.wc, self.wr = wc, wr
        M, pivot_cols, data_cols = _gf2_encoder_matrix(H)
        self.k = len(data_cols)        # n - rank(H); see encoder note
        self._M_T = jnp.asarray(M.T.astype(np.int32))        # [k, m]
        self._pivot_cols = jnp.asarray(pivot_cols)
        self._data_cols = jnp.asarray(data_cols)
        # dense edge tables: checks are exactly wr-regular by
        # construction, variables exactly wc-regular
        cv = np.stack([np.nonzero(H[c])[0] for c in range(self.m)])
        self._cv_idx = jnp.asarray(cv.astype(np.int32))      # [m, wr]
        ve = np.stack([np.nonzero(H[:, v])[0] for v in range(self.n)])
        # flat edge id of (check c, slot s) = c * wr + s; build each
        # variable's wc edge ids
        slot = np.zeros((self.m,), np.int64)
        ve_edges = np.zeros((self.n, wc), np.int64)
        fill = np.zeros((self.n,), np.int64)
        for c in range(self.m):
            for s, v in enumerate(cv[c]):
                ve_edges[v, fill[v]] = c * wr + s
                fill[v] += 1
        assert (fill == wc).all()
        del slot
        self._ve_idx = jnp.asarray(ve_edges.astype(np.int32))  # [n, wc]
        self._encode = jax.jit(self._encode_impl)
        self._decode = jax.jit(self._decode_impl,
                               static_argnames=("iters",))

    # -- encode ---------------------------------------------------------

    def _encode_impl(self, data):
        B = data.shape[0]
        d = data.astype(jnp.int32)
        parity = (d @ self._M_T) & 1                       # GF(2) matmul
        code = jnp.zeros((B, self.n), jnp.int32)
        code = code.at[:, self._data_cols].set(d)
        code = code.at[:, self._pivot_cols].set(parity)
        return code

    def encode_batch(self, data):
        """data bits [B, k] (0/1) -> codewords [B, n].  One int32
        matmul (mod 2) + two static index placements."""
        data = jnp.asarray(data)
        if data.ndim != 2 or data.shape[1] != self.k:
            raise ValueError(f"data must be [B, {self.k}], "
                             f"got {data.shape}")
        return self._encode(data)

    # -- decode ---------------------------------------------------------

    def _decode_impl(self, llrs, iters: int):
        B = llrs.shape[0]
        llrs = llrs.astype(jnp.float32)
        cv, ve = self._cv_idx, self._ve_idx

        def iteration(_, m_cv):
            # variable totals: llr + sum of incoming check messages
            flat = m_cv.reshape(B, self.m * self.wr)
            incoming = flat[:, ve].sum(axis=-1)            # [B, n]
            total = llrs + incoming
            # var->check along each edge: total minus that edge's own
            m_vc = total[:, cv] - m_cv                     # [B, m, wr]
            # check->var: normalized min-sum over the OTHER edges
            sgn = jnp.sign(m_vc) + (m_vc == 0)             # 0 -> +1
            row_sgn = jnp.prod(sgn, axis=-1, keepdims=True)
            mag = jnp.abs(m_vc)
            m1 = jnp.min(mag, axis=-1, keepdims=True)
            is_min = mag == m1
            # second-smallest: min over entries with the unique
            # argmin masked out (ties make m2 == m1, which is exact)
            first = jnp.cumsum(is_min, axis=-1) == 1
            masked = jnp.where(is_min & first, jnp.inf, mag)
            m2 = jnp.min(masked, axis=-1, keepdims=True)
            out_mag = jnp.where(is_min & first, m2, m1)
            return _MINSUM_SCALE * row_sgn * sgn * out_mag

        m_cv0 = jnp.zeros((B, self.m, self.wr), jnp.float32)
        m_cv = jax.lax.fori_loop(0, iters, iteration, m_cv0)

        flat = m_cv.reshape(B, self.m * self.wr)
        total = llrs + flat[:, ve].sum(axis=-1)
        hard = (total < 0).astype(jnp.int32)               # [B, n]
        syndrome = jax.lax.reduce(hard[:, cv], jnp.int32(0),
                                  jnp.bitwise_xor, (2,))
        ok = jnp.all(syndrome == 0, axis=-1)
        return hard[:, self._data_cols], ok

    def decode_batch(self, llrs, iters=None):
        """Channel LLRs [B, n] (positive = bit 0) -> (data bits
        [B, k], ok [B]).  ``ok`` is the full syndrome check of the
        hard decision — when false the decode did not converge.
        ``iters`` defaults to ``DEFAULT_ITERS``."""
        llrs = jnp.asarray(llrs)
        if llrs.ndim != 2 or llrs.shape[1] != self.n:
            raise ValueError(f"llrs must be [B, {self.n}], "
                             f"got {llrs.shape}")
        return self._decode(
            llrs, iters=self.DEFAULT_ITERS if iters is None else iters)

    # value semantics: equal construction params build the identical
    # code (deterministic seed search), and the soft frame path passes
    # instances as jit STATIC args — identity hashing would recompile
    # per instance.
    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return (type(other) is LDPCCode and other._key == self._key)


@functools.lru_cache(maxsize=4)
def default_code(n: int = 648, wc: int = 3, wr: int = 6) -> LDPCCode:
    """Process-wide cached construction (Gaussian elimination and the
    seed search cost a second or two at n=648)."""
    return LDPCCode(n=n, wc=wc, wr=wr)
