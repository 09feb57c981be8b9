"""Turbo codes: parallel-concatenated RSC + batched max-log-MAP.

The last of the four FEC families the reference's design memo names
(/root/reference/advanced-error-correction.md:167-169: ターボ符号 —
two+ convolutional codes combined through an interleaver; required
information: encoding parameters incl. the interleaver, and block
boundaries).  Together with ops/fec.py (convolutional+Viterbi),
ops/rs.py (block/Reed-Solomon) and ops/ldpc.py this completes the
memo's algorithm list, as batched device code:

  * two identical rate-1/2 RSC (recursive systematic convolutional)
    component encoders, feedback 1+D^2+D^3 / forward 1+D+D^3 (8
    states), joined by a deterministic seeded interleaver — both link
    ends rebuild the code from (K, seed) alone;
  * the decoder is iterative max-log-MAP (BCJR with the max
    approximation): per component, one FORWARD ``lax.scan`` (alpha),
    one BACKWARD scan (beta, realized as a forward scan over the
    reversed stream), and an elementwise extrinsic combine — the
    same static-trellis [.., 8]-plane shape as the Viterbi kernel,
    batched over [B] channels with no data-dependent control flow;
  * component 1 is trellis-terminated with 3 tail pairs (the memo's
    trellis-termination note); component 2 is left open (standard) —
    its beta initializes uniform.

LLR convention matches ops/ldpc.py: positive = bit 0; BPSK maps bit
b -> 1 - 2b.  Turbo codes carry no intrinsic validity check (unlike
the RS/LDPC decoders' syndromes) — layer a CRC above, as the framing
layer does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

M = 3                    # RSC memory
N_STATES = 1 << M        # 8
_F = (0, 1, 1)           # feedback taps on (a_{t-1}, a_{t-2}, a_{t-3})
_G = (1, 0, 1)           # forward taps on the same (plus a_t itself)
TAIL = M                 # termination steps for component 1
_EXT_SCALE = 0.75        # max-log-MAP extrinsic damping (cf. ldpc.py's
                         # _MINSUM_SCALE): max-approx extrinsics are
                         # overconfident; scaling them on exchange
                         # recovers most of the true-MAP gain


@functools.lru_cache(maxsize=1)
def _tables() -> Tuple[np.ndarray, ...]:
    """Static RSC trellis tables.

    next_state[s, d], parity[s, d] for input bit d from state
    s = (a_{t-1}, a_{t-2}, a_{t-3}) packed MSB-first; and the
    predecessor view pred[s2, h], pred_d[s2, h], pred_p[s2, h] for
    the backward/forward scans (h indexes the two incoming edges).
    term_bit[s] is the input that drives the feedback to zero (the
    termination tail).
    """
    nxt = np.zeros((N_STATES, 2), np.int32)
    par = np.zeros((N_STATES, 2), np.int8)
    term = np.zeros((N_STATES,), np.int8)
    for s in range(N_STATES):
        regs = [(s >> (M - 1 - i)) & 1 for i in range(M)]  # a_{t-1..t-3}
        fb = (_F[0] & regs[0]) ^ (_F[1] & regs[1]) ^ (_F[2] & regs[2])
        term[s] = fb                         # d = fb makes a_t = 0
        for d in (0, 1):
            a = d ^ fb
            p = a ^ (_G[0] & regs[0]) ^ (_G[1] & regs[1]) \
                ^ (_G[2] & regs[2])
            nxt[s, d] = (a << (M - 1)) | (s >> 1)
            par[s, d] = p
    pred = np.zeros((N_STATES, 2), np.int32)
    pred_d = np.zeros((N_STATES, 2), np.int8)
    pred_p = np.zeros((N_STATES, 2), np.int8)
    fill = np.zeros((N_STATES,), np.int32)
    for s in range(N_STATES):
        for d in (0, 1):
            s2 = nxt[s, d]
            h = fill[s2]
            pred[s2, h] = s
            pred_d[s2, h] = d
            pred_p[s2, h] = par[s, d]
            fill[s2] += 1
    assert (fill == 2).all()
    return nxt, par, term, pred, pred_d, pred_p


def interleaver(K: int, seed: int = 0) -> np.ndarray:
    """Deterministic seeded permutation — the memo's 'required
    information' reduces to (K, seed)."""
    return np.random.RandomState(seed).permutation(K)


def _rsc_encode_np(bits: np.ndarray, terminate: bool):
    """Batched host RSC encode: bits [B, K] -> (sys, par) including the
    tail pairs when terminated.  Vectorized over the batch; the K-step
    register walk is a host loop over time (configure/TX-side, cheap)."""
    nxt, par, term, *_ = _tables()
    B, K = bits.shape
    s = np.zeros((B,), np.int32)
    sys_out = []
    par_out = []
    for t in range(K):
        d = bits[:, t].astype(np.int32)
        sys_out.append(d)
        par_out.append(par[s, d])
        s = nxt[s, d]
    if terminate:
        for _ in range(TAIL):
            d = term[s].astype(np.int32)
            sys_out.append(d)
            par_out.append(par[s, d])
            s = nxt[s, d]
        assert (s == 0).all()
    return (np.stack(sys_out, 1).astype(np.int8),
            np.stack(par_out, 1).astype(np.int8))


class TurboCode:
    """Rate ~1/3 parallel-concatenated turbo code over blocks of K
    data bits.  Wire layout per codeword (n = 3K + 2*TAIL):

        [ sys(K) | par1(K) | sys_tail(TAIL) | par1_tail(TAIL) | par2(K) ]
    """

    DEFAULT_ITERS = 8

    def __init__(self, K: int = 256, seed: int = 0):
        self.K = K
        self.k = K               # generic block-code alias (cf. LDPCCode.k)
        self.seed = seed
        self.perm = interleaver(K, seed)
        self.inv_perm = np.argsort(self.perm)
        self.n = 3 * K + 2 * TAIL
        self._decode = jax.jit(self._decode_impl,
                               static_argnames=("iters",))

    # -- encode ---------------------------------------------------------

    def encode_batch(self, data) -> np.ndarray:
        """data bits [B, K] (0/1) -> codewords [B, n] (0/1, int8)."""
        data = np.asarray(data, np.int8)
        if data.ndim != 2 or data.shape[1] != self.K:
            raise ValueError(f"data must be [B, {self.K}], "
                             f"got {data.shape}")
        sys1, par1 = _rsc_encode_np(data, terminate=True)
        _, par2 = _rsc_encode_np(data[:, self.perm], terminate=False)
        K = self.K
        return np.concatenate([
            sys1[:, :K], par1[:, :K],
            sys1[:, K:], par1[:, K:], par2], axis=1).astype(np.int8)

    # -- decode ---------------------------------------------------------

    @staticmethod
    def _max_log_map(l_sys, l_par, alpha0, beta_init):
        """One component max-log-MAP pass, batched.

        l_sys/l_par: [B, T] LLRs (positive = bit 0) for the
        systematic and parity streams; alpha0/beta_init: [N_STATES]
        initial metrics.  Returns the a-posteriori LLR [B, T].
        """
        _, _, _, pred_np, pred_d_np, pred_p_np = _tables()
        pred = jnp.asarray(pred_np)                     # [8, 2]
        d_sgn = jnp.asarray(1.0 - 2.0 * pred_d_np,
                            jnp.float32)                # +1 for d=0
        p_sgn = jnp.asarray(1.0 - 2.0 * pred_p_np, jnp.float32)
        d_bit = jnp.asarray(pred_d_np.astype(np.float32))

        B = l_sys.shape[0]
        # branch metric arriving at s2 via edge h at time t:
        # 0.5*(sys_sign*l_sys + par_sign*l_par)
        ls = jnp.moveaxis(l_sys, 1, 0)                  # [T, B]
        lp = jnp.moveaxis(l_par, 1, 0)

        def gamma(ls_t, lp_t):
            return 0.5 * (ls_t[:, None, None] * d_sgn
                          + lp_t[:, None, None] * p_sgn)  # [B, 8, 2]

        def fwd(alpha, x):
            ls_t, lp_t = x
            cand = jnp.take(alpha, pred, axis=-1) + gamma(ls_t, lp_t)
            new = jnp.max(cand, axis=-1)                # [B, 8]
            new = new - jnp.max(new, axis=-1, keepdims=True)
            return new, alpha                           # emit PRE-step

        alpha_first = jnp.broadcast_to(alpha0[None, :],
                                       (B, N_STATES)).astype(jnp.float32)
        _, alphas = jax.lax.scan(fwd, alpha_first, (ls, lp))
        # alphas[t] = alpha BEFORE consuming symbol t        [T, B, 8]

        # beta: backward recursion as a forward scan over reversed time.
        # beta_prev[s] = max_d (gamma(s->s2) + beta[s2]); express via the
        # successor tables by scattering the predecessor view: for edge
        # (s2, h): contribution to state pred[s2, h].
        nxt_np, par_np, _, _, _, _ = _tables()
        nxt_j = jnp.asarray(nxt_np)                     # [8, 2]
        dsg = jnp.asarray(1.0 - 2.0 * np.arange(2), jnp.float32)  # [2]
        psg = jnp.asarray(1.0 - 2.0 * par_np.astype(np.float32))  # [8,2]

        def bwd(beta, x):
            ls_t, lp_t = x
            g = 0.5 * (ls_t[:, None, None] * dsg[None, None, :]
                       + lp_t[:, None, None] * psg[None, :, :])  # [B,8,2]
            cand = g + jnp.take(beta, nxt_j, axis=-1)   # [B, 8, 2]
            new = jnp.max(cand, axis=-1)
            new = new - jnp.max(new, axis=-1, keepdims=True)
            return new, beta                            # emit POST-step

        beta_last = jnp.broadcast_to(beta_init[None, :],
                                     (B, N_STATES)).astype(jnp.float32)
        _, betas_rev = jax.lax.scan(bwd, beta_last,
                                    (ls[::-1], lp[::-1]))
        betas = betas_rev[::-1]       # betas[t] = beta AFTER symbol t

        # a-posteriori LLR: max over d=0 edges minus max over d=1 edges
        # full[t, b, s2, h] = alpha_t[pred] + gamma_t + beta_t[s2]
        full = (jnp.take(alphas, pred, axis=-1)
                + 0.5 * (ls[:, :, None, None] * d_sgn
                         + lp[:, :, None, None] * p_sgn)
                + betas[:, :, :, None])
        m0 = jnp.max(jnp.where(d_bit[None, None] == 0, full, -jnp.inf),
                     axis=(-1, -2))
        m1 = jnp.max(jnp.where(d_bit[None, None] == 1, full, -jnp.inf),
                     axis=(-1, -2))
        return jnp.moveaxis(m0 - m1, 0, 1)              # [B, T]

    def _decode_impl(self, llrs, iters: int):
        K, T1 = self.K, self.K + TAIL
        perm = jnp.asarray(self.perm)
        inv = jnp.asarray(self.inv_perm)
        l_sys = llrs[:, :K]
        l_par1 = llrs[:, K:2 * K]
        l_st = llrs[:, 2 * K:2 * K + TAIL]
        l_pt = llrs[:, 2 * K + TAIL:2 * K + 2 * TAIL]
        l_par2 = llrs[:, 2 * K + 2 * TAIL:]

        sys1 = jnp.concatenate([l_sys, l_st], axis=1)   # [B, K+TAIL]
        par1 = jnp.concatenate([l_par1, l_pt], axis=1)
        zeros_tail = jnp.zeros_like(l_st)

        a0 = jnp.full((N_STATES,), -1e9).at[0].set(0.0)
        b_term = jnp.full((N_STATES,), -1e9).at[0].set(0.0)
        b_open = jnp.zeros((N_STATES,))

        def body(_, la1):
            # component 1 (terminated): a priori only on the K data bits
            in1 = sys1 + jnp.concatenate([la1, zeros_tail], axis=1)
            llr1 = self._max_log_map(in1, par1, a0, b_term)
            le1 = _EXT_SCALE * (llr1[:, :K] - in1[:, :K])
            # component 2 (open): interleaved systematic + a priori
            in2 = l_sys[:, perm] + le1[:, perm]
            llr2 = self._max_log_map(in2, l_par2, a0, b_open)
            le2 = _EXT_SCALE * (llr2 - in2)
            return le2[:, inv]                          # new la1

        la1 = jax.lax.fori_loop(
            0, iters, body, jnp.zeros_like(l_sys))
        # final combine: channel + a priori (from comp 2) + comp 1 ext
        in1 = sys1 + jnp.concatenate([la1, zeros_tail], axis=1)
        llr1 = self._max_log_map(in1, par1, a0, b_term)
        return (llr1[:, :K] < 0).astype(jnp.int32)

    def decode_batch(self, llrs, iters=None):
        """Channel LLRs [B, n] (positive = bit 0, wire layout as
        ``encode_batch``) -> decoded data bits [B, K].  ``iters``
        defaults to ``DEFAULT_ITERS``."""
        llrs = jnp.asarray(llrs, jnp.float32)
        if llrs.ndim != 2 or llrs.shape[1] != self.n:
            raise ValueError(f"llrs must be [B, {self.n}], "
                             f"got {llrs.shape}")
        return self._decode(
            llrs, iters=self.DEFAULT_ITERS if iters is None else iters)

    # value semantics (cf. LDPCCode): equal (K, seed) builds the
    # identical code, and the soft frame path uses instances as jit
    # static args — identity hashing would recompile per instance.
    def __hash__(self):
        return hash((self.K, self.seed))

    def __eq__(self, other):
        return (type(other) is TurboCode
                and (other.K, other.seed) == (self.K, self.seed))


@functools.lru_cache(maxsize=4)
def default_code(K: int = 256, seed: int = 0) -> TurboCode:
    return TurboCode(K=K, seed=seed)
