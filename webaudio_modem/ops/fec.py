"""Forward error correction: convolutional code + batched Viterbi.

The reference ships a DESIGN MEMO for this layer and never implements
it (/root/reference/advanced-error-correction.md: soft-decision
demodulation + FEC + framing, naming convolutional codes with Viterbi
decoding and soft-value decoding as the target algorithms).  This
module implements that plan as batched device code:

  * rate-1/2, K=7 convolutional encoder with the industry-standard
    generators G0=0o171, G1=0o133 (the "Voyager/NASA" code, free
    distance 10);
  * a fully vectorized Viterbi decoder as ONE ``lax.scan`` over time:
    the 64-state add-compare-select butterfly is expressed with static
    predecessor tables, so each step is a handful of [..., 64]
    elementwise ops — batching over independent channels/frames is a
    leading axis, exactly like the demod kernels;
  * hard- AND soft-decision inputs: branch metrics are correlations
    against ±1 expectations, so hard bits are just ±1 soft values
    (the memo's soft-value design).

Host-side byte framing on top lives in transports/fec_frame.py.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

K = 7                   # constraint length
N_STATES = 1 << (K - 1)  # 64
G0 = 0o171
G1 = 0o133
RATE_INV = 2            # rate 1/2: two coded bits per input bit


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=1)
def _tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static trellis tables.

    Returns (out [64, 2, 2], pred [64, 2], pred_out [64, 2, 2]):
      out[s, b]      = the two coded bits emitted from state s on
                       input bit b (register convention: state = last
                       K-1 input bits, newest in the LSB).
      pred[s2, h]    = the two predecessor states of s2 (h = the bit
                       shifted out, i.e. the predecessor's MSB).
      pred_out[s2,h] = the coded bits emitted on the transition
                       pred[s2, h] -> s2.
    """
    out = np.zeros((N_STATES, 2, 2), np.int8)
    nxt = np.zeros((N_STATES, 2), np.int32)
    for s in range(N_STATES):
        for b in (0, 1):
            reg = (s << 1) | b          # K bits: state + new input
            out[s, b, 0] = _parity(reg & G0)
            out[s, b, 1] = _parity(reg & G1)
            nxt[s, b] = reg & (N_STATES - 1)
    pred = np.zeros((N_STATES, 2), np.int32)
    pred_out = np.zeros((N_STATES, 2, 2), np.int8)
    for s2 in range(N_STATES):
        b = s2 & 1                      # input bit is the new LSB
        for h in (0, 1):
            s = (s2 >> 1) | (h << (K - 2))
            assert nxt[s, b] == s2
            pred[s2, h] = s
            pred_out[s2, h] = out[s, b]
    return out, pred, pred_out


def conv_encode_bits(bits: np.ndarray) -> np.ndarray:
    """Encode a 1-D bit array (0/1) -> coded bits [2 * (n + K - 1)].

    K-1 zero flush bits are appended so the trellis terminates in
    state 0 (the memo's trellis-termination requirement)."""
    out_tab, _, _ = _tables()
    bits = np.asarray(bits, np.int64).ravel()
    padded = np.concatenate([bits, np.zeros(K - 1, np.int64)])
    coded = np.empty(2 * len(padded), np.uint8)
    s = 0
    for i, b in enumerate(padded):
        coded[2 * i] = out_tab[s, b, 0]
        coded[2 * i + 1] = out_tab[s, b, 1]
        s = ((s << 1) | int(b)) & (N_STATES - 1)
    return coded


def conv_encode_bits_batch(bits: np.ndarray) -> np.ndarray:
    """Encode a batch of equal-length bit rows [B, n] -> coded bits
    [B, 2 * (n + K - 1)], identical per row to ``conv_encode_bits``.

    The encoder is feed-forward, so coded bit pairs are parities of a
    K-wide sliding window against the generator taps — one windowed
    matmul mod 2 instead of a per-bit Python FSM (which cost O(B x n)
    interpreter steps at farm batch)."""
    bits = np.asarray(bits, np.uint8)
    if bits.ndim != 2:
        raise ValueError("conv_encode_bits_batch expects [B, n] bits")
    B, n = bits.shape
    # reg at input index i = bits[i-K+1 .. i], newest in the LSB (the
    # scalar loop's register convention); parity = XOR over the tapped
    # window columns, computed as <= K shifted-column XORs of the
    # padded plane — the earlier [B, n+K-1, K] gather + integer matmul
    # form cost ~30x this (numpy int matmul is not BLAS, and the
    # window fancy-index materialized K copies of the stream)
    padded = np.concatenate(
        [np.zeros((B, K - 1), np.uint8), bits,
         np.zeros((B, K - 1), np.uint8)], axis=1)
    coded = np.empty((B, 2 * (n + K - 1)), np.uint8)
    for out, g in ((coded[:, 0::2], G0), (coded[:, 1::2], G1)):
        acc = np.zeros((B, n + K - 1), np.uint8)
        # G bit (K-1-j) taps window column j (oldest bit at the MSB)
        for j in range(K):
            if (g >> (K - 1 - j)) & 1:
                acc ^= padded[:, j:j + n + K - 1]
        out[:] = acc
    return coded


@functools.partial(jax.jit, static_argnums=(1, 2))
def _viterbi_core(soft, n_bits: int, per_step_norm: bool = False):
    """soft: [..., n_bits + K - 1, 2] correlations (+1 ~ coded bit 1,
    -1 ~ coded bit 0; magnitude = confidence).  Returns decoded bits
    [..., n_bits] (the flush bits are consumed, not returned).

    ``per_step_norm=True`` selects the original normalize-every-step
    schedule (one un-unrolled scan).  The default groups 16 ACS steps
    per normalization: subtracting a shared constant preserves every
    path-metric comparison in real arithmetic, but borderline f32
    comparisons can flip — the differential test
    (tests/transports/test_fec.py::TestViterbiNormSchedule) pins the
    two forms to byte-level agreement at the CRC-gate level, which is
    the contract every caller in this repo relies on (CLAUDE.md:
    decoded-byte equality, not raw-bit identity)."""
    batch_shape = soft.shape[:-2]
    T = soft.shape[-2]

    _, pred_np, pred_out_np = _tables()
    sgn = jnp.asarray(2.0 * pred_out_np - 1.0,
                      jnp.float32)                     # [64, 2, 2] ±1

    # pred[s2, h] = (s2 >> 1) | (h << (K-2)) — a radix-2 butterfly —
    # so gathering pm over pred is exactly "repeat each element of the
    # h-half twice": pure reshape/broadcast, NO per-lane gather.
    half = N_STATES // 2
    assert (pred_np[:, 0] == np.arange(N_STATES) // 2).all()
    assert (pred_np[:, 1] == np.arange(N_STATES) // 2 + half).all()

    def _rep2(v):                                      # [..., 32] -> [..., 64]
        return jnp.broadcast_to(
            v[..., None], v.shape + (2,)).reshape(v.shape[:-1] + (N_STATES,))

    neg = jnp.float32(-1e9)
    pm0 = jnp.full(batch_shape + (N_STATES,), neg, jnp.float32)
    pm0 = pm0.at[..., 0].set(0.0)                      # start in state 0

    # lean branch metrics: bm[s2, h] = x0*sgn0 + x1*sgn1 with sgn in
    # {±1} is always ±(x0+x1) or ±(x0-x1), so precompute the two sums
    # per lane and combine with CONSTANT {-1, 0, +1} masks — exactly
    # one of (A, D) is nonzero per (s2, h), and multiplying by ±1 /
    # reassociating identical-rounding adds keeps every path metric
    # BIT-IDENTICAL to the former x0*sgn0 + x1*sgn1 form, at ~half the
    # vector work per step (no [..., 64, 2] bm intermediate).
    same = (sgn[..., 0] == sgn[..., 1])                # [64, 2]
    A = jnp.where(same, sgn[..., 0], 0.0)              # weight of x0+x1
    D = jnp.where(same, 0.0, sgn[..., 0])              # weight of x0-x1
    A0, A1, D0, D1 = A[:, 0], A[:, 1], D[:, 0], D[:, 1]

    # normalization keeps metrics bounded over arbitrarily long
    # streams, but per-step it is two extra passes (a lane-axis max
    # reduce + subtract) on a 38-step header decode whose metrics
    # cannot leave f32's exact-comparison range — once per 16 steps is
    # enough (subtracting a shared constant preserves every comparison
    # in real arithmetic; the CRC gates any borderline f32 flip, and
    # the farm batch/single-frame paths share this one implementation)
    def step_of(norm):
        def step(pm, x_t):
            a = (x_t[..., 0] + x_t[..., 1])[..., None]  # [..., 1]
            d = (x_t[..., 0] - x_t[..., 1])[..., None]
            cand0 = _rep2(pm[..., :half]) + (a * A0 + d * D0)
            cand1 = _rep2(pm[..., half:]) + (a * A1 + d * D1)
            dec = cand1 > cand0                        # winner h per s2
            pm_new = jnp.where(dec, cand1, cand0)
            if norm:
                pm_new = pm_new - jnp.max(pm_new, axis=-1, keepdims=True)
            return pm_new, dec
        return step

    # scan over time (time axis moved to the front), unrolled in
    # groups of 16 with one normalization per group — the While-loop
    # per-iteration overhead dominates a body this small (the same
    # effect as fsk_demod._UNROLL)
    x = jnp.moveaxis(soft, -2, 0)                      # [T, ..., 2]
    if per_step_norm:                                  # original form
        pm, decs = jax.lax.scan(step_of(True), pm0, x)
    else:
        # ONE outer scan over [T//G] groups (the earlier Python loop
        # emitted T/16 separate scan ops + a T-length concat, so HLO
        # size grew linearly with payload length — a compile-time tax
        # on the compile-fragile CPU suite); per-group math is the
        # identical inner scan + one normalization, so decoded bits
        # are unchanged
        G = 16
        n_g, rem = divmod(T, G)

        def group_step(pm, xg):                        # xg [G, ..., 2]
            pm, decs_g = jax.lax.scan(step_of(False), pm, xg, unroll=4)
            pm = pm - jnp.max(pm, axis=-1, keepdims=True)
            return pm, decs_g

        pm = pm0
        dec_groups = []
        if n_g:
            xg = x[:n_g * G].reshape((n_g, G) + x.shape[1:])
            pm, decs_g = jax.lax.scan(group_step, pm, xg)
            dec_groups.append(
                decs_g.reshape((n_g * G,) + decs_g.shape[2:]))
        if rem:
            pm, decs_g = jax.lax.scan(step_of(False), pm, x[n_g * G:],
                                      unroll=min(rem, 4))
            dec_groups.append(decs_g)
        decs = dec_groups[0] if len(dec_groups) == 1 else \
            jnp.concatenate(dec_groups, 0)             # [T, ..., 64]

    # traceback from state 0 (trellis is flushed); the survivor-bit
    # read is a one-hot reduction, not take_along_axis — same
    # no-scalar-gather rule as the forward pass
    state0 = jnp.zeros(batch_shape, jnp.int32)
    iota = jnp.arange(N_STATES, dtype=jnp.int32)

    def back(state, dec_t):
        oh = iota == state[..., None]                  # [..., 64] one-hot
        h = jnp.any(oh & dec_t, axis=-1).astype(jnp.int32)
        bit = state & 1                                # input bit = LSB
        prev = (state >> 1) | (h << (K - 2))
        return prev, bit

    _, bits_rev = jax.lax.scan(back, state0, decs, reverse=True,
                               unroll=min(T, 4))
    bits = jnp.moveaxis(bits_rev, 0, -1)               # [..., T]
    return bits[..., :n_bits]


def viterbi_decode_soft(soft, n_bits: int,
                        per_step_norm: bool = False) -> np.ndarray:
    """Soft-decision Viterbi decode.

    soft: [..., 2*(n_bits+K-1)] interleaved coded-bit correlations
    (positive ~ 1, negative ~ 0) or already-paired [..., n+K-1, 2].
    Returns hard decoded bits [..., n_bits] (uint8).
    ``per_step_norm`` selects the original normalize-every-step
    schedule (see ``_viterbi_core``); outputs agree at the decoded-
    byte / CRC-gate level, not necessarily bit-for-bit on pathological
    noise.
    """
    soft = jnp.asarray(soft, jnp.float32)
    if soft.shape[-1] != 2:
        soft = soft.reshape(soft.shape[:-1] + (-1, 2))
    expect = n_bits + K - 1
    if soft.shape[-2] != expect:
        raise ValueError(
            f"need {expect} coded pairs for {n_bits} bits, got "
            f"{soft.shape[-2]}")
    return np.asarray(_viterbi_core(soft, n_bits, per_step_norm),
                      np.uint8)


def viterbi_decode_bits(coded_bits, n_bits: int) -> np.ndarray:
    """Hard-decision decode: coded bits (0/1) -> decoded bits."""
    hard = np.asarray(coded_bits, np.float32) * 2.0 - 1.0
    return viterbi_decode_soft(hard, n_bits)


# -- shared frame format (used by transports/fec_frame AND ops/soft_fsk) -----

FRAME_HEADER_PLAIN = 4                 # LEN(2, big-endian) + CRC16(LEN)


def build_frame_header(payload_len: int) -> bytes:
    from webaudio_modem.utils.crc16 import CRC16

    header = bytes([payload_len >> 8, payload_len & 0xFF])
    return header + CRC16.calculate(header).to_bytes(2, "big")


def build_frame_body(payload: bytes) -> bytes:
    from webaudio_modem.utils.crc16 import CRC16

    payload = bytes(payload)
    return payload + CRC16.calculate(payload).to_bytes(2, "big")


# -- byte-level helpers (the framing layer works in bytes) -------------------

def bits_to_bytes(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits, np.uint8).ravel()
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits).tobytes()


def bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes(data), np.uint8))


def encode_bytes(data: bytes) -> bytes:
    """Convolutionally encode a byte string (MSB-first bit order)."""
    return bits_to_bytes(conv_encode_bits(bytes_to_bits(data)))


def coded_length(n_data_bytes: int) -> int:
    """Coded byte length for ``n_data_bytes`` input bytes."""
    coded_bits = 2 * (8 * n_data_bytes + K - 1)
    return (coded_bits + 7) // 8


def decode_bytes(coded: bytes, n_data_bytes: int) -> bytes:
    """Hard-decision decode ``coded`` back to ``n_data_bytes`` bytes."""
    n_bits = 8 * n_data_bytes
    need = 2 * (n_bits + K - 1)
    bits = bytes_to_bits(coded)[:need]
    return bits_to_bytes(viterbi_decode_bits(bits, n_bits))[
        :n_data_bytes]
