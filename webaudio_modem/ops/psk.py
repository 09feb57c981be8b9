"""DBPSK modem ops — a second model family on the shared pipeline.

The reference declares PSK in its modulation-type union
(src/core.ts:8 — 'FSK' | 'PSK' | 'QAM' | 'WebAudio') but implements
only FSK.  This module provides a working differential-BPSK modem and,
in doing so, demonstrates that the framework's stages are
modulation-agnostic: the fused full-rate front end
(ops/fsk_demod._full_rate_step — AGC, band-pass, NCO mix, I/Q LPF),
the block-sum frame-sync correlator, the framing/UART state machine
(_fd._stage_d) and the whole runtime/transport stack are reused unchanged;
only the per-group DECISION differs.

DBPSK scheme:
  TX  framed bits (same UART framing + preamble/SFD as FSK) are
      differentially encoded — bit 1 keeps the carrier phase, bit 0
      flips it by pi — on a single carrier.
  RX  after I/Q down-conversion and 2x averaging, the decision for a
      downsampled sample z_k is  sign(Re(z_k * conj(z_{k-D}))) with
      D = ds_samples_per_bit: +1 (same phase as one bit ago) -> bit 1,
      -1 (flipped) -> bit 0.  Every ds-sample inside a bit compares
      against the same offset in the previous bit, so the sliced bit
      stream has the same per-bit-block structure the FSK sync
      correlator expects.  No carrier recovery is needed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from webaudio_modem.models.config import FSKConfig, FSKParams
from webaudio_modem.ops import fsk_mod
# module-object import: ops.psk participates in an import cycle
# (models/__init__ -> models.psk -> ops.psk -> ops.fsk_demod -> models
# .config), so names are resolved at call time, not import time.
from webaudio_modem.ops import fsk_demod as _fd

_TWO_PI = 2.0 * np.pi


def psk_params(carrier_frequency: float = 1800.0, baud_rate: int = 1200,
               sample_rate: int = 48000, **overrides) -> FSKParams:
    """Derive shared pipeline parameters for a PSK carrier.

    Reuses FSKParams with mark == space == carrier: center_freq is the
    carrier, the pre-filter is a band-pass around it (Carson bandwidth
    with zero deviation = 2*baud), and the I/Q low-passes cut at the
    baud rate — exactly the front end DBPSK needs.
    """
    config = FSKConfig(sample_rate=sample_rate, baud_rate=baud_rate,
                       mark_frequency=carrier_frequency,
                       space_frequency=carrier_frequency, **overrides)
    return FSKParams.from_config(config)


# ---------------------------------------------------------------------------
# Modulation
# ---------------------------------------------------------------------------

def modulate(params: FSKParams, data: bytes) -> np.ndarray:
    return np.asarray(modulate_batch(params, [data])[0])


def modulate_batch(params: FSKParams, messages):
    """Differentially-encoded BPSK on the carrier, same signal layout as
    FSK (2 bit-times lead padding, one byte-time trailing silence)."""
    lengths = {len(m) for m in messages}
    if len(lengths) != 1:
        raise ValueError("modulate_batch requires equal-length messages")
    bits = fsk_mod.frame_bits_batch(params, [bytes(m) for m in messages])
    # differential encoding: bit 1 -> keep phase, bit 0 -> flip
    flips = (bits == 0).astype(np.int64)
    enc = np.cumsum(flips, axis=-1) % 2          # 0: phase 0, 1: phase pi
    omega = _TWO_PI * params.center_freq / params.sample_rate
    n_bits = bits.shape[-1]
    carrier_off = (np.arange(n_bits, dtype=np.float64)
                   * omega * params.samples_per_bit)
    offsets = np.mod(carrier_off[None, :] + np.pi * enc, _TWO_PI)
    omegas = np.full(bits.shape, omega)
    lead = params.samples_per_bit * 2
    trail = params.bits_per_byte * params.samples_per_bit
    return fsk_mod._synth(offsets, omegas, params.samples_per_bit,
                          (lead, trail))


# ---------------------------------------------------------------------------
# Demodulation
# ---------------------------------------------------------------------------

class PSKDemodState(NamedTuple):
    """Carried state: shared front-end + framing fields, with the FSK
    phase-discriminator fields replaced by a one-bit-period delay line
    of downsampled I/Q samples (time-major [D, B])."""

    agc_gain: jax.Array
    pre: Tuple[jax.Array, ...]
    phi: Tuple[jax.Array, ...]      # NCO phasor (cos, sin)
    iq_i: Tuple[jax.Array, ...]
    iq_q: Tuple[jax.Array, ...]
    ds_iacc: jax.Array
    ds_qacc: jax.Array
    zbuf_i: jax.Array               # f32 [D, B] delayed I
    zbuf_q: jax.Array               # f32 [D, B] delayed Q
    zidx: jax.Array                 # i32 [] circular index
    bit_tail: jax.Array
    # carried sliding ds-wide bit sums for the W-ds ext positions
    # preceding the next chunk (same fused-sync plane as
    # fsk_demod.DemodState.r_tail; derivable from bit_tail)
    r_tail: jax.Array               # bf16 [W - ds, B]
    amp_tail: jax.Array
    bit_fill: jax.Array
    amp_fill: jax.Array
    started: jax.Array
    counter: jax.Array
    sil: jax.Array
    threshold: jax.Array
    accum: jax.Array
    count: jax.Array
    bsc: jax.Array
    next_idx: jax.Array
    byte_cur: jax.Array
    pos: jax.Array
    sync_count: jax.Array
    eod_count: jax.Array
    # SignalQuality accumulators (shared scheme with DemodState; the
    # soft value is the differential-phase deviation, see _psk_decision)
    last_sync_ratio: jax.Array
    q_win_sum: jax.Array
    q_win_sumsq: jax.Array
    q_win_cnt: jax.Array


def init_state(params: FSKParams, batch: int = 1) -> PSKDemodState:
    z = lambda: jnp.zeros((batch,), jnp.float32)  # noqa: E731
    zi = lambda: jnp.zeros((batch,), jnp.int32)  # noqa: E731
    biq = lambda: (z(), z(), z(), z())  # noqa: E731
    D = params.ds_samples_per_bit
    return PSKDemodState(
        agc_gain=jnp.ones((batch,), jnp.float32),
        pre=biq(), phi=(jnp.ones((batch,), jnp.float32), z()),
        iq_i=biq(), iq_q=biq(), ds_iacc=z(), ds_qacc=z(),
        zbuf_i=jnp.zeros((D, batch), jnp.float32),
        zbuf_q=jnp.zeros((D, batch), jnp.float32),
        zidx=jnp.zeros((), jnp.int32),
        bit_tail=jnp.zeros((params.sync_window, batch), jnp.bfloat16),
        r_tail=jnp.zeros(
            (params.sync_window - params.ds_samples_per_bit, batch),
            jnp.bfloat16),
        amp_tail=jnp.zeros((params.amp_window, batch), jnp.float32),
        bit_fill=zi(), amp_fill=zi(),
        started=jnp.zeros((batch,), bool), counter=zi(), sil=zi(),
        threshold=jnp.full((batch,), 0.01, jnp.float32),
        accum=zi(), count=zi(), bsc=zi(), next_idx=zi(), byte_cur=zi(),
        pos=zi(), sync_count=zi(), eod_count=zi(),
        last_sync_ratio=z(),
        q_win_sum=z(), q_win_sumsq=z(), q_win_cnt=z(),
    )


def _psk_soft(params: FSKParams, avg_i, avg_q, di, dq):
    """Pure DBPSK decision math (no delay-line bookkeeping):
    sign(Re(z * conj(z_delayed_one_bit))) slicer + amplitude.

    Also emits a ``soft`` value for SignalQuality: the differential
    phase angle arg(z * conj(z_delay)) wrapped to its nearest
    constellation point (0 for bit 1, ±pi for bit 0), i.e. the angular
    deviation whose mean tracks carrier frequency offset (rotation per
    bit period) and whose spread is the phase jitter."""
    re = avg_i * di + avg_q * dq
    im = avg_q * di - avg_i * dq
    bit = (re > 0).astype(jnp.float32)
    amp = jnp.sqrt(avg_i * avg_i + avg_q * avg_q)
    ang = jnp.arctan2(im, re)
    pi = jnp.float32(np.pi)
    soft = jnp.where(re > 0, ang, ang - jnp.sign(ang) * pi)
    return bit, amp, soft


def _psk_decision(params: FSKParams, dsc, avg_i, avg_q):
    """_psk_soft + the one-bit-period delay ring bookkeeping."""
    zbi, zbq, idx = dsc
    di = zbi[idx]
    dq = zbq[idx]
    bit, amp, soft = _psk_soft(params, avg_i, avg_q, di, dq)
    zbi = jax.lax.dynamic_update_index_in_dim(zbi, avg_i, idx, 0)
    zbq = jax.lax.dynamic_update_index_in_dim(zbq, avg_q, idx, 0)
    idx = (idx + 1) % jnp.int32(params.ds_samples_per_bit)
    return (zbi, zbq, idx), bit, amp, soft


def _psk_group_step(params: FSKParams, carry, x_group):
    fr, dsc = carry
    acc_i = acc_q = None
    for x_t in x_group:
        fr, fi, fq = _fd._full_rate_step(params, fr, x_t)
        acc_i = fi if acc_i is None else acc_i + fi
        acc_q = fq if acc_q is None else acc_q + fq
    ratio = jnp.float32(params.downsample_ratio)
    dsc, bit, amp, soft = _psk_decision(params, dsc, acc_i / ratio,
                                        acc_q / ratio)
    return (fr, dsc), bit, amp, soft


def _sequential_stage(params: FSKParams, ds_phase: int,
                      state: PSKDemodState, x, unroll: int = 0,
                      with_rsum: bool = False):
    """Same scan structure as the FSK sequential stage, with the DBPSK
    decision; outputs time-major bits/amps [n_ds, B].  ``with_rsum``
    appends the sliding ds-wide bit sums (see fsk_demod) as an 8th
    output."""
    unroll = unroll or _fd._default_unroll()
    B, T = x.shape
    ratio = params.downsample_ratio
    xT = x.T
    fr = (state.agc_gain, state.pre, state.phi, state.iq_i, state.iq_q)
    dsc = (state.zbuf_i, state.zbuf_q, state.zidx)
    bits_parts, amps_parts, soft_parts = [], [], []
    pos = 0

    if ds_phase > 0:
        need = ratio - ds_phase
        acc_i, acc_q = state.ds_iacc, state.ds_qacc
        if T < need:
            for t in range(T):
                fr, fi, fq = _fd._full_rate_step(params, fr, xT[t])
                acc_i = acc_i + fi
                acc_q = acc_q + fq
            empty = jnp.zeros((0, B), x.dtype)
            out = (fr, dsc, acc_i, acc_q,
                   jnp.zeros((0, B), jnp.bfloat16), empty, empty)
            if with_rsum:
                out = out + (jnp.zeros((0, B), jnp.bfloat16),)
            return out
        for t in range(need):
            fr, fi, fq = _fd._full_rate_step(params, fr, xT[t])
            acc_i = acc_i + fi
            acc_q = acc_q + fq
        dsc, bit, amp, soft = _psk_decision(params, dsc, acc_i / ratio,
                                            acc_q / ratio)
        bits_parts.append(bit.astype(jnp.bfloat16)[None, :])
        amps_parts.append(amp[None, :])
        soft_parts.append(soft[None, :])
        pos = need

    n_groups = (T - pos) // ratio
    main = (n_groups // unroll) * unroll
    if main:
        xs = xT[pos:pos + main * ratio].reshape(
            main // unroll, unroll * ratio, B)

        def body(carry, block):
            bs, as_, ss = [], [], []
            for u in range(unroll):
                group = tuple(block[u * ratio + r] for r in range(ratio))
                carry, bit, amp, soft = _psk_group_step(params, carry,
                                                        group)
                bs.append(bit)
                as_.append(amp)
                ss.append(soft)
            return carry, (jnp.stack(bs), jnp.stack(as_), jnp.stack(ss))

        (fr, dsc), (bm, am, sm) = jax.lax.scan(body, (fr, dsc), xs)
        bits_parts.append(bm.reshape(main, B).astype(jnp.bfloat16))
        amps_parts.append(am.reshape(main, B))
        soft_parts.append(sm.reshape(main, B))
        pos += main * ratio

    for _ in range(n_groups - main):
        group = tuple(xT[pos + r] for r in range(ratio))
        (fr, dsc), bit, amp, soft = _psk_group_step(params, (fr, dsc),
                                                    group)
        bits_parts.append(bit.astype(jnp.bfloat16)[None, :])
        amps_parts.append(amp[None, :])
        soft_parts.append(soft[None, :])
        pos += ratio

    leftover = T - pos
    acc_i = jnp.zeros_like(state.ds_iacc)
    acc_q = jnp.zeros_like(state.ds_qacc)
    for t in range(leftover):
        fr, fi, fq = _fd._full_rate_step(params, fr, xT[pos + t])
        acc_i = acc_i + fi
        acc_q = acc_q + fq

    if bits_parts:
        bits = jnp.concatenate(bits_parts, 0)
        amps = jnp.concatenate(amps_parts, 0)
        softs = jnp.concatenate(soft_parts, 0)
    else:
        bits = jnp.zeros((0, B), jnp.bfloat16)
        amps = softs = jnp.zeros((0, B), x.dtype)
    out = (fr, dsc, acc_i, acc_q, bits, amps, softs)
    if with_rsum:
        out = out + (_fd.sliding_bit_sums(params, state.bit_tail, bits),)
    return out


def demod_chunk(params: FSKParams, ds_phase: int, state: PSKDemodState,
                samples) -> Tuple[PSKDemodState, _fd.DemodOut]:
    """One [B, T] frame through the DBPSK pipeline; stages C/D are the
    shared FSK implementations."""
    B, T = samples.shape
    # R-fused sync path needs R exact in bf16 (R <= ds <= 256)
    use_r = params.ds_samples_per_bit <= 256
    seq = _sequential_stage(params, ds_phase, state, samples,
                            with_rsum=use_r)
    if use_r:
        fr, dsc, ds_iacc, ds_qacc, bits, amps, softs, rsum = seq
    else:
        fr, dsc, ds_iacc, ds_qacc, bits, amps, softs = seq
    agc_gain, pre, phi, iq_i, iq_q = fr
    zbi, zbq, zidx = dsc
    n_ds = bits.shape[0]
    maxb = _fd.max_bytes(params, n_ds)

    if n_ds == 0:
        new_state = state._replace(
            agc_gain=agc_gain, pre=pre, phi=phi, iq_i=iq_i, iq_q=iq_q,
            ds_iacc=ds_iacc, ds_qacc=ds_qacc)
        zi = jnp.zeros((B,), jnp.int32)
        return new_state, _fd.DemodOut(
            bytes_out=jnp.zeros((B, maxb), jnp.uint8),
            byte_count=zi, sync_fired=zi, eod_fired=zi,
            mean_amplitude=jnp.zeros((B,), jnp.float32))

    W = params.sync_window
    ds = params.ds_samples_per_bit
    ext_amps = jnp.concatenate([state.amp_tail, amps], 0)
    if use_r:
        # stage C from the carried/fused sliding block sums (see
        # fsk_demod.demod_chunk — shared _sync_ratios_from_r)
        ratios = _fd._sync_ratios_from_r(params, state.r_tail, rsum)
        r_tail_new = (rsum[-(W - ds):] if n_ds >= W - ds else
                      jnp.concatenate([state.r_tail, rsum],
                                      0)[-(W - ds):])
        bit_tail_new = (bits[-W:] if n_ds >= W else
                        jnp.concatenate([state.bit_tail, bits],
                                        0)[-W:])
    else:
        ext_bits = jnp.concatenate([state.bit_tail, bits], 0)
        ratios = _fd._sync_ratios(params, ext_bits)
        r_tail_new = state.r_tail
        bit_tail_new = ext_bits[-W:]

    d_carry, bytes_out, byte_count, eod_fired, sync_fired, fire_t = \
        _fd.framing_stage(params, state, bits, amps, ratios, ext_amps,
                          maxb)
    (started_i, counter, sil, threshold, accum, count, bsc, next_idx,
     byte_cur, pos) = d_carry[:10]

    # SignalQuality accumulators — shared helper with the FSK family
    (last_sync_ratio, q_win_sum, q_win_sumsq,
     q_win_cnt) = _fd.quality_window_update(params, state, ratios,
                                            softs, fire_t)

    new_state = PSKDemodState(
        agc_gain=agc_gain, pre=pre, phi=phi, iq_i=iq_i, iq_q=iq_q,
        ds_iacc=ds_iacc, ds_qacc=ds_qacc,
        zbuf_i=zbi, zbuf_q=zbq, zidx=zidx,
        bit_tail=bit_tail_new, r_tail=r_tail_new,
        amp_tail=ext_amps[-params.amp_window:],
        bit_fill=jnp.minimum(state.bit_fill + n_ds, jnp.int32(2 ** 30)),
        amp_fill=jnp.minimum(state.amp_fill + n_ds, jnp.int32(2 ** 30)),
        started=started_i > 0, counter=counter, sil=sil,
        threshold=threshold, accum=accum, count=count, bsc=bsc,
        next_idx=next_idx, byte_cur=byte_cur, pos=pos,
        sync_count=state.sync_count + sync_fired,
        eod_count=state.eod_count + eod_fired,
        last_sync_ratio=last_sync_ratio,
        q_win_sum=q_win_sum, q_win_sumsq=q_win_sumsq, q_win_cnt=q_win_cnt,
    )
    return new_state, _fd.DemodOut(
        bytes_out=bytes_out, byte_count=byte_count,
        sync_fired=sync_fired, eod_fired=eod_fired,
        mean_amplitude=amps.mean(0))


@functools.lru_cache(maxsize=None)
def make_demod_chunk(params: FSKParams, ds_phase: int,
                     donate: bool = True, mesh=None):
    fn = functools.partial(demod_chunk, params, ds_phase)
    if mesh is not None:
        fn = _fd.per_shard_demod(fn, mesh)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())
