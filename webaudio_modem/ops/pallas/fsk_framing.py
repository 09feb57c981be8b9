"""Triton kernel for the framing state machine and byte compaction
(stage D).

Same design as fsk_seq.py: one thread per channel, grid over channel
blocks, the time loop inside the kernel with the carried state in
registers and each step's input rows loaded ``ahead`` steps early.  The
per-step logic is the shared ops/fsk_demod._d_step (silence EOD, sync
firing, majority-vote bit decisions, UART assembly — fsk.ts:278-375),
so the lax and kernel paths cannot drift.

Compaction happens in the kernel too: every channel keeps ``maxb``
byte slots, an emit cursor, the EOD and sync counters and the last
fire position in registers, filled by masked selects (no scatter: each
program owns its channels' columns), and stores them once at the end.
The kernel emits only [maxb + 4, B] int32 instead of per-step planes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from webaudio_modem.models.config import FSKParams
from webaudio_modem.ops.pallas import (check_route, on_gpu, pad_channels,
                                       prefetch_loop)

# started, counter, sil, accum, count, bsc, nxt, byte_cur, pos, fill
N_I32 = 10
N_F32 = 2   # threshold, rolling amp-window sum (fused means carry)
BLOCK = 32  # channels per program (one warp)
AHEAD = 1   # steps of input in flight (the sweep in PERF.md)
MAX_SLOTS = 64  # byte-slot registers per channel


def carry_rows(carry):
    """_d_step's carry -> (N_I32 int rows, N_F32 float rows)."""
    (started, counter, sil, thr, accum, count, bsc, nxt,
     byte_cur, pos, run_sum, fillv) = carry
    return ([started.astype(jnp.int32), counter, sil, accum, count, bsc,
             nxt, byte_cur, pos, fillv], [thr, run_sum])


def unpack_carry(ints, flts):
    # started stays int32 — _d_step's carry convention
    return (ints[0], ints[1], ints[2], flts[0], ints[3], ints[4],
            ints[5], ints[6], ints[7], ints[8], flts[1], ints[9])


def _kernel(params: FSKParams, n_ds: int, maxb: int, ahead: int,
            bits_ref, amps_ref, ratios_ref, sub_ref, sti_ref, stf_ref,
            fill_ref, out_ref, sti_out, stf_out):
    from webaudio_modem.ops.fsk_demod import _d_step

    W = jnp.int32(params.sync_window)
    carry0 = unpack_carry([sti_ref[i, :] for i in range(N_I32)],
                          [stf_ref[i, :] for i in range(N_F32)])
    fill = fill_ref[0, :]
    zero = jnp.zeros_like(fill)
    # byte slots, then cursor, eods, fires, last fire position
    accs0 = (zero,) * (maxb + 3) + (zero - 1,)

    def load(t):
        return (bits_ref[t, :].astype(jnp.float32), amps_ref[t, :],
                ratios_ref[t, :], sub_ref[t, :])

    def step(t, state, rows):
        carry, accs = state
        bit, amp, ratio, sub = rows
        gate = (t + 1 + fill) >= W
        carry, (byte_i32, emit, eod, fire) = _d_step(
            params, carry, (bit, amp, ratio, sub, gate))
        cursor = accs[maxb]
        slots = tuple(
            jnp.where(emit & (cursor == j), byte_i32 & 0xFF, accs[j])
            for j in range(maxb))
        accs = (*slots,
                cursor + emit.astype(jnp.int32),
                accs[maxb + 1] + eod.astype(jnp.int32),
                accs[maxb + 2] + fire.astype(jnp.int32),
                jnp.where(fire, t, accs[maxb + 3]))
        return carry, accs

    carry, accs = prefetch_loop(n_ds, load, step, (carry0, accs0), ahead)
    ints, flts = carry_rows(carry)
    for i, row in enumerate(ints):
        sti_out[i, :] = row
    for i, row in enumerate(flts):
        stf_out[i, :] = row
    for j in range(maxb + 4):
        out_ref[j, :] = accs[j]


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _compact_call(params: FSKParams, maxb: int, block: int, ahead: int,
                  interpret: bool, ints, flts, bits, amps, ratios,
                  sub_amps, bit_fill):
    n_ds, B = bits.shape
    bits, amps, ratios, sub_amps, ints, flts, fill = (
        pad_channels(a, block) for a in (
            bits, amps, ratios, sub_amps, ints, flts, bit_fill[None]))
    Bp = bits.shape[1]
    col = lambda rows: pl.BlockSpec((rows, block),  # noqa: E731
                                    lambda i: (0, i))
    out, ints_out, flts_out = pl.pallas_call(
        functools.partial(_kernel, params, n_ds, maxb, ahead),
        grid=(Bp // block,),
        in_specs=[col(n_ds)] * 3 + [col(sub_amps.shape[0]), col(N_I32),
                                    col(N_F32), col(1)],
        out_specs=[col(maxb + 4), col(N_I32), col(N_F32)],
        out_shape=[jax.ShapeDtypeStruct((maxb + 4, Bp), jnp.int32),
                   jax.ShapeDtypeStruct((N_I32, Bp), jnp.int32),
                   jax.ShapeDtypeStruct((N_F32, Bp), jnp.float32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name="fsk_framing",
    )(bits, amps, ratios, sub_amps, ints, flts, fill)
    return out[:, :B], ints_out[:, :B], flts_out[:, :B]


def stage_d_compact(params: FSKParams, state, bits, amps, ratios,
                    sub_amps, maxb: int, block: int = BLOCK,
                    ahead: int = AHEAD, interpret: bool = False):
    """Stage D with in-kernel byte compaction.

    All streams time-major [n_ds, B]; ``sub_amps`` is the delayed
    amplitude stream for the fused rolling mean (ext_amps; may be
    longer than n_ds — only the first n_ds rows are read).  Returns
    (carry, (bytes_out [B, maxb] int32, byte_count [B], eod_fired [B],
    sync_fired [B], fire_t [B] — last fire position or -1)): the
    aggregates demod_chunk needs, with no [n_ds, B] output plane."""
    from webaudio_modem.ops.fsk_demod import _means_carry

    check_route(interpret)
    if maxb > MAX_SLOTS:
        raise ValueError(f"maxb={maxb} exceeds MAX_SLOTS={MAX_SLOTS}")
    run_sum0, fillv0 = _means_carry(params, state)
    ints, flts = carry_rows(
        (state.started, state.counter, state.sil, state.threshold,
         state.accum, state.count, state.bsc, state.next_idx,
         state.byte_cur, state.pos, run_sum0, fillv0))
    out, ints_out, flts_out = _compact_call(
        params, maxb, block, ahead, interpret, jnp.stack(ints),
        jnp.stack(flts),
        bits, amps, ratios, sub_amps, state.bit_fill)
    carry = unpack_carry(ints_out, flts_out)
    return carry, (out[:maxb].T, out[maxb], out[maxb + 1],
                   out[maxb + 2], out[maxb + 3])


_fallback_logged = set()


def available(maxb: int) -> bool:
    """Whether the demodulator takes this kernel: on the GPU, for
    chunks whose byte bound fits the slot registers.  A GPU chunk too
    long for them falls back to the lax scan; that is logged once per
    bound and counted, so the slower path shows without a profiler."""
    if not on_gpu():
        return False
    if maxb > MAX_SLOTS:
        if maxb not in _fallback_logged:
            _fallback_logged.add(maxb)
            from webaudio_modem.utils.trace import component_logger, metrics

            metrics.incr("pallas.compact_fallback")
            component_logger("fsk_framing").warning(
                "framing kernel unavailable for maxb=%d (> MAX_SLOTS=%d):"
                " falling back to the lax scan and masked-sum compaction"
                " — use shorter chunks to stay on the kernel", maxb,
                MAX_SLOTS)
        return False
    return True
