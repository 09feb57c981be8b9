"""Triton kernel for the demodulator's sequential stage (stage A).

Replaces the ``lax.scan`` in ops/fsk_demod._sequential_stage for the
aligned main body: AGC -> pre-filter -> NCO mix -> I/Q LPF -> average
-> atan2 -> phase diff -> post-LPF -> slicer, one downsample group per
step, carried per channel.

One thread per channel: the grid runs over blocks of ``block``
channels and each program walks the whole chunk in a ``fori_loop``,
with the N_STATE carried values in registers.  Rows of the time-major
[T, B] input are loaded ``ahead`` groups before the step that uses
them, so the load latency hides behind the arithmetic; every load and
store is one coalesced row of the block.

The arithmetic is ops/fsk_demod._group_step itself, so the kernel and
the lax path cannot drift; tests run the kernel in the Pallas
interpreter against the scan.
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

N_STATE = 20                     # carried state variables
BLOCK = 32                       # channels per program (one warp)
AHEAD = 4                        # groups of input in flight (PERF.md sweep)


def _state_rows(fr, dsc):
    """fr/dsc pytrees of [B] -> N_STATE rows (order = unpack order)."""
    g, pre, (nco_c, nco_s), iq_i, iq_q = fr
    last_phase, post = dsc
    rows = [g, *pre, nco_c, nco_s, *iq_i, *iq_q, last_phase, *post]
    assert len(rows) == N_STATE
    return rows


def _unpack_state(rows):
    g = rows[0]
    pre = tuple(rows[1:5])
    nco = (rows[5], rows[6])
    iq_i = tuple(rows[7:11])
    iq_q = tuple(rows[11:15])
    last_phase = rows[15]
    post = tuple(rows[16:20])
    return (g, pre, nco, iq_i, iq_q), (last_phase, post)


def _kernel(params: FSKParams, n_groups: int, ahead: int,
            x_ref, st_ref, bits_ref, amps_ref, softs_ref, st_out_ref):
    from webaudio_modem.ops.fsk_demod import _group_step

    ratio = params.downsample_ratio

    def load(g):
        return tuple(x_ref[g * ratio + r, :] for r in range(ratio))

    def step(g, carry, group):
        carry, bit, amp, soft = _group_step(params, carry, group)
        # bits are 0/1: exact in bf16, the dtype every consumer reads
        bits_ref[g, :] = bit.astype(jnp.bfloat16)
        amps_ref[g, :] = amp
        softs_ref[g, :] = soft
        return carry

    carry = prefetch_loop(
        n_groups, load, step,
        _unpack_state([st_ref[i, :] for i in range(N_STATE)]), ahead)
    for i, row in enumerate(_state_rows(*carry)):
        st_out_ref[i, :] = row


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _seq_call(params: FSKParams, block: int, ahead: int, interpret: bool,
              packed_state, xT):
    T_m, B = xT.shape
    n_groups = T_m // params.downsample_ratio
    xT = pad_channels(xT, block)
    packed_state = pad_channels(packed_state, block)
    Bp = xT.shape[1]
    col = lambda rows: pl.BlockSpec((rows, block),  # noqa: E731
                                    lambda i: (0, i))
    stream = lambda dt: jax.ShapeDtypeStruct((n_groups, Bp), dt)  # noqa
    bits, amps, softs, st = pl.pallas_call(
        functools.partial(_kernel, params, n_groups, ahead),
        grid=(Bp // block,),
        in_specs=[col(T_m), col(N_STATE)],
        out_specs=[col(n_groups)] * 3 + [col(N_STATE)],
        out_shape=[stream(jnp.bfloat16), stream(jnp.float32),
                   stream(jnp.float32),
                   jax.ShapeDtypeStruct((N_STATE, Bp), jnp.float32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name="fsk_seq",
    )(xT, packed_state)
    return st[:, :B], bits[:, :B], amps[:, :B], softs[:, :B]


def seq_main(params: FSKParams, fr, dsc, xT_main, block: int = BLOCK,
             ahead: int = AHEAD, interpret: bool = False):
    """Kernel path for the aligned main body of the sequential stage.

    xT_main: time-major [n_groups * ratio, B], any B (padded to a
    multiple of ``block`` inside).  Returns (fr', dsc', bits [n_groups,
    B] bf16, amps [n_groups, B], softs [n_groups, B]) — the contract of
    the lax scan it replaces."""
    check_route(interpret)
    packed, bits, amps, softs = _seq_call(
        params, block, ahead, interpret, jnp.stack(_state_rows(fr, dsc)),
        xT_main)
    fr2, dsc2 = _unpack_state(list(packed))
    return fr2, dsc2, bits, amps, softs


def available() -> bool:
    """Whether the demodulator takes this kernel: only where the trace
    compiles for the GPU."""
    return on_gpu()
