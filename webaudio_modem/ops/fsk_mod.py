"""Batched FSK modulator — phase-continuous DDS, array-first.

Re-architecture of the reference per-sample DDS loop
(generateFSKSignalInternal, src/modems/fsk.ts:389-424): instead of one
``sin`` per sample in a loop, the per-*bit* phase offsets are
prefix-summed (tiny, done in float64 on host for exactness), and the
device evaluates ``sin(phase_offset[bit] + k*omega[bit])`` for all
samples of all channels in parallel — a single fused elementwise
kernel on the VPU, batched [B, T].

Signal layout matches the reference exactly (fsk.ts:389-395):
2 bit-times of leading zero padding, preamble + SFD + data bytes
UART-framed (start bits, 8 data bits MSB-first, optional parity, stop
bits), one byte-time of trailing silence.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

import jax

from webaudio_modem.models.config import FSKParams, _framed_bits


@functools.lru_cache(maxsize=32)
def _framed_table(config) -> np.ndarray:
    """[256, bits_per_byte] int8 lookup of UART-framed bytes — lets the
    batch framing below be one fancy-index instead of a Python loop per
    (message, byte, bit).  Cached per config; treat as read-only."""
    table = np.asarray([_framed_bits(v, config) for v in range(256)],
                       dtype=np.int8)
    table.setflags(write=False)
    return table


def frame_bits(params: FSKParams, data: bytes) -> np.ndarray:
    """UART-frame preamble + SFD + data into a bit array (host, numpy)."""
    return frame_bits_batch(params, [bytes(data)])[0]


def frame_bits_batch(params: FSKParams,
                     messages: Sequence[bytes]) -> np.ndarray:
    """UART-frame a batch of equal-length messages -> [B, n_bits] int8.

    Vectorized: the per-byte framed-bit pattern is a 256-entry table
    lookup, so framing B=2048 channels costs two numpy ops instead of
    ~300k Python bit appends (which dominated farm-scale TX)."""
    if not messages:
        raise ValueError("frame_bits_batch requires at least one message")
    if len({len(m) for m in messages}) != 1:
        # unequal lengths whose total happens to divide by B would
        # otherwise silently reshape into wrongly framed bits
        raise ValueError(
            "frame_bits_batch requires equal-length messages; group by "
            "length (or pad at the transport layer) first")
    cfg = params.config
    table = _framed_table(cfg)
    pre = np.asarray([*cfg.preamble_pattern, *cfg.sfd_pattern], np.uint8)
    B = len(messages)
    data = np.frombuffer(b"".join(messages), np.uint8).reshape(B, -1) \
        if messages[0] else np.zeros((B, 0), np.uint8)
    all_bytes = np.concatenate(
        [np.tile(pre[None, :], (B, 1)), data], axis=1)
    return table[all_bytes].reshape(B, -1)


def signal_length(params: FSKParams, n_data_bytes: int) -> int:
    """Total sample count (reference fsk.ts:390-394)."""
    cfg = params.config
    total_bytes = (len(cfg.preamble_pattern) + len(cfg.sfd_pattern)
                   + n_data_bytes)
    padding = params.samples_per_bit * 2 if total_bytes > 0 else 0
    silence = params.bits_per_byte * params.samples_per_bit
    return (total_bytes * params.bits_per_byte * params.samples_per_bit
            + padding + silence)


def _phase_tables(params: FSKParams,
                  bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-bit (phase_offset mod 2pi, per-sample increment), float64 host.

    bits: [..., n_bits] int8.  Exclusive prefix sum of per-bit phase
    advances keeps on-device arguments small so float32 ``sin`` is
    accurate regardless of signal length.
    """
    two_pi = 2.0 * np.pi
    freq = np.where(bits == 1, params.mark_freq, params.space_freq)
    omega = two_pi * freq / params.sample_rate          # [..., n_bits]
    advance = omega * params.samples_per_bit
    offsets = np.cumsum(advance, axis=-1) - advance      # exclusive
    return np.mod(offsets, two_pi), omega


@functools.partial(jax.jit, static_argnums=(2, 3))
def _synth(offsets, omega, samples_per_bit: int, pad: Tuple[int, int]):
    """Device synthesis: [..., n_bits] phase tables -> [..., T] signal."""
    import jax.numpy as jnp

    k = jnp.arange(samples_per_bit, dtype=jnp.float32)
    phase = (offsets[..., None].astype(jnp.float32)
             + omega[..., None].astype(jnp.float32) * k)
    sig = jnp.sin(phase)
    sig = sig.reshape(*sig.shape[:-2], -1)
    lead, trail = pad
    pad_widths = [(0, 0)] * (sig.ndim - 1) + [(lead, trail)]
    return jnp.pad(sig, pad_widths)


def _phase_acc_int(params: FSKParams, bits: np.ndarray) -> np.ndarray:
    """Exact integer exclusive phase prefix (mod fs) for integer
    mark/space/sample-rate configs — the host half of the fast TX
    path (``_synth_int`` is the device half).

    The per-bit phase advance is 2*pi*(f*spb mod fs)/fs, so the
    exclusive prefix is EXACT integer arithmetic mod fs — the same
    values mod 2*pi as the float64 path.  int32 while the un-modded
    prefix provably fits (n_bits * max step < 2^31 — every practical
    frame), int64 beyond; exactness is unchanged either way.  Host
    work is ONLY this cumsum: the mod-fs scale to radians and the
    per-bit omega selection run on device (`_synth_int`), which
    matters because the farm host is a single contended core — the
    f64 scale over [B, n_bits] alone cost ~0.5-3 s per B=4096 write
    group.  (The CUMSUM itself stays host-side: a fully-on-device
    variant compiled pathologically slowly.)
    """
    spb = params.samples_per_bit
    fs = int(params.sample_rate)
    mark_step = int(params.mark_freq) * spb % fs
    space_step = int(params.space_freq) * spb % fs
    b = np.asarray(bits)
    n_bits = b.shape[-1]
    dt = (np.int32 if n_bits * max(mark_step, space_step, 1)
          < 2 ** 31 else np.int64)
    steps = space_step + b.astype(dt) * dt(mark_step - space_step)
    acc = np.cumsum(steps, axis=-1, dtype=dt) - steps
    return (acc % fs).astype(np.int32)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _synth_int(acc, bits, fs: int, mark_freq: float, space_freq: float,
               samples_per_bit: int, pad: Tuple[int, int]):
    """Device synthesis from the exact integer phase prefix: derive
    the radian offsets (acc < fs is exact in f32) and the per-bit
    omega on device, then the shared sin expansion.  Uploads int32
    prefix + int8 bits (5/8 the f32 tables' bytes) and moves the
    [B, n_bits] scale/select passes off the single-core host."""
    import jax.numpy as jnp

    two_pi = 2.0 * np.pi
    offsets = acc.astype(jnp.float32) * jnp.float32(two_pi / fs)
    omega = jnp.where(bits == 1,
                      jnp.float32(two_pi * mark_freq / fs),
                      jnp.float32(two_pi * space_freq / fs))
    k = jnp.arange(samples_per_bit, dtype=jnp.float32)
    phase = offsets[..., None] + omega[..., None] * k
    sig = jnp.sin(phase)
    sig = sig.reshape(*sig.shape[:-2], -1)
    lead, trail = pad
    pad_widths = [(0, 0)] * (sig.ndim - 1) + [(lead, trail)]
    return jnp.pad(sig, pad_widths)


def _phase_tables_int(params: FSKParams,
                      bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f32 host phase tables from the exact integer prefix (kept for
    differential tests; production batch TX feeds ``_phase_acc_int``
    straight to ``_synth_int``)."""
    two_pi = 2.0 * np.pi
    fs = int(params.sample_rate)
    acc = _phase_acc_int(params, bits)
    offsets = (acc * (two_pi / fs)).astype(np.float32)
    omega = np.where(np.asarray(bits) == 1,
                     np.float32(two_pi * int(params.mark_freq) / fs),
                     np.float32(two_pi * int(params.space_freq) / fs))
    return offsets, omega


def _int_config(params: FSKParams) -> bool:
    return (float(params.mark_freq).is_integer()
            and float(params.space_freq).is_integer()
            and float(params.sample_rate).is_integer())


def modulate(params: FSKParams, data: bytes) -> np.ndarray:
    """Modulate one message -> float32 [T] (host convenience API)."""
    return np.asarray(modulate_batch(params, [data])[0])


def modulate_bits(params: FSKParams, bits) -> np.ndarray:
    """Modulate a raw bit sequence (no UART framing) -> float32 [T].

    Same phase-continuous DDS and lead/trail layout as ``modulate``;
    used by the soft-decision FEC path (ops/soft_fsk.py) where the
    payload bits are convolutionally coded instead of UART-framed."""
    bits = np.asarray(bits, dtype=np.int8)[None]
    offsets, omega = _phase_tables(params, bits)
    lead = params.samples_per_bit * 2
    trail = params.bits_per_byte * params.samples_per_bit
    return np.asarray(_synth(offsets, omega, params.samples_per_bit,
                             (lead, trail))[0])


def modulate_batch(params: FSKParams, messages: Sequence[bytes]):
    """Modulate a batch of equal-length messages -> [B, T] jax array."""
    lengths = {len(m) for m in messages}
    if len(lengths) != 1:
        raise ValueError(
            "modulate_batch requires equal-length messages; pad at the "
            "transport layer or call per-message")
    bits = frame_bits_batch(params, [bytes(m) for m in messages])
    total_bytes = bits.shape[-1] // params.bits_per_byte
    lead = params.samples_per_bit * 2 if total_bytes > 0 else 0
    trail = params.bits_per_byte * params.samples_per_bit
    if _int_config(params):
        acc = _phase_acc_int(params, bits)               # exact int32
        return _synth_int(acc, bits, int(params.sample_rate),
                          float(params.mark_freq),
                          float(params.space_freq),
                          params.samples_per_bit, (lead, trail))
    offsets, omega = _phase_tables(params, bits)          # f64 fallback
    return _synth(offsets, omega, params.samples_per_bit, (lead, trail))
