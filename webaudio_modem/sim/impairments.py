"""Impairment sweeps — carrier frequency offset and sample-clock skew.

The reference DECLARES a quality surface with ``carrierOffset`` and
``timingJitter`` fields but never feeds it (SignalQuality,
/root/reference/src/core.ts:10-16; the getter stubs zeros,
src/modems/fsk.ts:471-479), and no reference test sweeps either
impairment.  This module characterizes the tolerance envelopes the
reference left unmeasured, for both physical layers:

  * **Carrier offset**: the transmitter's mark/space pair sits df Hz
    off nominal (both tones shifted together — an oscillator error,
    the dominant real-audio impairment for acoustic links).  The
    receiver demodulates with the NOMINAL config.
  * **Sample-clock skew**: the receiver's ADC clock runs (1 + eps)
    fast/slow; modeled by linear-interpolation resampling of the
    transmitted signal onto the skewed time grid.  Bit-period drift
    accumulates over the frame, so tolerance is frame-length-bound.

Decode verdicts are frame-exactness (the reference's own pass
criterion, tests/modems/fsk-demodulation.node.test.ts:81-106).  The
hard-path sweep can run the golden scalar comparator on the SAME
impaired signals, pinning that the batched device pipeline degrades
exactly like the reference algorithm rather than earlier.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from webaudio_modem.models.config import FSKConfig, FSKParams
from webaudio_modem.ops import fsk_mod
from webaudio_modem.sim.ber import bit_errors
from webaudio_modem.sim.channels import awgn_snr


def clock_skew(signal: np.ndarray, eps: float) -> np.ndarray:
    """Resample ``signal`` as heard by an ADC whose clock runs
    ``1 + eps`` times the transmitter's: output sample k is the input
    at time k * (1 + eps), linearly interpolated.  eps > 0 = receiver
    clock fast (signal appears stretched/slow)."""
    n_out = int(len(signal) / (1.0 + eps)) if eps > 0 else len(signal)
    t = np.arange(n_out, dtype=np.float64) * (1.0 + eps)
    return np.interp(t, np.arange(len(signal), dtype=np.float64),
                     signal).astype(np.float32)


@dataclasses.dataclass
class ImpairmentPoint:
    value: float                  # df (Hz) or eps (fraction)
    messages: int
    frame_errors: int
    bit_errs: int
    total_bits: int

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.messages, 1)

    @property
    def ber(self) -> float:
        return self.bit_errs / max(self.total_bits, 1)


def _sweep(clean_for: Callable[[float], np.ndarray],
           values: Sequence[float], message: bytes,
           messages_per_point: int, snr_db: Optional[float], seed: int,
           demodulate: Callable[[np.ndarray], List[bytes]]) \
        -> List[ImpairmentPoint]:
    out = []
    for v in values:
        clean = clean_for(v)
        rng = np.random.RandomState(seed + int(abs(v) * 1e6) % 99991)
        if snr_db is None:
            batch = np.stack([clean] * messages_per_point)
        else:
            batch = np.stack([awgn_snr(clean, snr_db, rng)
                              for _ in range(messages_per_point)])
        decoded = demodulate(batch)
        out.append(ImpairmentPoint(
            value=v, messages=messages_per_point,
            frame_errors=sum(1 for d in decoded if d != message),
            bit_errs=sum(bit_errors(message, d) for d in decoded),
            total_bits=8 * len(message) * messages_per_point))
    return out


def _device_demod(config: FSKConfig) -> Callable:
    from webaudio_modem.models.farm import ModemFarm

    def run(batch: np.ndarray) -> List[bytes]:
        farm = ModemFarm(config, batch.shape[0], donate=False)
        return farm.demodulate(batch)

    return run


def _soft_demod(config: FSKConfig) -> Callable:
    from webaudio_modem.models.soft_modem import SoftModemCore

    def run(batch: np.ndarray) -> List[bytes]:
        out = []
        for row in batch:
            core = SoftModemCore(config)
            out.append(core.demodulate_data(row))
        return out

    return run


def carrier_offset_sweep(config: FSKConfig,
                         offsets_hz: Sequence[float],
                         message: bytes = b"\x55\x0f\xa3\xc1",
                         messages_per_point: int = 16,
                         snr_db: Optional[float] = 30.0,
                         seed: int = 7, soft: bool = False,
                         demodulate: Optional[Callable] = None) \
        -> List[ImpairmentPoint]:
    """FER/BER vs carrier offset: TX tones at (mark+df, space+df),
    RX at nominal.  ``demodulate`` overrides the decoder (e.g.
    ``sim.ber.golden_demodulate(config)`` for the comparator curve)."""
    if demodulate is None:
        demodulate = (_soft_demod if soft else _device_demod)(config)

    def clean_for(df: float) -> np.ndarray:
        cfg_tx = dataclasses.replace(
            config, mark_frequency=config.mark_frequency + df,
            space_frequency=config.space_frequency + df)
        if soft:
            from webaudio_modem.models.soft_modem import SoftModemCore
            return np.asarray(SoftModemCore(cfg_tx).modulate_data(message))
        return np.asarray(fsk_mod.modulate(
            FSKParams.from_config(cfg_tx), message))

    return _sweep(clean_for, offsets_hz, message, messages_per_point,
                  snr_db, seed, demodulate)


def clock_skew_sweep(config: FSKConfig, skews: Sequence[float],
                     message: bytes = b"\x55\x0f\xa3\xc1",
                     messages_per_point: int = 16,
                     snr_db: Optional[float] = 30.0,
                     seed: int = 11, soft: bool = False,
                     demodulate: Optional[Callable] = None) \
        -> List[ImpairmentPoint]:
    """FER/BER vs receiver sample-clock skew ``eps`` (fractional;
    1e-4 = 100 ppm)."""
    if demodulate is None:
        demodulate = (_soft_demod if soft else _device_demod)(config)
    if soft:
        from webaudio_modem.models.soft_modem import SoftModemCore
        clean = np.asarray(SoftModemCore(config).modulate_data(message))
    else:
        clean = np.asarray(fsk_mod.modulate(
            FSKParams.from_config(config), message))

    return _sweep(lambda eps: clock_skew(clean, eps), skews, message,
                  messages_per_point, snr_db, seed, demodulate)
