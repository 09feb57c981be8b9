"""FSKCore — single-channel host facade over the batched device kernels.

The public surface mirrors the reference FSKCore
(src/modems/fsk.ts:82-494): ``configure`` / ``modulate_data`` /
``demodulate_data`` / ``reset`` / ``get_status`` / ``get_signal_quality``
with identical stream-chunking semantics.  Internally it is a B=1 view
of the same jitted kernels that power the 4096-channel ModemFarm —
there is exactly one compute path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from webaudio_modem.core import IModulator, SignalQuality
from webaudio_modem.models.config import FSKConfig, FSKParams
from webaudio_modem.ops import fsk_demod, fsk_mod


class FSKCore(IModulator):
    name = "FSK"
    type = "FSK"

    def __init__(self, config: Optional[FSKConfig] = None):
        super().__init__()
        self._config: Optional[FSKConfig] = None
        self.params: Optional[FSKParams] = None
        self._state = None
        self._ds_phase = 0
        self._threshold_carry = None  # persists across configure (fsk.ts:128)
        # debug counters (fsk.ts:127-131; zeroed by reset(), fsk.ts:468)
        self._demodulation_calls = 0
        self._total_samples = 0
        if config is not None:
            self.configure(config)

    # -- configuration (fsk.ts:133-157) -----------------------------------

    def configure(self, config: FSKConfig) -> None:
        if isinstance(config, dict):
            config = FSKConfig.from_dict(config)
        self._config = config
        self.params = FSKParams.from_config(config)
        self._init_state()
        self._ready = True
        if fsk_demod.AUTO_WARM_QUALITY:
            # build the quality calibration in the background so the
            # first get_signal_quality poll doesn't pay the lazy
            # CPU-pipeline hitch (fsk_demod._quality_calibration)
            fsk_demod.warm_quality_calibration(self.params)
        self.emit("configured")

    def _init_state(self) -> None:
        import jax.numpy as jnp

        self._state = fsk_demod.init_state(self.params, batch=1)
        if self._threshold_carry is not None:
            # reference quirk: silence.threshold is a constructor-time
            # field not reset by configure (fsk.ts:128)
            self._state = self._state._replace(
                threshold=jnp.full((1,), self._threshold_carry, jnp.float32))
        self._ds_phase = 0

    def get_config(self) -> FSKConfig:
        return self._config

    # -- modulation ---------------------------------------------------------

    def modulate_data(self, data) -> np.ndarray:
        if not self._ready:
            raise RuntimeError("FSK modulator not configured")
        return fsk_mod.modulate(self.params, bytes(data))

    # -- demodulation -------------------------------------------------------

    def demodulate_data(self, samples) -> bytes:
        if not self._ready:
            raise RuntimeError("FSK demodulator not configured")
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim != 1:
            raise ValueError("demodulate_data expects a 1-D sample array")
        if len(samples) == 0:
            return b""
        # Split arbitrary chunk lengths into power-of-two pieces so the
        # jit cache stays bounded (~2*log2(maxT) programs per config)
        # while state carry keeps results identical to a single call.
        from webaudio_modem.utils.trace import metrics

        self._demodulation_calls += 1
        self._total_samples += len(samples)
        result = bytearray()
        offset = 0
        n = len(samples)
        syncs = eods = 0
        while offset < n:
            remaining = n - offset
            piece = 1 << (remaining.bit_length() - 1)  # largest pow2 <= rem
            step = fsk_demod.make_demod_chunk(self.params, self._ds_phase)
            self._state, out = step(self._state,
                                    samples[None, offset:offset + piece])
            self._ds_phase = (self._ds_phase + piece) \
                % self.params.downsample_ratio
            count = int(out.byte_count[0])
            if count:
                result += bytes(np.asarray(out.bytes_out[0][:count]))
            syncs += int(out.sync_fired[0])
            for _ in range(int(out.eod_fired[0])):
                eods += 1
                self.emit("eod")
            offset += piece
        self._threshold_carry = float(self._state.threshold[0])
        metrics.incr("fsk.demodulate_calls")
        if result:
            metrics.incr("fsk.bytes_decoded", len(result))
        if syncs:
            metrics.incr("fsk.syncs", syncs)
        if eods:
            metrics.incr("fsk.eods", eods)
        return bytes(result)

    # -- state management (fsk.ts:464-469) ---------------------------------

    def reset(self) -> None:
        """Reference reset() semantics (fsk.ts:464-469 + resetState
        fsk.ts:175-188, encoded by golden.FSKGolden.reset): clears the
        sync *bit* buffer, byte/framing registers, NCO, I/Q + post
        filters, downsample accumulators and debug counters — but
        PRESERVES the AGC gain, the pre-filter state, the sync
        *amplitude* buffer and the adaptive silence threshold."""
        self._demodulation_calls = 0
        self._total_samples = 0
        if self.params is not None and self._state is not None:
            old = self._state
            self._init_state()  # carries threshold via _threshold_carry
            self._state = self._state._replace(
                agc_gain=old.agc_gain,          # this.agc untouched
                pre=old.pre,                    # preFilter not reset
                amp_tail=old.amp_tail,          # syncAmplitudeBuffer kept
                amp_fill=old.amp_fill,
                threshold=old.threshold,        # silence.threshold kept
            )
            self._threshold_carry = float(old.threshold[0])
        self.emit("reset")

    # -- observability ------------------------------------------------------

    def get_status(self) -> dict:
        # field parity with the reference getStatus (fsk.ts:481-493)
        s = self._state
        p = self.params
        return {
            "ready": self._ready,
            "frame_started": bool(s.started[0]) if s is not None else False,
            "global_sample_counter": int(s.counter[0]) if s is not None else 0,
            "sync_detections": int(s.sync_count[0]) if s is not None else 0,
            "eod_events": int(s.eod_count[0]) if s is not None else 0,
            "silence_threshold": float(s.threshold[0])
            if s is not None else 0.01,
            "demodulation_calls": self._demodulation_calls,
            "total_samples_processed": self._total_samples,
            # syncSamplesBuffer fill (capped at the carried window)
            "received_bits_length": int(min(int(s.bit_fill[0]),
                                            p.sync_window))
            if s is not None and p is not None else 0,
            # decoded bytes are returned synchronously, never buffered
            # in the core (the processor's RingBuffer is that analog)
            "byte_buffer_length": 0,
        }

    def get_signal_quality(self) -> SignalQuality:
        # All five fields computed for real (the reference declares but
        # stubs the whole surface, core.ts:10-16 / fsk.ts:471-479):
        # snr/eye from the carried amplitude window; ber from the sync
        # correlation mismatch; frequency offset and phase jitter from
        # the per-class discriminator accumulators (quality_from_state).
        if self._state is None:
            return SignalQuality()
        ber, freq, jitter, eye = fsk_demod.quality_from_state(
            self.params, self._state)
        snr = 0.0
        amps = np.asarray(self._state.amp_tail[:, 0])
        active = amps[amps > float(self._state.threshold[0])]
        if len(active) >= 8:
            mean = float(active.mean())
            std = float(active.std())
            snr = float(10 * np.log10((mean ** 2) / (std ** 2 + 1e-12)))
        return SignalQuality(snr=snr, ber=float(ber[0]),
                             eye_opening=float(eye[0]),
                             phase_jitter=float(jitter[0]),
                             frequency_offset=float(freq[0]))
