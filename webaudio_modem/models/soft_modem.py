"""SoftModemCore — the soft FEC physical layer behind the modem API.

The FEC memo's receive pipeline (ops/soft_fsk.py) replaces hard UART
framing with coded frames, but until now it was reachable only through
its own function surface.  This facade gives it the SAME shape as
``FSKCore`` (configure / modulate_data / demodulate_data / reset /
get_status, reference contract src/core.ts:88-117), so everything
built against a modem core runs over the soft path unchanged:

    proc = FSKProcessor(core=SoftModemCore(config))
    transport = XModemTransport(proc)          # ARQ over soft FEC

Each ``modulate_data`` payload becomes ONE coded frame (sync pattern +
conv header + conv/RS/LDPC/turbo body, ``encode_frame_signal``); the
receive side is the streaming ``SoftFrameDecoder``, so frames decode
across arbitrary chunk boundaries and ``demodulate_data`` returns the
concatenated payloads — the transport sees a plain byte stream, the
same contract FSKCore serves (src/core.ts:99-102).  Single-byte
transport control messages (XModem ACK/NAK/EOT) are simply 1-byte
frames.

The extra FEC armor buys the transport real link margin: the soft path
decodes several dB below the hard UART modem's collapse (docs/FEC.md),
so the ARQ layer sees fewer retransmits on the same channel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from webaudio_modem.core import EventEmitter
from webaudio_modem.models.config import FSKConfig, FSKParams

# NOTE: ops.soft_fsk is imported lazily inside the class —
# models/__init__ exports this facade, and an eager import would close
# the cycle fsk_demod -> models.config -> models/__init__ ->
# soft_modem -> soft_fsk -> fsk_demod (partially initialized).


class SoftModemCore(EventEmitter):
    """FSKCore-shaped facade over the soft-decision FEC frame path.

    ``rs_parity`` / ``body_code`` select the body coding exactly as on
    the ``ops/soft_fsk`` surface (conv default, concatenated RS outer,
    or an LDPC/turbo block code).
    """

    def __init__(self, config: Optional[FSKConfig] = None,
                 rs_parity: int = 0, body_code=None):
        super().__init__()
        self._rs_parity = rs_parity
        self._body_code = body_code
        self._ready = False
        self.params: Optional[FSKParams] = None
        self._config: Optional[FSKConfig] = None
        self._decoder = None  # soft_fsk.SoftFrameDecoder once configured
        self._demodulation_calls = 0
        self._total_samples = 0
        if config is not None:
            self.configure(config)

    # -- configuration ----------------------------------------------------

    def configure(self, config) -> None:
        from webaudio_modem.ops import soft_fsk

        if isinstance(config, dict):
            config = FSKConfig.from_dict(config)
        self._config = config
        self.params = FSKParams.from_config(config)
        self._decoder = soft_fsk.SoftFrameDecoder(
            self.params, rs_parity=self._rs_parity,
            body_code=self._body_code)
        self._ready = True
        from webaudio_modem.ops import fsk_demod
        if fsk_demod.AUTO_WARM_QUALITY:
            # same lazy-hitch avoidance as FSKCore.configure: warm the
            # quality calibration off the hot path
            fsk_demod.warm_quality_calibration(self.params)
        self.emit("configured")

    def get_config(self) -> Optional[FSKConfig]:
        return self._config

    def is_ready(self) -> bool:
        return self._ready

    # -- modulation ---------------------------------------------------------

    def modulate_data(self, data) -> np.ndarray:
        from webaudio_modem.ops import soft_fsk

        if not self._ready:
            raise RuntimeError("Soft modem not configured")
        return np.asarray(soft_fsk.encode_frame_signal(
            self.params, bytes(data), rs_parity=self._rs_parity,
            body_code=self._body_code))

    # -- demodulation ---------------------------------------------------------

    def demodulate_data(self, samples) -> bytes:
        if not self._ready:
            raise RuntimeError("Soft modem not configured")
        samples = np.asarray(samples, np.float32)
        if samples.ndim != 1:
            raise ValueError("demodulate_data expects a 1-D sample "
                             "chunk (FSKCore contract)")
        self._demodulation_calls += 1
        self._total_samples += len(samples)
        if not len(samples):
            return b""
        return b"".join(self._decoder.feed(samples))

    # -- lifecycle / observability ------------------------------------------

    def reset(self) -> None:
        if self._decoder is not None:
            self._decoder.reset()
        self._demodulation_calls = 0
        self._total_samples = 0

    def get_signal_quality(self):
        """Same five computed fields as FSKCore.get_signal_quality.
        The soft stage never runs the chunk step's
        quality_window_update (sync lives in the decoder, not the
        kernel), so the decoder captures the last decoded frame's
        sync-window statistics itself and they are injected into the
        carried DemodState before the shared calibrated computation
        (reference stubs the surface entirely, src/core.ts:10-16)."""
        import jax.numpy as jnp

        from webaudio_modem.core import SignalQuality
        from webaudio_modem.ops import fsk_demod

        state = self._decoder._state if self._decoder is not None else None
        if state is None:
            return SignalQuality()
        q = self._decoder.last_sync_quality
        snr = 0.0
        if q is not None:
            ratio, s, ss, n, amp_mean, amp_var = q
            one = lambda v: jnp.full((1,), v, jnp.float32)  # noqa: E731
            state = state._replace(last_sync_ratio=one(ratio),
                                   q_win_sum=one(s),
                                   q_win_sumsq=one(ss),
                                   q_win_cnt=one(n))
            # SNR from the same window's I/Q amplitudes (every sample
            # carries the pattern, so no activity gating is needed —
            # FSKCore's amp_tail analog, which the soft stage does not
            # maintain)
            if n >= 8:
                snr = float(10 * np.log10((amp_mean ** 2)
                                          / (amp_var + 1e-12)))
        ber, freq, jitter, eye = fsk_demod.quality_from_state(
            self.params, state)
        return SignalQuality(snr=snr, ber=float(ber[0]),
                             eye_opening=float(eye[0]),
                             phase_jitter=float(jitter[0]),
                             frequency_offset=float(freq[0]))

    def get_status(self) -> dict:
        frames = self._decoder.frames_decoded if self._decoder else 0
        return {
            "ready": self._ready,
            "demodulation_calls": self._demodulation_calls,
            "total_samples_processed": self._total_samples,  # FSKCore key
            # FSKCore shape parity: every decoded frame required one
            # sync acquisition
            "sync_detections": frames,
            "frames_decoded": frames,
            "rs_parity": self._rs_parity,
            "body_code": (type(self._body_code).__name__
                          if self._body_code is not None else None),
        }
