"""ITU-T V.21 dual-channel full-duplex modem (BASELINE config 4).

V.21 (reference research/ITU-T-V21.md): 300 baud binary FSK with two
frequency-division channels sharing one line —
  channel 1 (calling station TX):   mark 980 Hz, space 1180 Hz
  channel 2 (answering station TX): mark 1650 Hz, space 1850 Hz
Full duplex works because each receiver band-limits to the remote
station's channel before demodulating.  A ``V21Station`` owns a
modulator on its own channel and a demodulator on the opposite channel,
fronted by a streaming windowed-sinc band-pass channel-separation
filter (ops/filters.sinc_bandpass) that suppresses the station's own
strong local transmission.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from webaudio_modem.models.config import FSKConfig
from webaudio_modem.models.fsk import FSKCore
from webaudio_modem.ops import filters

V21_BAUD = 300
V21_CH1 = dict(mark_frequency=980.0, space_frequency=1180.0)
V21_CH2 = dict(mark_frequency=1650.0, space_frequency=1850.0)


def v21_config(channel: int, sample_rate: int = 48000,
               **overrides) -> FSKConfig:
    if channel not in (1, 2):
        raise ValueError("V.21 channel must be 1 or 2")
    freqs = V21_CH1 if channel == 1 else V21_CH2
    return FSKConfig(sample_rate=sample_rate, baud_rate=V21_BAUD,
                     **freqs, **overrides)


class V21Station:
    """One end of a V.21 full-duplex link.

    ``channel`` is the station's OWN transmit channel; it receives on
    the other one.  ``separation_taps`` sizes the FIR channel-separation
    filter (odd-tap windowed sinc; larger = sharper split between the
    670 Hz-apart bands).
    """

    def __init__(self, channel: int, sample_rate: int = 48000,
                 separation_taps: int = 191, **config_overrides):
        self.tx_channel = channel
        self.rx_channel = 2 if channel == 1 else 1
        self.tx_config = v21_config(channel, sample_rate,
                                    **config_overrides)
        self.rx_config = v21_config(self.rx_channel, sample_rate,
                                    **config_overrides)
        self.modulator = FSKCore(self.tx_config)
        self.demodulator = FSKCore(self.rx_config)

        rx_center = (self.rx_config.mark_frequency
                     + self.rx_config.space_frequency) / 2
        # Carson bandwidth for 300 baud, 100 Hz deviation: 800 Hz
        bandwidth = 2 * (abs(self.rx_config.space_frequency
                             - self.rx_config.mark_frequency) / 2
                         + V21_BAUD)
        self._sep_taps = filters.sinc_bandpass(
            rx_center, bandwidth, sample_rate, separation_taps)
        self._sep_history = None

    # -- TX -----------------------------------------------------------------

    def modulate(self, data: bytes) -> np.ndarray:
        return self.modulator.modulate_data(data)

    # -- RX -----------------------------------------------------------------

    def demodulate(self, line_samples: np.ndarray) -> bytes:
        """Feed line audio (own TX + remote TX mixed); returns decoded
        remote bytes.  Streaming: FIR history and demod state carry."""
        line_samples = np.asarray(line_samples, dtype=np.float32)
        self._sep_history, separated = filters.fir_apply(
            self._sep_taps, line_samples[None, :], self._sep_history)
        return self.demodulator.demodulate_data(
            np.asarray(separated[0]))

    def reset(self) -> None:
        self.modulator.reset()
        self.modulator.configure(self.tx_config)
        self.demodulator.reset()
        self.demodulator.configure(self.rx_config)
        self._sep_history = None


class V21Duplex:
    """A complete two-station V.21 link over a shared line."""

    def __init__(self, sample_rate: int = 48000, **overrides):
        self.calling = V21Station(1, sample_rate, **overrides)
        self.answering = V21Station(2, sample_rate, **overrides)

    def exchange(self, calling_data: bytes, answering_data: bytes,
                 noise: Optional[np.ndarray] = None):
        """Simultaneously transmit both directions over one line and
        decode both; returns (decoded_at_answering, decoded_at_calling)."""
        sig1 = self.calling.modulate(calling_data)
        sig2 = self.answering.modulate(answering_data)
        n = max(len(sig1), len(sig2))
        line = np.zeros(n, np.float32)
        line[:len(sig1)] += sig1
        line[:len(sig2)] += sig2
        if noise is not None:
            line = line + np.asarray(noise[:n], np.float32)
        got_ch1 = self.answering.demodulate(line)   # answering hears ch1
        got_ch2 = self.calling.demodulate(line)     # calling hears ch2
        return got_ch1, got_ch2
