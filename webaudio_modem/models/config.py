"""FSK configuration and derived parameters.

Field names and defaults mirror the reference exactly
(FSKConfig src/modems/fsk.ts:5-33, derived parameters
calculateParameters fsk.ts:426-444, DSP init initializeDSP
fsk.ts:446-462) so that configurations written against the reference
carry over verbatim.

``FSKParams`` is a frozen, hashable dataclass: it is passed as a static
argument to jitted device functions, so every distinct modem
configuration compiles exactly once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Mapping, Tuple

Parity = Literal["none", "even", "odd"]


@dataclasses.dataclass(frozen=True)
class FSKConfig:
    sample_rate: int = 48000
    baud_rate: int = 1200
    mark_frequency: float = 1650.0
    space_frequency: float = 1850.0
    preamble_pattern: Tuple[int, ...] = (0x55, 0x55)
    sfd_pattern: Tuple[int, ...] = (0x7E,)
    start_bits: int = 1
    stop_bits: int = 1
    parity: Parity = "none"
    sync_threshold: float = 0.85
    agc_enabled: bool = True
    pre_filter_bandwidth: float = 800.0
    adaptive_threshold: bool = True

    def replace(self, **kwargs) -> "FSKConfig":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def from_dict(d: Mapping) -> "FSKConfig":
        """Build from a reference-style camelCase or snake_case dict."""
        key_map = {
            "sampleRate": "sample_rate",
            "baudRate": "baud_rate",
            "markFrequency": "mark_frequency",
            "spaceFrequency": "space_frequency",
            "preamblePattern": "preamble_pattern",
            "sfdPattern": "sfd_pattern",
            "startBits": "start_bits",
            "stopBits": "stop_bits",
            "syncThreshold": "sync_threshold",
            "agcEnabled": "agc_enabled",
            "preFilterBandwidth": "pre_filter_bandwidth",
            "adaptiveThreshold": "adaptive_threshold",
        }
        kwargs = {}
        for k, v in d.items():
            k = key_map.get(k, k)
            if k in ("preamble_pattern", "sfd_pattern"):
                v = tuple(v)
            kwargs[k] = v
        return FSKConfig(**kwargs)


DEFAULT_FSK_CONFIG = FSKConfig()


def _framed_bits(byte: int, config: FSKConfig) -> Tuple[int, ...]:
    """UART-frame one byte: start bits, 8 data bits MSB-first, optional
    parity, stop bits (reference addByteToPattern fsk.ts:159-173)."""
    bits = [0] * config.start_bits
    bits += [(byte >> i) & 1 for i in range(7, -1, -1)]
    if config.parity != "none":
        parity = 0
        for i in range(8):
            parity ^= (byte >> i) & 1
        bits.append(parity if config.parity == "even" else 1 - parity)
    bits += [1] * config.stop_bits
    return tuple(bits)


@dataclasses.dataclass(frozen=True)
class FSKParams:
    """Derived static parameters (reference calculateParameters
    fsk.ts:426-444 + configure fsk.ts:133-157).  Hashable — used as a
    static jit argument."""

    config: FSKConfig
    sample_rate: int
    baud_rate: int
    mark_freq: float
    space_freq: float
    center_freq: float
    samples_per_bit: int             # full-rate, for modulation
    bits_per_byte: int
    downsample_ratio: int            # fixed 2 (fsk.ts:430)
    downsample_rate: float
    ds_samples_per_bit: int          # downsampled, for demodulation
    # Frame-sync pattern: preamble+SFD bytes, UART-framed (fsk.ts:142-145)
    pattern_bits: Tuple[int, ...]
    max_sync_bits: int               # pattern length + 32 (fsk.ts:145)
    sync_window: int                 # pattern_bits * ds_samples_per_bit
    quarter_bit: int                 # sync-check stride (fsk.ts:299)
    amp_window: int                  # amplitude buffer len (fsk.ts:150)
    samples_for_eod: float           # silence samples for EOD (fsk.ts:148)
    # Demod slicer polarity: the reference slices phaseDiff>0 -> mark
    # (fsk.ts:264), correct only when mark < space; we apply the sign
    # analytically so Bell-103-style mark>space configs also decode.
    # For every mark<space config this is bit-exact with the reference.
    polarity: float
    # Biquad coefficients (normalized, a0 == 1): (b0,b1,b2,a1,a2)
    pre_filter: Tuple[float, ...]
    iq_filter: Tuple[float, ...]
    post_filter: Tuple[float, ...]
    agc_attack: float
    agc_release: float
    agc_target: float

    @staticmethod
    def from_config(config: FSKConfig) -> "FSKParams":
        from webaudio_modem.ops import filters

        downsample_ratio = 2
        downsample_rate = config.sample_rate / downsample_ratio
        bits_per_byte = (8 + config.start_bits + config.stop_bits
                         + (1 if config.parity != "none" else 0))
        ds_per_bit = int(downsample_rate // config.baud_rate)
        center = (config.mark_frequency + config.space_frequency) / 2

        pattern = []
        for byte in (*config.preamble_pattern, *config.sfd_pattern):
            pattern.extend(_framed_bits(byte, config))
        pattern_bits = tuple(pattern)

        # Pre-filter bandwidth: max(config, Carson rule) (fsk.ts:451-455)
        deviation = abs(config.space_frequency - config.mark_frequency) / 2
        carson = 2 * (deviation + config.baud_rate)
        bandwidth = max(config.pre_filter_bandwidth, carson)

        pre = filters.butterworth_bandpass(center, bandwidth,
                                           config.sample_rate)
        low = filters.butterworth_lowpass(config.baud_rate,
                                          config.sample_rate)

        sr = config.sample_rate
        return FSKParams(
            config=config,
            sample_rate=sr,
            baud_rate=config.baud_rate,
            mark_freq=config.mark_frequency,
            space_freq=config.space_frequency,
            center_freq=center,
            samples_per_bit=int(sr // config.baud_rate),
            bits_per_byte=bits_per_byte,
            downsample_ratio=downsample_ratio,
            downsample_rate=downsample_rate,
            ds_samples_per_bit=ds_per_bit,
            pattern_bits=pattern_bits,
            max_sync_bits=len(pattern_bits) + 32,
            sync_window=len(pattern_bits) * ds_per_bit,
            # JS Math.round rounds half-up, unlike Python's banker's
            # rounding (fsk.ts:299).
            quarter_bit=max(1, math.floor(ds_per_bit / 4 + 0.5)),
            amp_window=ds_per_bit * 8,
            samples_for_eod=bits_per_byte * ds_per_bit * 0.7,
            polarity=1.0 if config.mark_frequency <= config.space_frequency
            else -1.0,
            pre_filter=filters.normalize_biquad(*pre),
            iq_filter=filters.normalize_biquad(*low),
            post_filter=filters.normalize_biquad(*low),
            agc_attack=1.0 - math.exp(-1.0 / (sr * 0.001)),
            agc_release=1.0 - math.exp(-1.0 / (sr * 0.01)),
            agc_target=0.5,
        )

    @property
    def stop_bit_position(self) -> int:
        # reference processByte fsk.ts:348
        return 9 if self.config.parity == "none" else 10
