"""BASELINE configs 2 and 4: Bell-202-style BER sweep parity and
ITU-T V.21 dual-channel full-duplex."""

import numpy as np
import pytest

from webaudio_modem.models.config import FSKConfig
from webaudio_modem.models.v21 import V21Duplex, V21Station, v21_config
from webaudio_modem.sim.ber import (BERPoint, ber_sweep, bit_errors,
                                        golden_demodulate)

BELL202 = FSKConfig(baud_rate=1200, mark_frequency=1200.0,
                    space_frequency=2200.0)


class TestBitErrors:
    def test_exact(self):
        assert bit_errors(b"abc", b"abc") == 0

    def test_single_bit(self):
        assert bit_errors(b"\x00", b"\x01") == 1

    def test_length_mismatch(self):
        assert bit_errors(b"ab", b"a") == 8

    def test_empty_decoded(self):
        assert bit_errors(b"ab", b"") == 16


class TestBERSweep:
    def test_clean_decode_at_high_snr(self):
        pts = ber_sweep(BELL202, [35.0], messages_per_point=4)
        assert pts[0].ber == 0.0
        assert pts[0].fer == 0.0

    def test_ber_monotone_with_snr(self):
        pts = ber_sweep(BELL202, [35.0, 3.0], messages_per_point=4)
        assert pts[0].ber <= pts[1].ber

    def test_device_parity_with_golden(self):
        # identical noise (same seed) -> curves must match closely;
        # at 30 dB both decode exactly (the reference's hard-pass region)
        snrs = [30.0]
        dev = ber_sweep(BELL202, snrs, messages_per_point=3, seed=7)
        gold = ber_sweep(BELL202, snrs, messages_per_point=3, seed=7,
                         demodulate=golden_demodulate(BELL202))
        assert dev[0].ber == gold[0].ber == 0.0

    def test_device_parity_in_failure_region(self):
        # deep degradation (-6 dB): both implementations must make the
        # SAME errors on the same noise (docs/BER_RESULTS.md)
        snrs = [-6.0]
        dev = ber_sweep(BELL202, snrs, messages_per_point=6, seed=99)
        gold = ber_sweep(BELL202, snrs, messages_per_point=6, seed=99,
                         demodulate=golden_demodulate(BELL202))
        assert dev[0].bit_errors == gold[0].bit_errors
        assert dev[0].byte_errors == gold[0].byte_errors
        assert dev[0].bit_errors > 0  # genuinely in the failure region

    def test_point_properties(self):
        p = BERPoint(snr_db=10, messages=4, byte_errors=1, bit_errors=3,
                     total_bits=96)
        assert p.fer == 0.25
        assert abs(p.ber - 3 / 96) < 1e-12


class TestV21:
    def test_config_channels(self):
        c1 = v21_config(1)
        c2 = v21_config(2)
        assert (c1.mark_frequency, c1.space_frequency) == (980, 1180)
        assert (c2.mark_frequency, c2.space_frequency) == (1650, 1850)
        assert c1.baud_rate == c2.baud_rate == 300

    def test_invalid_channel(self):
        with pytest.raises(ValueError):
            v21_config(3)

    def test_single_direction_through_separation_filter(self):
        station = V21Station(2)   # receives channel 1
        remote = V21Station(1)
        data = b"\x42"
        sig = remote.modulate(data)
        assert station.demodulate(sig) == data

    def test_full_duplex_exchange(self):
        # both directions simultaneously over one line (BASELINE cfg 4)
        link = V21Duplex()
        d1, d2 = b"ping!", b"pong."
        got1, got2 = link.exchange(d1, d2)
        assert got1 == d1
        assert got2 == d2

    def test_full_duplex_with_noise(self):
        link = V21Duplex()
        rng = np.random.RandomState(9)
        d1, d2 = b"\x11\x22", b"\x33\x44"
        sig_len = len(link.calling.modulate(b"\x11\x22"))
        link.calling.reset()
        noise = (rng.uniform(-1, 1, sig_len + 48000) * 0.02).astype(
            np.float32)
        got1, got2 = link.exchange(d1, d2, noise=noise)
        assert got1 == d1
        assert got2 == d2
