"""Impairment tolerance envelopes — carrier offset & clock skew.

The reference declares SignalQuality.carrierOffset / timingJitter
(core.ts:10-16) but stubs the getter to zeros (fsk.ts:471-479) and
never sweeps either impairment; these tests pin the measured envelopes
of both physical layers here (docs/BER_RESULTS.md "Impairment
tolerance") and hold device==golden degradation parity on identical
impaired signals.
"""

import numpy as np

from webaudio_modem.models.config import FSKConfig
from webaudio_modem.sim.ber import golden_demodulate
from webaudio_modem.sim.impairments import (carrier_offset_sweep,
                                                clock_skew,
                                                clock_skew_sweep)

MSG = b"\x6b\x2e\x91\xd4"


class TestClockSkewResample:
    def test_identity_at_zero(self):
        sig = np.sin(np.arange(300, dtype=np.float32) * 0.13)
        assert np.array_equal(clock_skew(sig, 0.0), sig)

    def test_fast_clock_shortens(self):
        sig = np.sin(np.arange(1000, dtype=np.float32) * 0.05)
        out = clock_skew(sig, 0.01)
        assert len(out) == int(1000 / 1.01)

    def test_small_skew_close_to_input(self):
        sig = np.sin(np.arange(1000, dtype=np.float32) * 0.05)
        out = clock_skew(sig, 1e-5)
        n = len(out)
        assert np.allclose(out[: n // 2], sig[: n // 2], atol=1e-3)


class TestCarrierOffsetEnvelope:
    def test_hard_path_tolerates_10hz(self):
        pts = carrier_offset_sweep(FSKConfig(), [0.0, 10.0],
                                   message=MSG, messages_per_point=4,
                                   snr_db=None)
        assert all(p.fer == 0.0 for p in pts)

    def test_hard_path_fails_far_off(self):
        (p,) = carrier_offset_sweep(FSKConfig(), [120.0], message=MSG,
                                    messages_per_point=2, snr_db=None)
        assert p.fer == 1.0

    def test_device_matches_golden_under_offset(self):
        # degradation parity on identical impaired signals, including
        # a failing point
        cfg = FSKConfig()
        kw = dict(message=MSG, messages_per_point=4, snr_db=30.0,
                  seed=3)
        dev = carrier_offset_sweep(cfg, [20.0, 60.0], **kw)
        gold = carrier_offset_sweep(cfg, [20.0, 60.0],
                                    demodulate=golden_demodulate(cfg),
                                    **kw)
        assert [(p.fer, p.ber) for p in dev] \
            == [(p.fer, p.ber) for p in gold]

    def test_soft_path_tolerates_40hz(self):
        (p,) = carrier_offset_sweep(FSKConfig(), [40.0], message=MSG,
                                    messages_per_point=2, snr_db=None,
                                    soft=True)
        assert p.fer == 0.0


class TestClockSkewEnvelope:
    def test_hard_path_tolerates_2000ppm(self):
        pts = clock_skew_sweep(FSKConfig(), [0.0, 0.002], message=MSG,
                               messages_per_point=4, snr_db=None)
        assert all(p.fer == 0.0 for p in pts)

    def test_hard_path_fails_at_2pct(self):
        (p,) = clock_skew_sweep(FSKConfig(), [0.02], message=MSG,
                                messages_per_point=2, snr_db=None)
        assert p.fer == 1.0

    def test_device_matches_golden_under_skew(self):
        cfg = FSKConfig()
        kw = dict(message=MSG, messages_per_point=4, snr_db=30.0,
                  seed=5)
        dev = clock_skew_sweep(cfg, [0.005, 0.01], **kw)
        gold = clock_skew_sweep(cfg, [0.005, 0.01],
                                demodulate=golden_demodulate(cfg), **kw)
        assert [(p.fer, p.ber) for p in dev] \
            == [(p.fer, p.ber) for p in gold]

    def test_soft_path_tolerates_2000ppm(self):
        (p,) = clock_skew_sweep(FSKConfig(), [0.002], message=MSG,
                                messages_per_point=2, snr_db=None,
                                soft=True)
        assert p.fer == 0.0
