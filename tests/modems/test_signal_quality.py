"""SignalQuality estimator validation.

The reference declares the SignalQuality surface and stubs every field
to zero (src/core.ts:10-16, src/modems/fsk.ts:471-479); here all five
fields are genuinely computed.  These tests inject known impairments
(carrier offset, noise) and assert the estimates track them.
"""

import numpy as np
import pytest

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKConfig
from webaudio_modem.models.farm import ModemFarm
from webaudio_modem.models.fsk import FSKCore
from webaudio_modem.models.psk import PSKConfig, PSKCore

MSG = b"Quality check 123"


def add_noise(sig, snr_db, rng):
    power = float(np.mean(np.asarray(sig, np.float64) ** 2))
    amp = np.sqrt(3 * power / (10 ** (snr_db / 10)))
    noise = amp * (rng.uniform(size=len(sig)) * 2 - 1)
    return (np.asarray(sig) + noise).astype(np.float32)


def shifted_tx(base: FSKConfig, delta: float) -> FSKCore:
    """Transmitter with both tones shifted by ``delta`` Hz (a pure
    carrier offset as seen by an unshifted receiver)."""
    return FSKCore(base.replace(
        mark_frequency=base.mark_frequency + delta,
        space_frequency=base.space_frequency + delta))


class TestFrequencyOffset:
    @pytest.mark.parametrize("delta", [0, 10, 30, -30])
    def test_tracks_injected_offset(self, delta):
        rx = FSKCore(DEFAULT_FSK_CONFIG)
        sig = shifted_tx(DEFAULT_FSK_CONFIG, delta).modulate_data(MSG)
        assert rx.demodulate_data(sig) == MSG
        q = rx.get_signal_quality()
        assert q.frequency_offset == pytest.approx(delta, abs=2.0)

    def test_tracks_offset_at_300_baud(self):
        cfg = FSKConfig(baud_rate=300, mark_frequency=1270,
                        space_frequency=1070)
        rx = FSKCore(cfg)
        sig = FSKCore(cfg.replace(mark_frequency=1285,
                                  space_frequency=1085)).modulate_data(b"hi")
        assert rx.demodulate_data(sig) == b"hi"
        assert rx.get_signal_quality().frequency_offset == \
            pytest.approx(15, abs=2.0)

    def test_zero_before_any_sync(self):
        rx = FSKCore(DEFAULT_FSK_CONFIG)
        q = rx.get_signal_quality()
        assert q.frequency_offset == 0.0
        assert q.ber == 0.0
        assert q.phase_jitter == 0.0


class TestBer:
    def test_zero_on_clean_signal(self):
        rx = FSKCore(DEFAULT_FSK_CONFIG)
        assert rx.demodulate_data(rx.modulate_data(MSG)) == MSG
        assert rx.get_signal_quality().ber == 0.0

    def test_rises_with_noise(self):
        rng = np.random.RandomState(7)
        bers = {}
        for snr in (40, 10):
            rx = FSKCore(DEFAULT_FSK_CONFIG)
            sig = add_noise(rx.modulate_data(MSG), snr, rng)
            rx.demodulate_data(sig)
            bers[snr] = rx.get_signal_quality().ber
        assert bers[10] > bers[40]
        assert bers[10] > 0.005

    def test_rises_with_carrier_offset(self):
        rx = FSKCore(DEFAULT_FSK_CONFIG)
        sig = shifted_tx(DEFAULT_FSK_CONFIG, 30).modulate_data(MSG)
        rx.demodulate_data(sig)
        assert rx.get_signal_quality().ber > 0.02


class TestPhaseJitter:
    def test_zero_on_clean_signal(self):
        rx = FSKCore(DEFAULT_FSK_CONFIG)
        rx.demodulate_data(rx.modulate_data(MSG))
        assert rx.get_signal_quality().phase_jitter == \
            pytest.approx(0.0, abs=1e-4)

    def test_rises_with_noise(self):
        # the excess-variance estimator is clamped at 0, so single
        # draws can report 0 — compare seed-averaged estimates
        def mean_jitter(snr_db):
            vals = []
            for seed in range(6):
                rx = FSKCore(DEFAULT_FSK_CONFIG)
                sig = add_noise(rx.modulate_data(MSG), snr_db,
                                np.random.RandomState(seed))
                rx.demodulate_data(sig)
                vals.append(rx.get_signal_quality().phase_jitter)
            return float(np.mean(vals))

        j_clean = mean_jitter(60)
        j_noisy = mean_jitter(10)
        assert j_noisy > j_clean
        assert j_noisy > 1e-3


class TestSnrAndEye:
    def test_snr_live_during_signal(self):
        # snr is a LIVE estimate from the carried amplitude window;
        # query while the window still holds signal (strip the trailing
        # byte-time of silence)
        rx = FSKCore(DEFAULT_FSK_CONFIG)
        sig = np.asarray(rx.modulate_data(MSG))
        trail = (rx.params.bits_per_byte * rx.params.samples_per_bit)
        rx.demodulate_data(sig[:-trail])
        assert rx.get_signal_quality().snr > 0

    def test_eye_open_on_clean_closes_with_noise(self):
        rx = FSKCore(DEFAULT_FSK_CONFIG)
        rx.demodulate_data(rx.modulate_data(MSG))
        eye_clean = rx.get_signal_quality().eye_opening
        assert eye_clean > 0.95

        def mean_eye(snr_db):
            vals = []
            for seed in range(4):
                r = FSKCore(DEFAULT_FSK_CONFIG)
                r.demodulate_data(add_noise(r.modulate_data(MSG), snr_db,
                                            np.random.RandomState(seed)))
                vals.append(r.get_signal_quality().eye_opening)
            return float(np.mean(vals))

        assert mean_eye(8) < eye_clean


class TestFarmQuality:
    def test_per_channel_quality_is_independent(self):
        """One batched farm call; channel 0 clean, channel 1 with a
        +30 Hz carrier offset, channel 2 noisy — the per-channel
        estimates must reflect each impairment independently."""
        B = 3
        rng = np.random.RandomState(5)
        clean = np.asarray(FSKCore(DEFAULT_FSK_CONFIG).modulate_data(MSG))
        offset = np.asarray(
            shifted_tx(DEFAULT_FSK_CONFIG, 30).modulate_data(MSG))
        noisy = add_noise(clean, 12, rng)
        T = len(clean)
        mat = np.stack([clean, offset[:T], noisy]).astype(np.float32)
        farm = ModemFarm(DEFAULT_FSK_CONFIG, B, donate=False)
        out = farm.demodulate(mat)
        assert out[0] == MSG
        q = farm.get_signal_quality()
        assert q[0].frequency_offset == pytest.approx(0, abs=2.0)
        assert q[1].frequency_offset == pytest.approx(30, abs=3.0)
        assert q[0].ber == 0.0
        assert q[1].ber > 0.02
        assert q[2].ber > q[0].ber

    def test_quality_survives_streaming_chunks(self):
        rx = FSKCore(DEFAULT_FSK_CONFIG)
        sig = np.asarray(
            shifted_tx(DEFAULT_FSK_CONFIG, 20).modulate_data(MSG))
        out = b""
        for i in range(0, len(sig), 2048):
            out += rx.demodulate_data(sig[i:i + 2048])
        assert out == MSG
        assert rx.get_signal_quality().frequency_offset == \
            pytest.approx(20, abs=3.0)


class TestPSKQuality:
    def test_clean_psk_quality(self):
        rx = PSKCore(PSKConfig())
        assert rx.demodulate_data(
            np.asarray(rx.modulate_data(b"psk quality"))) == b"psk quality"
        q = rx.get_signal_quality()
        assert q.ber == 0.0
        assert abs(q.frequency_offset) < 1.0

    def test_psk_tracks_carrier_offset(self):
        tx = PSKCore(PSKConfig(carrier_frequency=1815.0))
        rx = PSKCore(PSKConfig())
        rx.demodulate_data(np.asarray(tx.modulate_data(b"psk quality")))
        assert rx.get_signal_quality().frequency_offset == \
            pytest.approx(15, abs=4.0)


def test_quality_unaffected_by_chunk_boundary_near_sync():
    # a sync firing within a bit period of a chunk END must not anchor
    # its quality window at the truncated chunk (the true correlation
    # peak may lie in the next chunk): on a clean signal, ber must stay
    # 0 for EVERY split position around the sync point
    import jax.numpy as jnp

    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
    from webaudio_modem.ops import fsk_demod, fsk_mod

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    sig = np.asarray(fsk_mod.modulate(params, b"QB"), np.float32)

    # locate the fire position once (whole-signal pass)
    state = fsk_demod.init_state(params, 1)
    ratio = params.downsample_ratio
    state, _ = fsk_demod.demod_chunk(params, 0, state,
                                     jnp.asarray(sig[None, :]))
    assert int(np.asarray(state.sync_count)[0]) == 1

    # sweep split points across +-1.5 bit periods around the sync
    spb = params.samples_per_bit
    # sync happens roughly after lead + pattern bits
    approx = (2 + len(params.pattern_bits)) * spb
    bers = {}
    for split in range(approx - spb, approx + spb // 2, ratio * 5):
        if split <= 0 or split >= len(sig):
            continue
        st = fsk_demod.init_state(params, 1)
        st, _ = fsk_demod.demod_chunk(params, 0, st,
                                      jnp.asarray(sig[None, :split]))
        st, _ = fsk_demod.demod_chunk(params, 0, st,
                                      jnp.asarray(sig[None, split:]))
        ber, freq, jit, eye = fsk_demod.quality_from_state(params, st)
        bers[split] = float(ber[0])
    assert bers, "no split positions tested"
    bad = {s: b for s, b in bers.items() if b > 1e-6}
    assert not bad, f"spurious BER at splits: {bad}"


class TestCalibrationWarming:
    def test_warm_populates_cache_and_is_idempotent(self):
        from webaudio_modem.models.config import FSKParams
        from webaudio_modem.ops import fsk_demod

        config = FSKConfig(baud_rate=1200, mark_frequency=2125,
                           space_frequency=2295)
        params = FSKParams.from_config(config)
        before = fsk_demod._quality_calibration.cache_info().currsize
        fsk_demod.warm_quality_calibration(params, background=False)
        after = fsk_demod._quality_calibration.cache_info().currsize
        assert after == before + 1
        # idempotent: second warm neither re-spawns nor re-computes
        fsk_demod.warm_quality_calibration(params, background=False)
        assert fsk_demod._quality_calibration.cache_info().currsize \
            == after

    def test_configure_warms_in_background_when_enabled(self):
        import time

        from webaudio_modem.ops import fsk_demod

        config = FSKConfig(baud_rate=1200, mark_frequency=1500,
                           space_frequency=1700)
        old = fsk_demod.AUTO_WARM_QUALITY
        fsk_demod.AUTO_WARM_QUALITY = True
        try:
            t0 = time.perf_counter()
            core = FSKCore(config)
            configure_s = time.perf_counter() - t0
            # configure must not block on the calibration build
            assert configure_s < 2.0
            # ... but the build lands shortly after, in the daemon thread
            from webaudio_modem.models.config import FSKParams

            key = (FSKParams.from_config(config), "fsk")
            deadline = time.time() + 60
            while time.time() < deadline:
                if fsk_demod._quality_calibration.cache_info().currsize \
                        and key in fsk_demod._warm_started:
                    try:
                        hits0 = fsk_demod._quality_calibration \
                            .cache_info().hits
                        fsk_demod._quality_calibration(*key)
                        if fsk_demod._quality_calibration.cache_info() \
                                .hits > hits0:
                            break
                    except Exception:
                        pass
                time.sleep(0.1)
            assert key in fsk_demod._warm_started
            core.get_signal_quality()  # no hitch left to pay
        finally:
            fsk_demod.AUTO_WARM_QUALITY = old
