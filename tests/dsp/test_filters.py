"""DSP filter tests (reference tests/dsp/filters.node.test.ts +
filters-advanced.node.test.ts)."""

import numpy as np
import pytest

from webaudio_modem.ops import filters
from webaudio_modem.ops.filters import (FilterFactory, FIRFilter,
                                            IIRFilter)


def freq_response_db(filt, freq, sample_rate, n=4096):
    """Single-bin frequency-response probe
    (reference filters-advanced.node.test.ts:64-111)."""
    t = np.arange(n)
    x = np.sin(2 * np.pi * freq * t / sample_rate)
    y = np.array([filt.process(float(v)) for v in x])
    # steady-state RMS ratio over the second half
    half = n // 2
    rin = np.sqrt(np.mean(x[half:] ** 2))
    rout = np.sqrt(np.mean(y[half:] ** 2))
    return 20 * np.log10(rout / rin)


class TestIIRFilter:
    def test_coefficient_normalization(self):
        # a0 != 1 must be normalized away (filters.ts:30-39)
        f = IIRFilter([2.0, 4.0], [2.0, 1.0])
        c = f.get_coefficients()
        assert c["a"][0] == 1.0
        assert c["b"] == [1.0, 2.0]
        assert c["a"][1] == 0.5

    def test_empty_coefficients_rejected(self):
        with pytest.raises(ValueError):
            IIRFilter([], [1.0])
        with pytest.raises(ValueError):
            IIRFilter([1.0], [])

    def test_a0_zero_rejected(self):
        with pytest.raises(ValueError):
            IIRFilter([1.0], [0.0, 0.5])

    def test_impulse_response_passthrough(self):
        f = IIRFilter([1.0], [1.0])
        assert f.process(1.0) == 1.0
        assert f.process(0.0) == 0.0

    def test_reset_clears_state(self):
        f = FilterFactory.create_iir_lowpass(1000, 48000)
        f.process(1.0)
        f.reset()
        assert f.process(0.0) == 0.0

    def test_stability_bounded_output(self):
        f = FilterFactory.create_iir_lowpass(1000, 48000)
        rng = np.random.RandomState(0)
        out = [f.process(float(v)) for v in rng.uniform(-1, 1, 10000)]
        assert np.all(np.isfinite(out))
        assert np.max(np.abs(out)) < 10.0

    def test_lowpass_minus3db_at_cutoff(self):
        # reference filters-advanced.node.test.ts:196-217
        f = FilterFactory.create_iir_lowpass(1000, 48000)
        db = freq_response_db(f, 1000, 48000)
        assert abs(db - (-3.0)) < 0.3

    def test_lowpass_stopband(self):
        f = FilterFactory.create_iir_lowpass(1000, 48000)
        db = freq_response_db(f, 10000, 48000)
        assert db < -10.0

    def test_lowpass_dc_gain_unity(self):
        # reference filters-advanced.node.test.ts:311-324
        f = FilterFactory.create_iir_lowpass(1000, 48000)
        out = [f.process(1.0) for _ in range(2000)]
        assert abs(out[-1] - 1.0) < 1e-3

    def test_bandpass_passes_center_rejects_edges(self):
        f = FilterFactory.create_iir_bandpass(1750, 800, 48000)
        center = freq_response_db(f, 1750, 48000)
        low = freq_response_db(
            FilterFactory.create_iir_bandpass(1750, 800, 48000), 200, 48000)
        high = freq_response_db(
            FilterFactory.create_iir_bandpass(1750, 800, 48000), 12000,
            48000)
        assert center > -1.0
        assert low < -10.0
        assert high < -10.0

    def test_highpass_blocks_dc(self):
        f = FilterFactory.create_iir_highpass(1000, 48000)
        out = [f.process(1.0) for _ in range(2000)]
        assert abs(out[-1]) < 1e-3


class TestFIRFilter:
    def test_impulse_response_equals_coefficients(self):
        coeffs = [0.25, 0.5, 0.25]
        f = FIRFilter(coeffs)
        impulse = [f.process(x) for x in [1.0, 0.0, 0.0]]
        np.testing.assert_allclose(impulse, coeffs)

    def test_symmetry_linear_phase(self):
        # windowed-sinc designs are symmetric
        # (filters-advanced.node.test.ts:244-307)
        c = filters.sinc_lowpass(1000, 48000, 51)
        np.testing.assert_allclose(c, c[::-1], atol=1e-12)

    def test_odd_tap_enforcement(self):
        assert len(filters.sinc_lowpass(1000, 48000, 50)) == 51

    def test_fir_lowpass_dc_gain(self):
        c = filters.sinc_lowpass(1000, 48000, 101)
        assert abs(np.sum(c) - 1.0) < 0.01

    def test_fir_highpass_spectral_inversion(self):
        lp = filters.sinc_lowpass(1000, 48000, 51)
        hp = filters.sinc_highpass(1000, 48000, 51)
        np.testing.assert_allclose(hp, -lp + np.eye(51)[25], atol=1e-12)
        # DC rejection improves with tap count (51-tap truncation leaves
        # residual); 201 taps is effectively DC-blocked
        hp201 = filters.sinc_highpass(1000, 48000, 201)
        assert abs(np.sum(hp201)) < 0.02

    def test_fir_bandpass_is_hp_conv_lp_truncated(self):
        bp = filters.sinc_bandpass(1750, 800, 48000, 51)
        hp = filters.sinc_highpass(1350, 48000, 51)
        lp = filters.sinc_lowpass(2150, 48000, 51)
        np.testing.assert_allclose(bp, np.convolve(hp, lp)[:51], atol=1e-12)

    def test_reset(self):
        f = FIRFilter([0.5, 0.5])
        f.process(1.0)
        f.reset()
        assert f.process(0.0) == 0.0


class TestDesignParity:
    """Coefficient-level parity with the reference formulas
    (filters.ts:180-234)."""

    def test_butterworth_lowpass_formula(self):
        b, a = filters.butterworth_lowpass(1200, 48000)
        c = np.tan(np.pi * (1200 / 24000) / 2)
        denom = 1 + np.sqrt(2) * c + c * c
        np.testing.assert_allclose(b[0], c * c / denom)
        np.testing.assert_allclose(a[1], (2 * c * c - 2) / denom)
        np.testing.assert_allclose(a[2],
                                   (1 - np.sqrt(2) * c + c * c) / denom)

    def test_butterworth_bandpass_formula(self):
        b, a = filters.butterworth_bandpass(1750, 800, 48000)
        omega = 2 * np.pi * 1750 / 48000
        bw = 2 * np.pi * 800 / 48000
        c = np.tan(bw / 2)
        d = 2 * np.cos(omega)
        denom = 1 + c + c * c
        np.testing.assert_allclose(b, [c / denom, 0, -c / denom])
        np.testing.assert_allclose(a[1], -d * (1 + c * c) / denom)


class TestBatchedJaxFilters:
    def test_biquad_scan_matches_scalar(self):
        import jax.numpy as jnp

        coeffs = filters.normalize_biquad(
            *filters.butterworth_lowpass(1200, 48000))
        rng = np.random.RandomState(1)
        x = rng.uniform(-1, 1, (3, 500)).astype(np.float32)
        state = filters.biquad_init_state((3,))
        _, y = filters.biquad_scan(coeffs, state, jnp.asarray(x))
        # scalar oracle
        for b in range(3):
            f = IIRFilter(*filters.butterworth_lowpass(1200, 48000))
            ref = [f.process(float(v)) for v in x[b]]
            np.testing.assert_allclose(np.asarray(y[b]), ref, atol=1e-4)

    def test_biquad_scan_streaming_chunks(self):
        import jax.numpy as jnp

        coeffs = filters.normalize_biquad(
            *filters.butterworth_lowpass(1200, 48000))
        rng = np.random.RandomState(2)
        x = rng.uniform(-1, 1, (2, 300)).astype(np.float32)
        state = filters.biquad_init_state((2,))
        _, whole = filters.biquad_scan(coeffs, state, jnp.asarray(x))
        state = filters.biquad_init_state((2,))
        parts = []
        for i in range(0, 300, 100):
            state, y = filters.biquad_scan(coeffs, state,
                                           jnp.asarray(x[:, i:i + 100]))
            parts.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(parts, -1),
                                   np.asarray(whole), atol=1e-6)

    def test_fir_apply_matches_scalar(self):
        import jax.numpy as jnp

        coeffs = filters.sinc_lowpass(1000, 48000, 21)
        rng = np.random.RandomState(3)
        x = rng.uniform(-1, 1, 200).astype(np.float32)
        _, y = filters.fir_apply(coeffs, jnp.asarray(x))
        f = FIRFilter(coeffs)
        ref = [f.process(float(v)) for v in x]
        np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4)

    def test_fir_apply_streaming(self):
        import jax.numpy as jnp

        coeffs = filters.sinc_lowpass(1000, 48000, 21)
        rng = np.random.RandomState(4)
        x = rng.uniform(-1, 1, (1, 256)).astype(np.float32)
        _, whole = filters.fir_apply(coeffs, jnp.asarray(x))
        hist = None
        parts = []
        for i in range(0, 256, 64):
            hist, y = filters.fir_apply(coeffs, jnp.asarray(x[:, i:i + 64]),
                                        hist)
            parts.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(parts, -1),
                                   np.asarray(whole), atol=1e-5)


class TestSyncRatioEquivalence:
    def test_blocksum_equals_conv(self):
        # the fast block-sum sync correlation must equal the conv oracle
        import jax.numpy as jnp

        from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                      FSKParams)
        from webaudio_modem.ops.fsk_demod import (_sync_ratios,
                                                      _sync_ratios_conv)

        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        rng = np.random.RandomState(5)
        # time-major [W + n_ds, B]
        ext = (rng.uniform(size=(params.sync_window + 137, 2)) > 0.5
               ).astype(np.float32)
        fast = np.asarray(_sync_ratios(params, jnp.asarray(ext)))
        ref = np.asarray(_sync_ratios_conv(params, jnp.asarray(ext)))
        np.testing.assert_allclose(fast, ref, atol=1e-6)

    def test_mxu_bit_identical_to_cumsum(self):
        # the MXU sync correlation (two exact bf16 integer matmuls)
        # must be BIT-identical to the cumsum block-sum fallback and
        # match the conv oracle, across configs and odd chunk shapes
        import jax.numpy as jnp

        from webaudio_modem.models.config import FSKConfig, FSKParams
        from webaudio_modem.ops.fsk_demod import (
            _sync_ratios_conv, _sync_ratios_cumsum, _sync_ratios_mxu)

        rng = np.random.RandomState(7)
        cases = [(300, 2400), (300, 137), (1200, 600), (1200, 1),
                 (1200, 3), (2400, 977)]
        for baud, n_ds in cases:
            params = FSKParams.from_config(FSKConfig(baud_rate=baud))
            ext = (rng.uniform(size=(params.sync_window + n_ds, 5)) > 0.5
                   ).astype(np.float32)
            mxu = np.asarray(_sync_ratios_mxu(params, jnp.asarray(ext)))
            cs = np.asarray(_sync_ratios_cumsum(params, jnp.asarray(ext)))
            assert np.array_equal(mxu, cs), (baud, n_ds)
            conv = np.asarray(_sync_ratios_conv(params, jnp.asarray(ext)))
            np.testing.assert_allclose(mxu, conv, atol=1e-6,
                                       err_msg=f"{baud} {n_ds}")

    def test_band_bit_identical_to_cumsum(self):
        # the single-matmul Toeplitz band form (the default dispatch)
        # must be BIT-identical to the cumsum fallback for any ds,
        # including bf16 bit planes (the planes the pipeline feeds it)
        import jax.numpy as jnp

        from webaudio_modem.models.config import FSKConfig, FSKParams
        from webaudio_modem.ops.fsk_demod import (
            _sync_ratios_band, _sync_ratios_cumsum)

        rng = np.random.RandomState(11)
        cases = [(300, 480), (300, 137), (1200, 600), (1200, 1),
                 (2400, 977), (45, 30)]
        for baud, n_ds in cases:
            params = FSKParams.from_config(FSKConfig(baud_rate=baud))
            ext = (rng.uniform(size=(params.sync_window + n_ds, 5)) > 0.5
                   ).astype(np.float32)
            for dtype in (jnp.float32, jnp.bfloat16):
                band = np.asarray(_sync_ratios_band(
                    params, jnp.asarray(ext, dtype)))
                cs = np.asarray(_sync_ratios_cumsum(
                    params, jnp.asarray(ext, dtype)))
                assert np.array_equal(band, cs), (baud, n_ds, dtype)

    def test_from_r_bit_identical_to_cumsum(self):
        # stage C over carried sliding block sums (the fused-R path)
        # must equal the ext_bits formulations exactly
        import jax.numpy as jnp

        from webaudio_modem.models.config import FSKConfig, FSKParams
        from webaudio_modem.ops.fsk_demod import (
            _sync_ratios_cumsum, _sync_ratios_from_r)

        rng = np.random.RandomState(13)
        for baud, n_ds in [(300, 2400), (300, 137), (1200, 600),
                           (1200, 1), (2400, 977)]:
            params = FSKParams.from_config(FSKConfig(baud_rate=baud))
            ds = params.ds_samples_per_bit
            W = params.sync_window
            ext = (rng.uniform(size=(W + n_ds, 4)) > 0.5
                   ).astype(np.float32)
            cs = np.concatenate(
                [np.zeros((1, 4), np.float32), np.cumsum(ext, 0)], 0)
            idx = np.arange(ds, W + n_ds)
            r_ext = cs[idx + 1] - cs[idx + 1 - ds]
            ref = np.asarray(_sync_ratios_cumsum(params,
                                                 jnp.asarray(ext)))
            got = np.asarray(_sync_ratios_from_r(
                params,
                jnp.asarray(r_ext[:W - ds], jnp.bfloat16),
                jnp.asarray(r_ext[W - ds:], jnp.bfloat16)))
            assert np.array_equal(got, ref), (baud, n_ds)
