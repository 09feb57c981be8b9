"""Unit tests for the gather-free building blocks of the fused farm
soft decode (soft_fsk._decode_frames_fused).

These are the exact-equivalence contracts the round-3 fusion relies
on: the barrel-shift alignment must reproduce per-channel gathers, the
bit-serial device CRC must match the host table CRC, and the Viterbi
butterfly must equal the predecessor-table gather it replaced (the
latter is asserted structurally at trace time in fec._viterbi_core;
here we pin decode behavior end to end).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
from webaudio_modem.ops import fec, soft_fsk
from webaudio_modem.utils.crc16 import CRC16


class TestAlignedRows:
    def test_matches_numpy_gather(self):
        rng = np.random.RandomState(0)
        T, B, U = 200, 16, 37
        plane = rng.randn(T, B).astype(np.float32)
        base = rng.randint(0, T - U + 1, B).astype(np.int32)
        out = np.asarray(soft_fsk._aligned_rows(
            jnp.asarray(plane), jnp.asarray(base), U))
        ref = np.stack([plane[base[b]:base[b] + U, b] for b in range(B)],
                       axis=1)
        assert (out == ref).all()

    def test_zero_base_is_identity_prefix(self):
        plane = np.arange(40, dtype=np.float32).reshape(10, 4)
        out = np.asarray(soft_fsk._aligned_rows(
            jnp.asarray(plane), jnp.zeros(4, jnp.int32), 6))
        assert (out == plane[:6]).all()

    def test_short_plane_zero_pads(self):
        # T < U: the helper must zero-pad instead of failing the slice
        plane = np.ones((3, 4), np.float32)
        out = np.asarray(soft_fsk._aligned_rows(
            jnp.asarray(plane), jnp.zeros(4, jnp.int32), 5))
        assert out.shape == (5, 4)
        assert (out[:3] == 1.0).all() and (out[3:] == 0.0).all()

    def test_max_shift(self):
        # every channel at the maximum legal base
        rng = np.random.RandomState(1)
        T, B, U = 64, 8, 16
        plane = rng.randn(T, B).astype(np.float32)
        base = np.full(B, T - U, np.int32)
        out = np.asarray(soft_fsk._aligned_rows(
            jnp.asarray(plane), jnp.asarray(base), U))
        assert (out == plane[T - U:]).all()


class TestAlignedStrided:
    @pytest.mark.parametrize("ds", [1, 2, 16, 20])
    def test_matches_numpy_gather(self, ds):
        rng = np.random.RandomState(ds)
        n_out = 23
        T, B = n_out * ds + 175, 16
        plane = rng.randn(T, B).astype(np.float32)
        base = rng.randint(0, T - (n_out - 1) * ds - 1, B).astype(np.int32)
        out = np.asarray(soft_fsk._aligned_strided(
            jnp.asarray(plane), jnp.asarray(base), n_out, ds))
        ref = np.stack([plane[base[b] + np.arange(n_out) * ds, b]
                        for b in range(B)], axis=1)
        assert (out == ref).all()

    def test_max_base(self):
        ds, n_out = 20, 7
        T, B = 200, 8
        rng = np.random.RandomState(2)
        plane = rng.randn(T, B).astype(np.float32)
        base = np.full(B, T - (n_out - 1) * ds - 1, np.int32)
        out = np.asarray(soft_fsk._aligned_strided(
            jnp.asarray(plane), jnp.asarray(base), n_out, ds))
        ref = np.stack([plane[base[b] + np.arange(n_out) * ds, b]
                        for b in range(B)], axis=1)
        assert (out == ref).all()

    def test_equals_dense_window_stride(self):
        # the form it replaced in _batch_body_stage: full-window
        # alignment followed by a ds-strided slice
        rng = np.random.RandomState(3)
        ds, n_out = 20, 30
        T, B = 1000, 32
        plane = rng.randn(T, B).astype(np.float32)
        U = (n_out - 1) * ds + 1
        base = rng.randint(0, T - U, B).astype(np.int32)
        dense = np.asarray(soft_fsk._aligned_rows(
            jnp.asarray(plane), jnp.asarray(base), U))[::ds]
        strided = np.asarray(soft_fsk._aligned_strided(
            jnp.asarray(plane), jnp.asarray(base), n_out, ds))
        assert (strided == dense).all()


class TestDeviceCRC16:
    @pytest.mark.parametrize("nbytes", [1, 2, 9, 16, 32])
    def test_matches_table_crc(self, nbytes):
        rng = np.random.RandomState(nbytes)
        data = rng.randint(0, 256, (17, nbytes), dtype=np.uint8)
        bits = np.unpackbits(data, axis=-1)
        dev = np.asarray(soft_fsk._crc16_bits_device(jnp.asarray(bits)))
        ref = np.array([CRC16.calculate(bytes(r)) for r in data])
        assert (dev == ref).all()

    def test_reference_vectors(self):
        # the reference suite's vectors (crc16.node.test.ts:12-61)
        for data, want in ((b"A", 0xB915), (b"123456789", 0x29B1),
                           (b"\x00", 0xE1F0), (b"\xff", 0xFF00)):
            bits = np.unpackbits(np.frombuffer(data, np.uint8))
            got = int(np.asarray(
                soft_fsk._crc16_bits_device(jnp.asarray(bits))))
            assert got == want, data


class TestViterbiButterfly:
    def test_roundtrip_random_payloads(self):
        rng = np.random.RandomState(3)
        for n_bits in (8, 33, 120):
            bits = rng.randint(0, 2, (5, n_bits)).astype(np.uint8)
            coded = fec.conv_encode_bits_batch(bits)
            soft = coded.astype(np.float32) * 2.0 - 1.0
            dec = fec.viterbi_decode_soft(soft, n_bits)
            assert (dec == bits).all()

    def test_corrects_burst_errors(self):
        rng = np.random.RandomState(4)
        bits = rng.randint(0, 2, 64).astype(np.uint8)
        coded = fec.conv_encode_bits(bits).astype(np.float32) * 2 - 1
        coded[10:14] = -coded[10:14]          # 4-bit burst flip
        dec = fec.viterbi_decode_soft(coded, 64)
        assert (dec == bits).all()


class TestFusedDecode:
    def test_packed_ok_column_and_erasures(self):
        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        payloads = [bytes((i * 13 + k) & 0xFF for k in range(9))
                    for i in range(8)]
        sigs = soft_fsk.encode_frames_batch(params, payloads)
        noisy = np.array(sigs, np.float32)    # writable copy
        noisy[3] = 0.0                        # erase one channel
        out = soft_fsk.decode_frames_batch(params, noisy, 9)
        assert out[3] is None
        for i in (0, 1, 2, 4, 5, 6, 7):
            assert out[i] == payloads[i]


class TestHeaderTopK:
    """Differential pin of the alignment-score candidate pruning
    (soft_fsk.HEADER_TOP_K) against the full-grid header search.

    The pruned path decodes only the top-k grid offsets by windowed-
    |LLR| coherence; the contract is payload-byte agreement per
    channel — WHICH offset validates may differ (best-scoring vs
    first-in-grid-order), both being CRC-checked headers of the same
    frame."""

    @staticmethod
    def _batch(rng, n, payload_len, sigma):
        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        payloads = [bytes(rng.randint(0, 256, payload_len,
                                      dtype=np.uint8))
                    for _ in range(n)]
        sigs = np.asarray(soft_fsk.encode_frames_batch(params, payloads))
        noisy = (sigs + sigma * rng.standard_normal(sigs.shape)) \
            .astype(np.float32)
        return params, payloads, noisy

    @staticmethod
    def _decode(params, noisy, payload_len, top_k):
        packed = np.asarray(soft_fsk._decode_frames_fused(
            params, jnp.asarray(noisy), payload_len, top_k=top_k))
        return [bytes(packed[b, :payload_len])
                if packed[b, payload_len] else None
                for b in range(len(packed))]

    def test_clean_and_moderate_noise_payloads_identical(self):
        rng = np.random.RandomState(11)
        for sigma in (0.0, 0.05):
            params, payloads, noisy = self._batch(rng, 16, 9, sigma)
            pruned = self._decode(params, noisy, 9, None)
            full = self._decode(params, noisy, 9, 0)
            assert pruned == payloads
            assert full == payloads

    def test_near_cliff_success_parity(self):
        # heavy noise: some frames erase in both forms; the pruned
        # form must not lose more than a hair vs the full grid, and
        # every successful decode must be the true payload
        rng = np.random.RandomState(23)
        params, payloads, noisy = self._batch(rng, 48, 9, 0.45)
        pruned = self._decode(params, noisy, 9, None)
        full = self._decode(params, noisy, 9, 0)
        ok_p = sum(p == t for p, t in zip(pruned, payloads))
        ok_f = sum(p == t for p, t in zip(full, payloads))
        for got, true in ((pruned, payloads), (full, payloads)):
            for g, t in zip(got, true):
                assert g is None or g == t  # CRC gate: no wrong bytes
        # both forms must be in the partially-decoding regime for the
        # comparison to mean anything
        assert 0 < ok_f
        assert ok_p >= ok_f - 2, (ok_p, ok_f)

    def test_valid_mask_gates_pruning(self):
        # a stream too short for any body span: every candidate is
        # invalid, pruning must yield all-None (not garbage ranks)
        rng = np.random.RandomState(5)
        params, payloads, noisy = self._batch(rng, 4, 9, 0.0)
        T_hdr = (soft_fsk.HEADER_CODED_BITS + 8) \
            * params.ds_samples_per_bit * params.downsample_ratio
        short = noisy[:, :T_hdr]
        out = soft_fsk.decode_frames_batch(params, short, 9)
        assert out == [None] * 4


class TestHeaderStageBitsOptional:
    def test_bits_none_with_rsum_matches(self):
        # with rsum given, the header stage reads sync from it and the
        # shape from softs: bits=None must give outputs identical to
        # the bits-given call
        from webaudio_modem.ops import fsk_demod

        rng = np.random.RandomState(31)
        params, payloads, noisy = TestHeaderTopK._batch(rng, 8, 9, 0.05)
        state = fsk_demod.init_state(params, batch=len(noisy))
        _, _, _, _, bits, _, softs, rsum = fsk_demod._sequential_stage(
            params, 0, state, jnp.asarray(noisy), with_rsum=True)
        body_bits_n = soft_fsk._body_coded_bits(9, 0, None)
        with_bits = soft_fsk._batch_header_stage(
            params, bits, softs, body_bits_n, 8, rsum)
        without = soft_fsk._batch_header_stage(
            params, None, softs, body_bits_n, 8, rsum)
        for a, b in zip(with_bits, without):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestHeaderStageCsumModes:
    def test_body_stage_full_plane_contract(self):
        # the body stage on a zero-prefixed cumsum plane decodes exactly
        # the LLR windows a per-element gather reads: Viterbi over
        # wsum[b_start + j*ds] for every body bit j
        from webaudio_modem.ops import fec, fsk_demod

        rng = np.random.RandomState(39)
        params, payloads, noisy = TestHeaderTopK._batch(rng, 8, 9, 0.05)
        state = fsk_demod.init_state(params, batch=len(noisy))
        _, _, _, _, _, _, softs, _ = fsk_demod._sequential_stage(
            params, 0, state, jnp.asarray(noisy), with_rsum=True)
        full = soft_fsk._csum0(softs)
        b_starts = rng.randint(0, 40, softs.shape[1]).astype(np.int32)
        got = soft_fsk._batch_body_stage(params, full, jnp.asarray(
            b_starts), 9, 0, None)
        ds = params.ds_samples_per_bit
        body_bits = soft_fsk._body_coded_bits(9)
        c = np.asarray(full)
        wsum = np.float32(params.polarity) * (c[ds:] - c[:-ds])
        rows = b_starts[None, :] + (np.arange(body_bits) * ds)[:, None]
        llr = np.take_along_axis(wsum, rows, 0).T          # [B, body]
        exp = fec._viterbi_core(
            jnp.asarray(llr.reshape(len(b_starts), body_bits // 2, 2)),
            8 * (9 + 2))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))


class TestHeaderSelectionExact:
    def test_topk_llrs_equal_gather(self):
        # the top-k one-hot contraction selects LLR windows exactly (a
        # TF32 matmul would round them): every valid candidate's LLRs
        # equal a host gather of the same csum plane
        from webaudio_modem.ops import fsk_demod

        rng = np.random.RandomState(43)
        params, payloads, noisy = TestHeaderTopK._batch(rng, 8, 9, 0.05)
        state = fsk_demod.init_state(params, batch=len(noisy))
        out = fsk_demod._sequential_stage(
            params, 0, state, jnp.asarray(noisy), with_rsum=True)
        body_n = soft_fsk._body_coded_bits(9)
        t_peak, peak_ok, csum, _, _, _ = soft_fsk._batch_header_stage(
            params, out[4], out[6], body_n, 8, out[7])
        starts, h_llr, valid = soft_fsk._candidate_llrs(
            params, csum, t_peak, peak_ok, body_n, 8)
        c, starts = np.asarray(csum), np.asarray(starts)
        h_llr, valid = np.asarray(h_llr), np.asarray(valid)
        ds = params.ds_samples_per_bit
        wsum = np.float32(params.polarity) * (c[ds:] - c[:-ds])
        b, k = np.nonzero(valid)
        assert len(b) > 0
        rows = starts[b, k][:, None] + \
            (np.arange(soft_fsk.HEADER_CODED_BITS) * ds)[None, :]
        np.testing.assert_array_equal(h_llr[b, k],
                                      wsum[rows, b[:, None]])


class TestDeviceFrameSynthesis:
    """frames_synth_device_fn == encode_frames_batch, bit-exact in
    sample values: same int32 phase accumulators (MXU triangular-
    matmul ones-prefix), same f32 sin expansion (round-5 TX upload
    elimination — the soft hubs launch cohorts from a [B, pl] byte
    upload instead of host-framed phase tables)."""

    def test_matches_host_framing_exactly(self):
        from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                      FSKConfig)

        rng = np.random.RandomState(11)
        for cfg in (DEFAULT_FSK_CONFIG,
                    FSKConfig(baud_rate=300, mark_frequency=1270,
                              space_frequency=1070)):
            params = FSKParams.from_config(cfg)
            for pl in (1, 46):
                B = 8
                payloads = [bytes(rng.randint(0, 256, pl,
                                              dtype=np.uint8))
                            for _ in range(B)]
                host = np.asarray(
                    soft_fsk.encode_frames_batch(params, payloads))
                fn = soft_fsk.frames_synth_device_fn(params, pl)
                pay = np.frombuffer(b"".join(payloads), np.uint8) \
                    .reshape(B, pl)
                dev = np.asarray(fn(jnp.asarray(pay)))
                np.testing.assert_array_equal(host, dev)

    def test_non_integer_config_falls_back(self):
        from webaudio_modem.models.config import FSKConfig

        params = FSKParams.from_config(
            FSKConfig(mark_frequency=1650.5))
        assert soft_fsk.frames_synth_device_fn(params, 4) is None
