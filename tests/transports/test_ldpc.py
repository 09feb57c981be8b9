"""LDPC tests (the FEC memo's third algorithm family,
/root/reference/advanced-error-correction.md:162-165)."""

import numpy as np
import pytest

from webaudio_modem.ops.ldpc import LDPCCode, default_code


@pytest.fixture(scope="module")
def code():
    return default_code(n=120, wc=3, wr=6)   # small: k~62, fast tests


def _bpsk_llrs(codewords: np.ndarray, sigma: float,
               rng: np.random.RandomState) -> np.ndarray:
    tx = 1.0 - 2.0 * codewords.astype(np.float64)
    rx = tx + sigma * rng.standard_normal(tx.shape)
    return (2.0 * rx / sigma ** 2).astype(np.float32)


def test_construction_is_valid_and_deterministic(code):
    H = code.H
    assert (H.sum(axis=1) == code.wr).all()       # regular rows
    assert (H.sum(axis=0) == code.wc).all()       # regular columns
    # k = n - rank(H); Gallager bands are dependent so rank < m
    assert code.n - code.m <= code.k <= code.n - code.m + code.wc
    again = LDPCCode(n=120, wc=3, wr=6)
    np.testing.assert_array_equal(again.H, H)     # same seed search


def test_encode_satisfies_parity_checks(code):
    rng = np.random.RandomState(0)
    data = rng.randint(0, 2, size=(8, code.k))
    cw = np.asarray(code.encode_batch(data))
    assert cw.shape == (8, code.n)
    syndrome = (code.H.astype(np.int64) @ cw.T) % 2
    assert (syndrome == 0).all()
    # systematic recovery: data columns carry the data verbatim
    np.testing.assert_array_equal(
        cw[:, np.asarray(code._data_cols)], data)


def test_clean_and_noisy_decode(code):
    rng = np.random.RandomState(1)
    B = 16
    data = rng.randint(0, 2, size=(B, code.k))
    cw = np.asarray(code.encode_batch(data))
    # clean: huge LLRs, must be exact and ok
    llr = (1.0 - 2.0 * cw) * 20.0
    out, ok = code.decode_batch(llr.astype(np.float32))
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), data)
    # AWGN at a comfortable operating point for rate 1/2 (~4 dB Eb/N0)
    ebn0_db = 4.0
    rate = code.k / code.n
    sigma = float(np.sqrt(1.0 / (2 * rate * 10 ** (ebn0_db / 10))))
    out, ok = code.decode_batch(_bpsk_llrs(cw, sigma, rng))
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), data)


def test_coding_gain_over_uncoded(code):
    # at an SNR where uncoded BPSK has visible bit errors, the decoder
    # returns every frame exactly
    rng = np.random.RandomState(2)
    B = 16
    data = rng.randint(0, 2, size=(B, code.k))
    cw = np.asarray(code.encode_batch(data))
    sigma = 0.7
    llrs = _bpsk_llrs(cw, sigma, rng)
    uncoded_bits = (llrs < 0).astype(np.int32)
    uncoded_errs = int((uncoded_bits != cw).sum())
    assert uncoded_errs > 20          # the channel is genuinely noisy
    out, ok = code.decode_batch(llrs)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), data)


def test_ok_flags_unconverged_garbage(code):
    rng = np.random.RandomState(3)
    llrs = rng.standard_normal((8, code.n)).astype(np.float32)
    _, ok = code.decode_batch(llrs)
    # random LLRs are (overwhelmingly) not near any codeword
    assert (~np.asarray(ok)).sum() >= 7


def test_mixed_batch_ok_mask(code):
    rng = np.random.RandomState(4)
    data = rng.randint(0, 2, size=(4, code.k))
    cw = np.asarray(code.encode_batch(data))
    llr = (1.0 - 2.0 * cw) * 10.0
    llr[2] = rng.standard_normal(code.n)          # one garbage channel
    out, ok = code.decode_batch(llr.astype(np.float32))
    ok = np.asarray(ok)
    assert ok[0] and ok[1] and ok[3] and not ok[2]
    np.testing.assert_array_equal(np.asarray(out)[[0, 1, 3]],
                                  data[[0, 1, 3]])


def test_default_648_code_end_to_end():
    code = default_code()                    # n=648, the advertised default
    assert code.n == 648 and code.k >= 324
    rng = np.random.RandomState(7)
    data = rng.randint(0, 2, size=(4, code.k))
    cw = np.asarray(code.encode_batch(data))
    assert ((code.H.astype(np.int64) @ cw.T) % 2 == 0).all()
    ebn0_db = 4.0
    rate = code.k / code.n
    sigma = float(np.sqrt(1.0 / (2 * rate * 10 ** (ebn0_db / 10))))
    out, ok = code.decode_batch(_bpsk_llrs(cw, sigma, rng))
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), data)


def test_ldpc_over_fsk_audio(soft_grid_search):
    """The memo's soft-value requirement end-to-end for LDPC: FSK
    audio -> soft discriminator LLRs -> min-sum decode.  The bit-grid
    offset is self-selecting: LDPC's own syndrome check validates the
    grid, playing the role the header CRC plays for conv frames."""
    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    code = default_code(n=120, wc=3, wr=6)
    rng = np.random.RandomState(9)
    data = rng.randint(0, 2, size=(1, code.k))
    cw = np.asarray(code.encode_batch(data))[0]

    def attempt(llr):
        # discriminator sign: positive soft = mark = bit 1, so the
        # LDPC llr (positive = bit 0) is the negation
        out_bits, ok = code.decode_batch(-llr[None].astype(np.float32))
        return np.asarray(out_bits)[0] if bool(np.asarray(ok)[0]) else None

    decoded, _ = soft_grid_search(params, cw, 0.08, rng, attempt)
    assert decoded is not None, "no grid offset produced a codeword"
    np.testing.assert_array_equal(decoded, data[0])


def test_input_validation(code):
    with pytest.raises(ValueError):
        code.encode_batch(np.zeros((2, code.k + 1)))
    with pytest.raises(ValueError):
        code.decode_batch(np.zeros((2, code.n - 1), np.float32))


class TestLdpcBodyMode:
    """LDPC as the soft frame path's BODY code (``body_code=`` on the
    encoders/decoders): the memo's stronger family riding the real
    framing pipeline — conv header for boundary detection, LDPC
    codewords for the payload."""

    @pytest.fixture(scope="class")
    def setup(self):
        from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                      FSKParams)
        from webaudio_modem.ops import soft_fsk

        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        code = default_code(n=648, wc=3, wr=6)
        rng = np.random.RandomState(0)
        payload = bytes(rng.randint(0, 256, size=40,
                                    dtype=np.int64).astype(np.uint8))
        return params, code, payload, soft_fsk

    def test_single_and_streaming_roundtrip(self, setup):
        params, code, payload, soft_fsk = setup
        rng = np.random.RandomState(3)
        sig = np.asarray(soft_fsk.encode_frame_signal(
            params, payload, body_code=code))
        assert len(sig) == soft_fsk.frame_signal_length(
            params, len(payload), body_code=code)
        noisy = (sig + 0.3 * rng.standard_normal(len(sig))
                 ).astype(np.float32)
        assert soft_fsk.decode_frame_signal(
            params, noisy, body_code=code) == payload
        # streaming: random splits decode identically (frames may span
        # chunk boundaries)
        chunks, i = [], 0
        while i < len(noisy):
            n = int(rng.randint(100, 3000))
            chunks.append(noisy[i:i + n])
            i += n
        assert soft_fsk.decode_frame_chunks(
            params, chunks, body_code=code) == [payload]

    def test_batch_path(self, setup):
        params, code, payload, soft_fsk = setup
        rng = np.random.RandomState(4)
        B = 8
        payloads = [bytes(rng.randint(0, 256, size=40, dtype=np.int64)
                          .astype(np.uint8)) for _ in range(B)]
        sigs = np.asarray(soft_fsk.encode_frames_batch(
            params, payloads, body_code=code))
        noisy = (sigs + 0.3 * rng.standard_normal(sigs.shape)
                 ).astype(np.float32)
        assert soft_fsk.decode_frames_batch(
            params, noisy, 40, body_code=code) == payloads

    def test_burst_recovers_only_with_ldpc(self, setup):
        """A 50-bit zeroed sample burst inside the body: the conv body
        (K=7) cannot bridge it, the LDPC body corrects it — the block
        code's burst-armor role, like the RS concatenated mode."""
        params, code, _, soft_fsk = setup
        payload = bytes(np.random.RandomState(2).randint(
            0, 256, size=40, dtype=np.int64).astype(np.uint8))
        spb = params.samples_per_bit
        start = (2 * spb
                 + (len(params.pattern_bits)
                    + soft_fsk.HEADER_CODED_BITS) * spb
                 + 50 * spb)
        got = {}
        for name, body_code in (("ldpc", code), ("conv", None)):
            sig = np.array(soft_fsk.encode_frame_signal(
                params, payload, body_code=body_code))
            sig[start:start + 50 * spb] = 0.0
            noise_rng = np.random.RandomState(7)
            sig = (sig + 0.05 * noise_rng.standard_normal(len(sig))
                   ).astype(np.float32)
            got[name] = soft_fsk.decode_frame_signal(
                params, sig, body_code=body_code)
        assert got["ldpc"] == payload
        assert got["conv"] is None

    def test_reset_preserves_codes(self, setup):
        params, code, payload, soft_fsk = setup
        dec = soft_fsk.SoftFrameDecoder(params, body_code=code)
        dec.reset()
        assert dec._body_code is code
        dec2 = soft_fsk.SoftFrameDecoder(params, rs_parity=8)
        dec2.reset()
        assert dec2._rs_parity == 8

    def test_rs_and_ldpc_are_exclusive(self, setup):
        params, code, payload, soft_fsk = setup
        with pytest.raises(ValueError):
            soft_fsk.encode_frame_signal(params, payload,
                                         rs_parity=4, body_code=code)
        with pytest.raises(ValueError):
            soft_fsk.decode_frames_batch(
                params, np.zeros((1, 4096), np.float32), 40,
                rs_parity=4, body_code=code)
