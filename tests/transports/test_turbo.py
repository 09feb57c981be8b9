"""Turbo code tests — the FEC memo's fourth algorithm family
(/root/reference/advanced-error-correction.md:167-169)."""

import numpy as np
import pytest

from webaudio_modem.ops.turbo import (M, TAIL, TurboCode, _tables,
                                          default_code)


@pytest.fixture(scope="module")
def code():
    return default_code(K=128, seed=0)


def _bpsk_llrs(cw, sigma, rng):
    tx = 1.0 - 2.0 * cw.astype(np.float64)
    rx = tx + sigma * rng.standard_normal(tx.shape)
    return (2.0 * rx / sigma ** 2).astype(np.float32)


def _rsc_scalar(bits):
    """Independent bit-by-bit RSC reference (feedback 1+D^2+D^3,
    forward 1+D+D^3) for trellis-table validation."""
    r = [0, 0, 0]                      # a_{t-1}, a_{t-2}, a_{t-3}
    par = []
    for d in bits:
        fb = r[1] ^ r[2]
        a = int(d) ^ fb
        par.append(a ^ r[0] ^ r[2])
        r = [a, r[0], r[1]]
    return np.asarray(par, np.int8), r


def test_trellis_matches_scalar_rsc():
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2, size=37)
    nxt, par, term, pred, pred_d, pred_p = _tables()
    s = 0
    out = []
    for d in bits:
        out.append(par[s, d])
        s = nxt[s, d]
    ref, _ = _rsc_scalar(bits)
    np.testing.assert_array_equal(np.asarray(out, np.int8), ref)
    # termination really zeroes the register from every state
    for s0 in range(8):
        s = s0
        for _ in range(M):
            s = nxt[s, term[s]]
        assert s == 0


def test_encode_layout_and_termination(code):
    rng = np.random.RandomState(1)
    data = rng.randint(0, 2, size=(4, code.K))
    cw = code.encode_batch(data)
    assert cw.shape == (4, 3 * code.K + 2 * TAIL)
    # systematic part is the data verbatim
    np.testing.assert_array_equal(cw[:, :code.K], data)
    # parity1 matches the scalar RSC on each row
    for b in range(4):
        ref, _ = _rsc_scalar(data[b])
        np.testing.assert_array_equal(cw[b, code.K:2 * code.K], ref)


def test_clean_and_noisy_decode(code):
    rng = np.random.RandomState(2)
    B = 8
    data = rng.randint(0, 2, size=(B, code.K))
    cw = code.encode_batch(data)
    # clean
    llr = ((1.0 - 2.0 * cw) * 15.0).astype(np.float32)
    out = np.asarray(code.decode_batch(llr))
    np.testing.assert_array_equal(out, data)
    # AWGN at 3 dB Eb/N0 (rate ~1/3) — comfortably above threshold
    rate = code.K / code.n
    sigma = float(np.sqrt(1.0 / (2 * rate * 10 ** (3.0 / 10))))
    out = np.asarray(code.decode_batch(_bpsk_llrs(cw, sigma, rng)))
    np.testing.assert_array_equal(out, data)


def test_coding_gain_over_uncoded(code):
    # a channel where uncoded BPSK is visibly wrong decodes exactly
    rng = np.random.RandomState(3)
    B = 8
    data = rng.randint(0, 2, size=(B, code.K))
    cw = code.encode_batch(data)
    sigma = 0.85
    llrs = _bpsk_llrs(cw, sigma, rng)
    uncoded = (llrs[:, :code.K] < 0).astype(np.int8)
    assert int((uncoded != data).sum()) > 15
    out = np.asarray(code.decode_batch(llrs))
    np.testing.assert_array_equal(out, data)


def test_deterministic_across_construction():
    a = TurboCode(K=64, seed=5)
    b = TurboCode(K=64, seed=5)
    np.testing.assert_array_equal(a.perm, b.perm)
    data = np.random.RandomState(4).randint(0, 2, size=(2, 64))
    np.testing.assert_array_equal(a.encode_batch(data),
                                  b.encode_batch(data))


def test_turbo_over_fsk_audio(code, soft_grid_search):
    """The memo's soft-value requirement end-to-end for turbo: FSK
    audio -> soft discriminator LLRs -> max-log-MAP decode.  Turbo has
    no intrinsic syndrome, so the documented layering applies: a CRC16
    inside the K data bits validates both the decode and the bit-grid
    offset (the role LDPC's syndrome plays in the sibling test)."""
    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
    from webaudio_modem.ops.fec import bits_to_bytes, bytes_to_bits
    from webaudio_modem.utils.crc16 import CRC16

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    rng = np.random.RandomState(11)
    payload = rng.randint(0, 256, size=code.K // 8 - 2,
                          dtype=np.int64).astype(np.uint8).tobytes()
    crc = CRC16.calculate(payload)
    frame = payload + bytes([crc >> 8, crc & 0xFF])
    data = bytes_to_bits(frame)[None]            # [1, K] MSB-first
    cw = np.asarray(code.encode_batch(data))[0]

    def attempt(llr):
        # positive soft = mark = bit 1; turbo LLRs are positive = bit 0
        out_bits = np.asarray(
            code.decode_batch(-llr[None].astype(np.float32)))[0]
        dec = bits_to_bytes(out_bits)
        if CRC16.calculate(dec[:-2]) == int.from_bytes(dec[-2:], "big"):
            return dec
        return None

    decoded, llr = soft_grid_search(params, cw, 0.6, rng, attempt)
    assert decoded is not None, "no grid offset passed the CRC"
    assert decoded == frame
    # the channel is genuinely corrupting: the winning grid's hard
    # decisions alone are visibly wrong
    assert int(((llr > 0).astype(np.int32) != cw).sum()) > 10


def test_input_validation(code):
    with pytest.raises(ValueError):
        code.encode_batch(np.zeros((2, code.K + 1), np.int8))
    with pytest.raises(ValueError):
        code.decode_batch(np.zeros((2, code.n - 1), np.float32))


class TestTurboBodyMode:
    """Turbo as the soft frame path's BODY code (``body_code=``):
    conv header for boundary detection, turbo codewords for the
    payload, the frame CRC16 as the gate (turbo has no syndrome)."""

    @pytest.fixture(scope="class")
    def setup(self):
        from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                      FSKParams)
        from webaudio_modem.ops import soft_fsk

        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        code = default_code(K=256)
        rng = np.random.RandomState(0)
        payload = bytes(rng.randint(0, 256, size=40,
                                    dtype=np.int64).astype(np.uint8))
        return params, code, payload, soft_fsk

    def test_single_and_streaming_roundtrip(self, setup):
        params, code, payload, soft_fsk = setup
        rng = np.random.RandomState(5)
        sig = np.asarray(soft_fsk.encode_frame_signal(
            params, payload, body_code=code))
        assert len(sig) == soft_fsk.frame_signal_length(
            params, len(payload), body_code=code)
        noisy = (sig + 0.3 * rng.standard_normal(len(sig))
                 ).astype(np.float32)
        assert soft_fsk.decode_frame_signal(
            params, noisy, body_code=code) == payload
        chunks, i = [], 0
        while i < len(noisy):
            n = int(rng.randint(100, 3000))
            chunks.append(noisy[i:i + n])
            i += n
        assert soft_fsk.decode_frame_chunks(
            params, chunks, body_code=code) == [payload]

    def test_batch_path(self, setup):
        params, code, payload, soft_fsk = setup
        rng = np.random.RandomState(6)
        B = 8
        payloads = [bytes(rng.randint(0, 256, size=40, dtype=np.int64)
                          .astype(np.uint8)) for _ in range(B)]
        sigs = np.asarray(soft_fsk.encode_frames_batch(
            params, payloads, body_code=code))
        noisy = (sigs + 0.3 * rng.standard_normal(sigs.shape)
                 ).astype(np.float32)
        assert soft_fsk.decode_frames_batch(
            params, noisy, 40, body_code=code) == payloads

    def test_rs_exclusive(self, setup):
        params, code, payload, soft_fsk = setup
        with pytest.raises(ValueError):
            soft_fsk.encode_frame_signal(params, payload,
                                         rs_parity=4, body_code=code)
