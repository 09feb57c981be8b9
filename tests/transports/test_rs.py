"""Reed-Solomon codec tests (the FEC memo's block-code branch,
/root/reference/advanced-error-correction.md:157-160).

The encoder is checked against the code's DEFINING property (every
generator root is a codeword root) and an independent host-side
polynomial-division remainder; the decoder against the correction
radius: any <= t symbol errors are corrected exactly, beyond-radius
corruption is flagged, bursts split across an interleaver correct."""

import numpy as np
import pytest

from webaudio_modem.ops import gf256, rs


def _poly_div_remainder(data: np.ndarray, n: int, k: int) -> np.ndarray:
    """Independent remainder of data(x) * x^r mod g(x) (host, scalar
    long division) — the systematic parity definition."""
    r = n - k
    g = rs.generator_poly(r)
    buf = np.concatenate([np.asarray(data, np.int32),
                          np.zeros(r, np.int32)])
    for i in range(k):
        lead = buf[i]
        if lead:
            buf[i:i + r + 1] ^= gf256.np_mul(lead, g)
    return buf[k:]


def test_gf256_tables_are_a_field():
    exp, log = gf256.tables()
    # alpha generates the full multiplicative group
    assert len(set(exp[:255].tolist())) == 255
    a = np.arange(1, 256)
    assert np.all(gf256.np_mul(a, gf256.np_inv(a)) == 1)
    # distributivity spot check against bit-serial multiplication
    def slow_mul(x, y):
        acc = 0
        while y:
            if y & 1:
                acc ^= x
            x <<= 1
            if x & 0x100:
                x ^= gf256.PRIM_POLY
            y >>= 1
        return acc
    rng = np.random.RandomState(0)
    for _ in range(50):
        x, y = int(rng.randint(256)), int(rng.randint(256))
        assert int(gf256.np_mul(x, y)) == slow_mul(x, y)


@pytest.mark.parametrize("n,k", [(255, 223), (32, 24), (64, 48)])
def test_rs_encode_parity_definition(n, k):
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, size=(4, k))
    code = np.asarray(rs.rs_encode_batch(data, n, k))
    # systematic: data prefix intact
    np.testing.assert_array_equal(code[:, :k], data)
    # parity equals the long-division remainder
    for b in range(data.shape[0]):
        np.testing.assert_array_equal(code[b, k:],
                                      _poly_div_remainder(data[b], n, k))
    # defining property: codeword(alpha^j) == 0 for every g root
    exp, _ = gf256.tables()
    for b in range(data.shape[0]):
        for j in range(n - k):
            x = exp[j % 255]
            acc = 0
            for c in code[b]:
                acc = gf256.np_mul(acc, x) ^ int(c)
            assert acc == 0


@pytest.mark.parametrize("n,k", [(255, 223), (32, 24)])
def test_rs_corrects_up_to_t_errors(n, k):
    t = (n - k) // 2
    rng = np.random.RandomState(2)
    B = 6
    data = rng.randint(0, 256, size=(B, k))
    code = np.asarray(rs.rs_encode_batch(data, n, k))
    recv = code.copy()
    n_inj = []
    for b in range(B):
        e = b % (t + 1)                 # 0..t errors per channel
        n_inj.append(e)
        pos = rng.choice(n, size=e, replace=False)
        for p in pos:
            recv[b, p] ^= 1 + rng.randint(255)
    corrected, ok, n_fix = rs.rs_decode_batch(recv, n, k)
    np.testing.assert_array_equal(np.asarray(corrected), code)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(n_fix), n_inj)


def test_rs_detects_beyond_radius():
    n, k = 32, 24                        # t = 4
    rng = np.random.RandomState(3)
    data = rng.randint(0, 256, size=(8, k))
    code = np.asarray(rs.rs_encode_batch(data, n, k))
    recv = code.copy()
    for b in range(8):
        pos = rng.choice(n, size=9, replace=False)   # > 2t: undecodable
        for p in pos:
            recv[b, p] ^= 1 + rng.randint(255)
    corrected, ok, _ = rs.rs_decode_batch(recv, n, k)
    corrected = np.asarray(corrected)
    ok = np.asarray(ok)
    # every channel is either flagged or (vanishingly rare) miscorrected
    # to a DIFFERENT codeword; it must never claim ok with the original
    # data silently wrong unless it moved to a valid codeword
    for b in range(8):
        if ok[b]:
            # must at least be a self-consistent codeword
            re_enc = np.asarray(
                rs.rs_encode_batch(corrected[b:b + 1, :k], n, k))
            np.testing.assert_array_equal(re_enc[0], corrected[b])
    assert (~ok).sum() >= 6              # overwhelmingly detected


def test_rs_mixed_batch_matches_per_row():
    n, k = 64, 48
    rng = np.random.RandomState(4)
    data = rng.randint(0, 256, size=(5, k))
    code = np.asarray(rs.rs_encode_batch(data, n, k))
    recv = code.copy()
    recv[1, 3] ^= 0x55
    recv[3, 10] ^= 1
    recv[3, 40] ^= 9
    recv[4] = rng.randint(0, 256, size=n)           # garbage row
    full = [np.asarray(a) for a in rs.rs_decode_batch(recv, n, k)]
    for b in range(5):
        row = [np.asarray(a)
               for a in rs.rs_decode_batch(recv[b:b + 1], n, k)]
        np.testing.assert_array_equal(full[0][b], row[0][0])
        assert full[1][b] == row[1][0]
        assert full[2][b] == row[2][0]


def test_interleaver_roundtrip_and_burst_protection():
    n, k, depth = 32, 24, 4              # t = 4 per codeword
    rng = np.random.RandomState(5)
    B = 3
    data = rng.randint(0, 256, size=(B, depth, k))
    code = np.stack([np.asarray(rs.rs_encode_batch(data[:, d], n, k))
                     for d in range(depth)], axis=1)   # [B, depth, n]
    wire = np.asarray(rs.block_interleave(
        code.reshape(B, depth * n), depth))
    # roundtrip
    back = np.asarray(rs.block_deinterleave(wire, depth))
    np.testing.assert_array_equal(back, code.reshape(B, depth * n))
    # a contiguous burst of depth*t wire bytes -> <= t errors per word
    burst_at = 17
    wire_c = wire.copy()
    wire_c[:, burst_at:burst_at + depth * ((n - k) // 2)] ^= 0xA5
    deint = np.asarray(rs.block_deinterleave(wire_c, depth)
                       ).reshape(B, depth, n)
    for d in range(depth):
        corrected, ok, _ = rs.rs_decode_batch(deint[:, d], n, k)
        assert np.asarray(ok).all()
        np.testing.assert_array_equal(np.asarray(corrected)[:, :k],
                                      data[:, d])
    # the same burst WITHOUT interleaving overwhelms a single codeword
    plain = code.reshape(B, depth * n).copy()
    plain[:, burst_at:burst_at + depth * ((n - k) // 2)] ^= 0xA5
    hit = plain.reshape(B, depth, n)
    word = (burst_at // n)
    _, ok_plain, _ = rs.rs_decode_batch(hit[:, word], n, k)
    assert not np.asarray(ok_plain).any()


class TestConcatenatedSoftPath:
    """RS outer + convolutional inner over the batched FSK soft path
    (soft_fsk.encode_frames_batch / decode_frames_batch rs_parity)."""

    def _params(self):
        from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                      FSKParams)
        return FSKParams.from_config(DEFAULT_FSK_CONFIG)

    def test_clean_roundtrip(self):
        from webaudio_modem.ops import soft_fsk
        params = self._params()
        payloads = [bytes([i] * 11) for i in range(4)]
        sigs = np.asarray(soft_fsk.encode_frames_batch(
            params, payloads, rs_parity=8))
        assert sigs.shape[1] == soft_fsk.frame_signal_length(
            params, 11, rs_parity=8)
        out = soft_fsk.decode_frames_batch(params, sigs, 11, rs_parity=8)
        assert out == payloads

    def test_burst_recovers_only_with_rs(self):
        # a zeroed sample burst inside the body wipes several
        # consecutive coded bits: the inner Viterbi emits a short byte
        # burst that RS corrects; the plain conv frame is lost
        from webaudio_modem.ops import soft_fsk
        params = self._params()
        payloads = [bytes(range(20)), bytes(range(20, 40))]
        spb = params.samples_per_bit

        def hit(sig_batch, n_bits_burst):
            s = np.asarray(sig_batch).copy()
            body_start_bit = (2 + len(params.pattern_bits)
                              + soft_fsk.HEADER_CODED_BITS + 40)
            a = body_start_bit * spb
            s[:, a:a + n_bits_burst * spb] = 0.0
            return s

        burst_bits = 24                 # -> ~3-4 corrupted body bytes
        plain = hit(soft_fsk.encode_frames_batch(params, payloads),
                    burst_bits)
        out_plain = soft_fsk.decode_frames_batch(params, plain, 20)
        assert out_plain != payloads    # conv alone loses the frame

        coded = hit(soft_fsk.encode_frames_batch(params, payloads,
                                                 rs_parity=12),
                    burst_bits)
        out_rs = soft_fsk.decode_frames_batch(params, coded, 20,
                                              rs_parity=12)
        assert out_rs == payloads       # RS outer corrects the burst

    def test_single_and_streaming_paths_roundtrip(self):
        # the per-signal and chunked decoders speak the same
        # concatenated wire format as the batch path
        from webaudio_modem.ops import soft_fsk
        params = self._params()
        payload = bytes(range(17))
        sig = soft_fsk.encode_frame_signal(params, payload, rs_parity=8)
        # batch and single encoders produce the same frame layout
        batch_sig = np.asarray(soft_fsk.encode_frames_batch(
            params, [payload], rs_parity=8))[0]
        np.testing.assert_allclose(sig, batch_sig, atol=1e-4)
        assert soft_fsk.decode_frame_signal(params, sig,
                                            rs_parity=8) == payload
        # chunked: arbitrary split, frame spans the boundary
        chunks = [sig[:1000], sig[1000:7777], sig[7777:]]
        assert soft_fsk.decode_frame_chunks(params, chunks,
                                            rs_parity=8) == [payload]
        # cross-path: the batch decoder reads the single encoder's
        # signal (tiled) and vice versa
        out = soft_fsk.decode_frames_batch(
            params, np.stack([sig, sig]), len(payload), rs_parity=8)
        assert out == [payload, payload]

    def test_rs_parity_validation(self):
        from webaudio_modem.ops import soft_fsk
        params = self._params()
        with pytest.raises(ValueError):
            soft_fsk.encode_frames_batch(params, [b"x"], rs_parity=3)
        with pytest.raises(ValueError):
            soft_fsk.encode_frames_batch(params, [b"x" * 250],
                                         rs_parity=8)
        with pytest.raises(ValueError):
            soft_fsk.decode_frames_batch(params, np.zeros((1, 100),
                                                          np.float32),
                                         5, rs_parity=5)


def test_rs_input_validation():
    with pytest.raises(ValueError):
        rs.rs_encode_batch(np.zeros((2, 10)), 255, 10 + 1)  # wrong k
    with pytest.raises(ValueError):
        rs.rs_encode_batch(np.zeros((2, 200)), 255, 200)    # odd parity... 55
    with pytest.raises(ValueError):
        rs.rs_decode_batch(np.zeros((2, 10)), 255, 223)
    with pytest.raises(ValueError):
        rs.rs_encode_batch(np.zeros((2, 300)), 300, 200)    # n > 255
    with pytest.raises(ValueError):
        rs.block_interleave(np.zeros((2, 10)), 3)
