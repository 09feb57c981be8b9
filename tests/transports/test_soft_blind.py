"""Blind batched streaming soft receiver (ops/soft_blind.py).

The contract under test is the reference's acquisition model
(fsk.ts:297-315 — sync is DISCOVERY): the receiver gets only audio,
chunked in fixed quanta; frame positions, lengths and counts are never
provided.  Payload recovery must be exact (CRC-gated; failures are
erasures, never corruption).
"""

import numpy as np
import pytest

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
from webaudio_modem.ops import soft_fsk
from webaudio_modem.ops.soft_blind import BlindSoftBatchReceiver

QUANTUM = 4800


def _params():
    return FSKParams.from_config(DEFAULT_FSK_CONFIG)


def _place(rng, B, payloads_per_ch, gap_lo=2000, gap_hi=9000,
           sigma=0.0, params=None, rs_parity=0, body_code=None):
    """Build a [B, T] stream: per channel, frames at RANDOM offsets
    with random silence gaps — no alignment to quanta, bits, or other
    channels.  Returns (stream, expected: list of per-channel payload
    lists in temporal order)."""
    params = params or _params()
    sigs = {}
    rows = []
    expected = []
    for b in range(B):
        cursor = int(rng.randint(gap_lo, gap_hi))
        parts = [np.zeros(cursor, np.float32)]
        exp = []
        for pl in payloads_per_ch[b]:
            key = bytes(pl)
            if key not in sigs:
                sigs[key] = np.asarray(soft_fsk.encode_frame_signal(
                    params, pl, rs_parity=rs_parity,
                    body_code=body_code), np.float32)
            parts.append(sigs[key])
            gap = int(rng.randint(gap_lo, gap_hi))
            parts.append(np.zeros(gap, np.float32))
            exp.append(pl)
        rows.append(np.concatenate(parts))
        expected.append(exp)
    T = max(len(r) for r in rows)
    T = -(-T // QUANTUM) * QUANTUM
    stream = np.zeros((B, T), np.float32)
    for b, r in enumerate(rows):
        stream[b, :len(r)] = r
    if sigma:
        stream = stream + sigma * rng.standard_normal(stream.shape) \
            .astype(np.float32)
    return stream, expected


def _run(rx, stream):
    """Feed the whole stream quantum by quantum, then flush; returns
    per-channel decoded payload lists in completion order."""
    B, T = stream.shape
    got = [[] for _ in range(B)]
    for off in range(0, T, QUANTUM):
        for ch, pl in rx.feed(stream[:, off:off + QUANTUM]):
            got[ch].append(pl)
    for ch, pl in rx.flush():
        got[ch].append(pl)
    return got


class TestBlindAcquisition:
    def test_random_offsets_no_hints(self):
        rng = np.random.RandomState(7)
        B = 6
        payloads = [[bytes(rng.randint(0, 256, 9, dtype=np.uint8))]
                    for _ in range(B)]
        stream, exp = _place(rng, B, payloads)
        rx = BlindSoftBatchReceiver(_params(), B, QUANTUM,
                                    max_payload=16)
        got = _run(rx, stream)
        assert got == exp
        assert rx.frames_decoded == B
        assert rx.dropped_ring == 0

    def test_mixed_lengths_from_headers(self):
        # lengths differ per channel and are NOT given to the
        # receiver: they must come from each frame's decoded header
        rng = np.random.RandomState(3)
        B = 5
        lens = [1, 4, 9, 17, 33]
        payloads = [[bytes(rng.randint(0, 256, n, dtype=np.uint8))]
                    for n in lens]
        stream, exp = _place(rng, B, payloads)
        rx = BlindSoftBatchReceiver(_params(), B, QUANTUM,
                                    max_payload=64)
        got = _run(rx, stream)
        assert got == exp

    def test_multiple_frames_per_channel(self):
        rng = np.random.RandomState(11)
        B = 4
        payloads = [[bytes(rng.randint(0, 256, 7, dtype=np.uint8))
                     for _ in range(3)] for _ in range(B)]
        stream, exp = _place(rng, B, payloads)
        rx = BlindSoftBatchReceiver(_params(), B, QUANTUM,
                                    max_payload=16)
        got = _run(rx, stream)
        assert got == exp
        assert rx.frames_decoded == 3 * B

    def test_jittered_timing_defeats_scheduling(self):
        # per-channel jitter larger than a whole quantum: any receiver
        # relying on a shared TX schedule would slice the wrong
        # window, a blind one must not care
        rng = np.random.RandomState(19)
        B = 6
        payloads = [[bytes(rng.randint(0, 256, 9, dtype=np.uint8))]
                    for _ in range(B)]
        stream, exp = _place(rng, B, payloads,
                             gap_lo=100, gap_hi=6 * QUANTUM)
        rx = BlindSoftBatchReceiver(_params(), B, QUANTUM,
                                    max_payload=16)
        got = _run(rx, stream)
        assert got == exp

    def test_noisy_channel_decodes_exact(self):
        rng = np.random.RandomState(5)
        B = 6
        payloads = [[bytes(rng.randint(0, 256, 9, dtype=np.uint8))]
                    for _ in range(B)]
        stream, exp = _place(rng, B, payloads, sigma=0.1)
        rx = BlindSoftBatchReceiver(_params(), B, QUANTUM,
                                    max_payload=16)
        got = _run(rx, stream)
        assert got == exp

    def test_heavy_noise_erases_never_corrupts(self):
        rng = np.random.RandomState(13)
        B = 8
        payloads = [[bytes(rng.randint(0, 256, 9, dtype=np.uint8))]
                    for _ in range(B)]
        stream, exp = _place(rng, B, payloads, sigma=0.55)
        rx = BlindSoftBatchReceiver(_params(), B, QUANTUM,
                                    max_payload=16)
        got = _run(rx, stream)
        for b in range(B):
            for pl in got[b]:     # CRC gate: anything decoded is true
                assert pl in exp[b]

    def test_silence_only_no_events(self):
        B = 4
        rx = BlindSoftBatchReceiver(_params(), B, QUANTUM,
                                    max_payload=16)
        for _ in range(6):
            assert rx.feed(np.zeros((B, QUANTUM), np.float32)) == []
        assert rx.flush() == []
        assert rx.events_detected == 0
        assert rx.frames_decoded == 0

    def test_frame_spanning_quantum_boundary(self):
        # force sync peaks right at a quantum edge: lead silence of
        # exactly quantum - W/2 samples
        params = _params()
        rng = np.random.RandomState(23)
        B = 4
        pls = [bytes(rng.randint(0, 256, 9, dtype=np.uint8))
               for _ in range(B)]
        sig = [np.asarray(soft_fsk.encode_frame_signal(params, p),
                          np.float32) for p in pls]
        lead = QUANTUM - params.sync_window * params.downsample_ratio // 2
        T = -(-(lead + max(len(s) for s in sig)) // QUANTUM) * QUANTUM
        stream = np.zeros((B, T + QUANTUM), np.float32)
        for b, s in enumerate(sig):
            stream[b, lead:lead + len(s)] = s
        rx = BlindSoftBatchReceiver(params, B, QUANTUM, max_payload=16)
        got = _run(rx, stream)
        assert got == [[p] for p in pls]

    def test_matches_streaming_single_channel_decoder(self):
        # differential: the batched blind receiver and the
        # single-channel streaming decoder must recover the same
        # payloads from the same signals
        rng = np.random.RandomState(29)
        B = 4
        payloads = [[bytes(rng.randint(0, 256, 9, dtype=np.uint8))
                     for _ in range(2)] for _ in range(B)]
        stream, exp = _place(rng, B, payloads, sigma=0.05)
        params = _params()
        rx = BlindSoftBatchReceiver(params, B, QUANTUM, max_payload=16)
        got = _run(rx, stream)
        for b in range(B):
            dec = soft_fsk.SoftFrameDecoder(params)
            single = dec.feed(stream[b])
            assert got[b] == single == exp[b]


class TestBlindBodyCodes:
    """The blind receiver's pluggable body paths (the header stays
    conv-coded, so acquisition is identical; only the per-length body
    program changes)."""

    def test_ldpc_body(self):
        from webaudio_modem.ops.ldpc import default_code
        code = default_code()
        rng = np.random.RandomState(31)
        B = 4
        payloads = [[bytes(rng.randint(0, 256, 9, dtype=np.uint8))]
                    for _ in range(B)]
        stream, exp = _place(rng, B, payloads, sigma=0.05,
                             body_code=code)
        rx = BlindSoftBatchReceiver(_params(), B, QUANTUM,
                                    max_payload=16, body_code=code)
        assert _run(rx, stream) == exp

    def test_rs_concatenated(self):
        rng = np.random.RandomState(37)
        B = 4
        payloads = [[bytes(rng.randint(0, 256, 9, dtype=np.uint8))]
                    for _ in range(B)]
        stream, exp = _place(rng, B, payloads, sigma=0.05, rs_parity=4)
        rx = BlindSoftBatchReceiver(_params(), B, QUANTUM,
                                    max_payload=16, rs_parity=4)
        assert _run(rx, stream) == exp

    def test_mixed_lengths_ldpc(self):
        # length still comes from the decoded header in body-code mode
        from webaudio_modem.ops.ldpc import default_code
        code = default_code()
        rng = np.random.RandomState(41)
        lens = [3, 9, 21]
        payloads = [[bytes(rng.randint(0, 256, n, dtype=np.uint8))]
                    for n in lens]
        stream, exp = _place(rng, len(lens), payloads, body_code=code)
        rx = BlindSoftBatchReceiver(_params(), len(lens), QUANTUM,
                                    max_payload=32, body_code=code)
        assert _run(rx, stream) == exp


class TestBlindConstruction:
    def test_quantum_must_divide(self):
        with pytest.raises(ValueError):
            BlindSoftBatchReceiver(_params(), 2, QUANTUM + 1)

    def test_ring_must_hold_max_payload(self):
        with pytest.raises(ValueError):
            BlindSoftBatchReceiver(_params(), 2, QUANTUM,
                                   ring_quanta=4, max_payload=133)

    def test_feed_shape_checked(self):
        rx = BlindSoftBatchReceiver(_params(), 2, QUANTUM,
                                    max_payload=16)
        with pytest.raises(ValueError):
            rx.feed(np.zeros((2, QUANTUM // 2), np.float32))
