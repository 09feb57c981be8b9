"""Golden-model behavior tests: validate the bit-exact scalar comparator
against the reference's documented behavior (SURVEY.md §6).

These exercise the *oracle itself*; the batched demodulator is
differentially tested against it in test_fsk_demodulation.py.
"""

import numpy as np
import pytest

from webaudio_modem.golden import GoldenFSK
from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKConfig


def add_noise(signal, snr_db, rng):
    # reference noise model (fsk-demodulation.node.test.ts:1184-1196):
    # uniform noise with amplitude sqrt(3 * noise_power)
    power = float(np.mean(signal.astype(np.float64) ** 2))
    noise_power = power / (10 ** (snr_db / 10))
    amp = np.sqrt(3 * noise_power)
    noise = amp * (rng.uniform(size=len(signal)) * 2 - 1)
    return (signal + noise).astype(np.float32)


def test_roundtrip_exact_single_sync():
    # reference fsk-demodulation.node.test.ts:81-106
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = b"AB"
    out = m.demodulate(m.modulate(data))
    assert out == data
    assert m.sync_detections == 1


def test_roundtrip_hello_world():
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = b"Hello, World!"
    assert m.demodulate(m.modulate(data)) == data


@pytest.mark.parametrize("baud", [300, 1200])
def test_baud_rates(baud):
    m = GoldenFSK(FSKConfig(baud_rate=baud))
    data = b"\x48"
    assert m.demodulate(m.modulate(data)) == data


@pytest.mark.parametrize("mark,space", [(1650, 1850), (2125, 2295),
                                        (1270, 1070)])
def test_frequency_pairs(mark, space):
    # (1270, 1070) is BASELINE config 1 (mark > space); handled via the
    # polarity-aware slicer.
    m = GoldenFSK(FSKConfig(mark_frequency=mark, space_frequency=space))
    data = b"\x48"
    assert m.demodulate(m.modulate(data)) == data


def test_chunked_128_equals_whole():
    # reference fsk-demodulation.node.test.ts:363-398
    m1 = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = b"Hello"
    signal = m1.modulate(data)
    whole = m1.demodulate(signal)

    m2 = GoldenFSK(DEFAULT_FSK_CONFIG)
    out = b""
    for i in range(0, len(signal), 128):
        out += m2.demodulate(signal[i:i + 128])
    assert whole == data
    assert out == data


def test_silence_prefix():
    # reference fsk-demodulation.node.test.ts:400-437
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = b"\x42"
    signal = m.modulate(data)
    padded = np.concatenate([np.zeros(1000, np.float32), signal])
    assert m.demodulate(padded) == data


def test_noise_30db_exact():
    # reference fsk-demodulation.node.test.ts:182-197
    rng = np.random.RandomState(1234)
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = b"\x48\x65\x6c"
    noisy = add_noise(m.modulate(data), 30, rng)
    assert m.demodulate(noisy) == data


def test_low_amplitude_agc():
    # reference fsk-demodulation.node.test.ts:217-259 (0.1x amplitude)
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = b"\x42"
    signal = m.modulate(data) * np.float32(0.1)
    assert m.demodulate(signal) == data


def test_dc_offset_agc():
    # reference fsk-demodulation.node.test.ts:493-521 (+0.2 DC)
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = b"\x42"
    signal = (m.modulate(data) * 0.3 + 0.2).astype(np.float32)
    assert m.demodulate(signal) == data


def test_false_positive_silence():
    # reference fsk-false-positive.node.test.ts:13-69
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    assert m.demodulate(np.zeros(48000, np.float32)) == b""
    assert m.sync_detections == 0


def test_false_positive_dc():
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    assert m.demodulate(np.full(48000, 0.5, np.float32)) == b""


def test_false_positive_off_band_tone():
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    t = np.arange(48000) / 48000.0
    tone = np.sin(2 * np.pi * 400 * t).astype(np.float32)
    assert m.demodulate(tone) == b""


def test_false_positive_noise_at_most_one_byte():
    # reference fsk-false-positive.node.test.ts:93-112
    rng = np.random.RandomState(42)
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    noise = (rng.uniform(-1, 1, 48000)).astype(np.float32)
    assert len(m.demodulate(noise)) <= 1


def test_multi_transmission_with_eod():
    # reference fsk-demodulation.node.test.ts:854-925
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    gap = np.zeros(4800, np.float32)
    sig1 = m.modulate(b"\x11")
    sig2 = m.modulate(b"\x22")
    stream = np.concatenate([sig1, gap, sig2])
    out = m.demodulate(stream)
    assert out == b"\x11\x22"
    assert m.sync_detections == 2
    assert m.eod_events >= 1


def test_preamble_sfd_bytes_as_data():
    # reference fsk-sfd.node.test.ts:35-93
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = bytes([0x55, 0x7E, 0x55, 0x7E])
    assert m.demodulate(m.modulate(data)) == data
    assert m.sync_detections == 1


def test_determinism():
    # reference fsk-demodulation.node.test.ts:755-790
    data = b"determinism"
    outs = []
    for _ in range(3):
        m = GoldenFSK(DEFAULT_FSK_CONFIG)
        outs.append(m.demodulate(m.modulate(data)))
    assert outs[0] == outs[1] == outs[2] == data


def test_modulated_signal_length_formula():
    # reference fsk-modulation.node.test.ts:75-109
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    p = m.params
    data = b"xyz"
    total_bytes = len(DEFAULT_FSK_CONFIG.preamble_pattern) + \
        len(DEFAULT_FSK_CONFIG.sfd_pattern) + len(data)
    expected = (total_bytes * p.bits_per_byte * p.samples_per_bit
                + 2 * p.samples_per_bit
                + p.bits_per_byte * p.samples_per_bit)
    assert len(m.modulate(data)) == expected


@pytest.mark.parametrize("data", [b"\x3c", b"\x0f", b"\xf0"])
def test_phase_continuity(data):
    # reference fsk-modulation.node.test.ts:126-161 (max jump < 0.5, same
    # test bytes — the jump at the trailing-silence edge is data-dependent)
    m = GoldenFSK(DEFAULT_FSK_CONFIG)
    sig = m.modulate(data)
    jumps = np.abs(np.diff(sig.astype(np.float64)))
    assert jumps.max() < 0.5
