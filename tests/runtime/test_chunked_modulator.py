"""ChunkedModulator tests (reference tests/webaudio/chunked-modulator.node.test.ts)."""

import numpy as np
import pytest

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem.models.fsk import FSKCore
from webaudio_modem.runtime import ChunkedModulator


@pytest.fixture(scope="module")
def core():
    return FSKCore(DEFAULT_FSK_CONFIG)


def test_chunk_stream_equals_direct_signal(core):
    # reference chunked-modulator.node.test.ts:25-47
    data = b"Hi"
    direct = np.asarray(core.modulate_data(data))
    cm = ChunkedModulator(core)
    cm.start_modulation(data)
    chunks = []
    while True:
        r = cm.get_next_samples(128)
        if r is None:
            break
        chunks.append(r.signal)
        if r.is_complete:
            break
    streamed = np.concatenate(chunks)
    np.testing.assert_array_equal(streamed, direct)


def test_chunking_invariants(core):
    cm = ChunkedModulator(core)
    cm.start_modulation(b"A")
    total = None
    consumed = 0
    while True:
        r = cm.get_next_samples(128)
        if r is None:
            break
        assert len(r.signal) <= 128
        total = r.total_samples
        consumed = r.samples_consumed
        if r.is_complete:
            break
    assert consumed == total


def test_progress_and_is_modulating(core):
    cm = ChunkedModulator(core)
    assert not cm.is_modulating()
    assert cm.get_progress() == 0.0
    cm.start_modulation(b"A")
    assert cm.is_modulating()
    cm.get_next_samples(128)
    assert 0.0 < cm.get_progress() < 1.0


def test_cancel(core):
    cm = ChunkedModulator(core)
    cm.start_modulation(b"A")
    cm.cancel()
    assert not cm.is_modulating()
    assert cm.get_next_samples(128) is None


def test_empty_data_resets(core):
    # reference chunked-modulator.ts:31-39
    cm = ChunkedModulator(core)
    cm.start_modulation(b"")
    assert not cm.is_modulating()


def test_restart(core):
    cm = ChunkedModulator(core)
    cm.start_modulation(b"A")
    cm.get_next_samples(128)
    cm.start_modulation(b"B")
    assert cm.get_progress() == 0.0


def test_chunked_output_demodulates(core):
    # reference chunked-modulator.node.test.ts:222-250
    data = b"OK"
    cm = ChunkedModulator(core)
    cm.start_modulation(data)
    out = b""
    core2 = FSKCore(DEFAULT_FSK_CONFIG)
    while True:
        r = cm.get_next_samples(128)
        if r is None:
            break
        buf = np.zeros(128, np.float32)
        buf[:len(r.signal)] = r.signal
        out += core2.demodulate_data(buf)
        if r.is_complete:
            break
    # trailing flush
    for _ in range(4):
        out += core2.demodulate_data(np.zeros(128, np.float32))
    assert out == data
