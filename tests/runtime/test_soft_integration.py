"""XModem ARQ over the SOFT FEC physical layer.

SoftModemCore gives the FEC memo's frame path (ops/soft_fsk.py) the
FSKCore shape, so the whole realtime stack — FSKProcessor audio
streaming, the simulated graph, the XModem transport — runs over it
unchanged.  The analog of test_integration.py with the hard UART modem
swapped for coded frames (reference contract src/core.ts:88-117: the
transport only ever sees the IDataChannel verbs)."""

import numpy as np
import pytest

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem.models.soft_modem import SoftModemCore
from webaudio_modem.sim import make_awgn_channel

from tests.runtime.conftest import arq_transfer as _transfer
from tests.runtime.conftest import make_arq_stack


def _make_stack(channel_fn=None, **core_kwargs):
    return make_arq_stack(
        channel_fn=channel_fn, timeout_ms=60000,
        core_factory=lambda: SoftModemCore(**core_kwargs))


class TestXModemOverSoftModem:
    async def test_hello_world_transfer(self):
        graph, sender, receiver = _make_stack()
        data = b"Hello, soft ARQ!"
        assert await _transfer(graph, sender, receiver, data) == data
        assert sender.get_statistics().bytes_transferred == len(data)

    async def test_multi_fragment_transfer(self):
        graph, sender, receiver = _make_stack()
        sender.configure({"max_payload_size": 32})
        data = bytes(range(80))  # 3 fragments
        assert await _transfer(graph, sender, receiver, data) == data
        assert sender.get_statistics().packets_sent >= 4  # 3 data + EOT

    async def test_transfer_with_ldpc_body(self):
        # the pluggable body code rides the whole stack too
        from webaudio_modem.ops.ldpc import default_code

        code = default_code(n=120, wc=3, wr=6)
        graph, sender, receiver = _make_stack(body_code=code)
        data = b"ldpc-coded ARQ"
        assert await _transfer(graph, sender, receiver, data) == data

    async def test_transfer_over_noisy_channel(self):
        # 10x the noise power of the hard-modem integration test
        # (test_integration.py uses 5e-4): ~10 dB SNR, comfortably
        # inside the soft path's margin (docs/FEC.md) — the ARQ still
        # sees a clean link
        graph, sender, receiver = _make_stack(
            channel_fn=make_awgn_channel(noise_power=5e-3, seed=3))
        data = b"coded frames under noise"
        assert await _transfer(graph, sender, receiver, data) == data


def test_core_surface_parity():
    """SoftModemCore serves the FSKCore duck-type the processor and
    ChunkedModulator rely on."""
    core = SoftModemCore(DEFAULT_FSK_CONFIG)
    assert core.is_ready() and core.params is not None
    sig = core.modulate_data(b"abc")
    assert isinstance(sig, np.ndarray) and sig.dtype == np.float32
    # stream the signal in odd chunks through the stateful decoder
    got = b""
    rng = np.random.RandomState(0)
    i = 0
    while i < len(sig):
        n = int(rng.randint(64, 700))
        got += core.demodulate_data(sig[i:i + n])
        i += n
    assert got == b"abc"
    status = core.get_status()
    assert status["frames_decoded"] == 1
    core.reset()
    assert core.get_status()["frames_decoded"] == 0


def test_signal_quality_surface():
    """The soft path serves the same computed SignalQuality surface:
    the decoder captures the last decoded frame's sync-window stats
    (peak-anchored like the calibration) and the shared calibrated
    computation runs on them."""
    def run(sigma):
        core = SoftModemCore(DEFAULT_FSK_CONFIG)
        sig = np.asarray(core.modulate_data(b"quality!"))
        rng = np.random.RandomState(0)
        noisy = (sig + sigma * rng.standard_normal(len(sig))
                 ).astype(np.float32)
        assert core.demodulate_data(noisy) == b"quality!"
        return core.get_signal_quality()

    assert SoftModemCore(DEFAULT_FSK_CONFIG).get_signal_quality().ber == 0.0
    clean, noisy = run(0.0), run(0.3)
    assert clean.ber == 0.0                  # peak-anchored: no bias
    assert noisy.ber > 0.01                  # real re-sliced bit errors
    assert 0.0 <= noisy.eye_opening < clean.eye_opening + 1e-6
    # SNR comes from the captured window's I/Q amplitudes (the soft
    # stage does not maintain amp_tail) — live, not a dead zero; like
    # FSKCore's (test_signal_quality.py::test_snr_live_during_signal)
    # it is pinned only as a live positive estimate
    assert clean.snr > 0.0 and noisy.snr > 0.0


def test_unconfigured_raises():
    core = SoftModemCore()
    assert not core.is_ready()
    with pytest.raises(RuntimeError):
        core.modulate_data(b"x")
    with pytest.raises(RuntimeError):
        core.demodulate_data(np.zeros(8, np.float32))
