"""DBPSK modem tests (second model family; the reference only declares
PSK in its type union, src/core.ts:8)."""

import numpy as np
import pytest

from webaudio_modem.models.psk import (DEFAULT_PSK_CONFIG, PSKConfig,
                                           PSKCore)


def add_noise(signal, snr_db, rng):
    power = float(np.mean(signal.astype(np.float64) ** 2))
    noise_power = power / (10 ** (snr_db / 10))
    amp = np.sqrt(3 * noise_power)
    return (signal + amp * (rng.uniform(size=len(signal)) * 2 - 1)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def core():
    return PSKCore(DEFAULT_PSK_CONFIG)


@pytest.fixture(autouse=True)
def _reset(core):
    core.configure(DEFAULT_PSK_CONFIG)


class TestPSKRoundTrip:
    def test_hello_world(self, core):
        data = b"Hello, World!"
        assert core.demodulate_data(core.modulate_data(data)) == data
        assert core.get_status()["sync_detections"] == 1

    def test_all_byte_values(self, core):
        data = bytes([0x00, 0xFF, 0x55, 0xAA, 0x7E])
        assert core.demodulate_data(core.modulate_data(data)) == data

    @pytest.mark.parametrize("baud,carrier", [(300, 1200.0),
                                              (1200, 1800.0)])
    def test_rates_and_carriers(self, baud, carrier):
        c = PSKCore(PSKConfig(baud_rate=baud,
                              carrier_frequency=carrier))
        data = b"\x42"
        assert c.demodulate_data(c.modulate_data(data)) == data

    def test_chunked_streaming(self, core):
        data = b"chunked"
        sig = core.modulate_data(data)
        out = b""
        for i in range(0, len(sig), 128):
            out += core.demodulate_data(sig[i:i + 128])
        assert out == data

    def test_start_offset(self, core):
        data = b"\x42"
        sig = np.concatenate([np.zeros(777, np.float32),
                              core.modulate_data(data)])
        assert core.demodulate_data(sig) == data

    def test_noise_20db(self, core):
        rng = np.random.RandomState(5)
        data = b"\x12\x34"
        noisy = add_noise(core.modulate_data(data), 20, rng)
        assert core.demodulate_data(noisy) == data

    def test_low_amplitude_agc(self, core):
        data = b"\x42"
        sig = (core.modulate_data(data) * 0.1).astype(np.float32)
        assert core.demodulate_data(sig) == data

    def test_false_positive_silence(self, core):
        assert core.demodulate_data(np.zeros(48000, np.float32)) == b""
        assert core.get_status()["sync_detections"] == 0

    def test_multi_transmission_eod(self, core):
        gap = np.zeros(4800, np.float32)
        s1 = core.modulate_data(b"\x11")
        s2 = core.modulate_data(b"\x22")
        out = core.demodulate_data(np.concatenate([s1, gap, s2]))
        assert out == b"\x11\x22"
        assert core.get_status()["sync_detections"] == 2

    def test_signal_is_constant_envelope(self, core):
        sig = core.modulate_data(b"\x42")
        pad = core.params.samples_per_bit * 2
        silence = core.params.bits_per_byte * core.params.samples_per_bit
        body = sig[pad:-silence]
        # BPSK keeps the carrier amplitude; envelope stays ~1
        assert np.abs(body).max() <= 1.0 + 1e-5
        assert np.percentile(np.abs(body), 95) > 0.9


class TestPSKOverTransport:
    async def test_xmodem_over_psk_audio(self):
        # full stack with the PSK modem swapped in — the runtime and
        # transport layers are modulation-agnostic
        import asyncio

        from webaudio_modem.runtime import AudioGraph, FSKProcessor
        from webaudio_modem.transports.xmodem import XModemTransport

        sender_proc = FSKProcessor(name="s", core=PSKCore())
        receiver_proc = FSKProcessor(name="r", core=PSKCore())
        sender_proc.configure(DEFAULT_PSK_CONFIG)
        receiver_proc.configure(DEFAULT_PSK_CONFIG)
        graph = AudioGraph(quantum=512)
        graph.connect(sender_proc)
        graph.connect(receiver_proc)
        sender = XModemTransport(sender_proc)
        receiver = XModemTransport(receiver_proc)
        for t in (sender, receiver):
            t.configure({"timeout_ms": 20000, "max_retries": 3})

        data = b"PSK over XModem!"
        drive = asyncio.ensure_future(graph.run())
        try:
            send = asyncio.ensure_future(sender.send_data(data))
            received = await asyncio.wait_for(receiver.receive_data(),
                                              timeout=300)
            await asyncio.wait_for(send, timeout=30)
        finally:
            graph.stop()
            await drive
        assert received == data


class TestPSKFarm:
    def test_psk_farm_batch_decode(self):
        from webaudio_modem.models.farm import ModemFarm

        B = 8
        msgs = [bytes([i, 0x42]) for i in range(B)]
        farm = ModemFarm(DEFAULT_PSK_CONFIG, B, donate=False)
        sig = np.asarray(farm.modulate(msgs))
        assert farm.demodulate(sig, chunk_size=2048) == msgs


def test_psk_demodulate_stream_equals_loop():
    # the grouped-dispatch throughput path is family-generic: PSK farm
    # decode through demodulate_stream must equal the per-chunk loop
    import numpy as np

    from webaudio_modem.models.farm import ModemFarm
    from webaudio_modem.models.psk import PSKConfig

    B = 4
    msgs = [bytes([65 + b, 48 + b]) for b in range(B)]
    farm = ModemFarm(PSKConfig(), B, donate=False)
    sig = np.asarray(farm.modulate(msgs))
    sig = np.concatenate([sig, np.zeros((B, 555), np.float32)], axis=1)
    loop = farm.demodulate(sig, chunk_size=512)
    farm.reset()
    grouped = farm.demodulate_stream(sig, chunk_size=512, group=3)
    assert grouped == loop == msgs
