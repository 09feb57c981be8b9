"""Full-stack end-to-end: XModem ARQ over FSK audio through the
simulated graph — the analog of the reference's browser integration
suite (fsk-processor-integration-browser.test.ts:123-269) and of
BASELINE config 3 (XModem over lossy simulated audio)."""

from webaudio_modem.sim import make_awgn_channel

from tests.runtime.conftest import arq_transfer as _transfer
from tests.runtime.conftest import make_arq_stack as _make_stack


class TestXModemOverAudio:
    async def test_hello_world_transfer(self):
        graph, sender, receiver = _make_stack()
        data = b"Hello, World!"
        received = await _transfer(graph, sender, receiver, data)
        assert received == data
        assert sender.get_statistics().bytes_transferred == len(data)

    async def test_multi_fragment_transfer(self):
        graph, sender, receiver = _make_stack()
        sender.configure({"max_payload_size": 32})
        data = bytes(range(80))  # 3 fragments
        received = await _transfer(graph, sender, receiver, data)
        assert received == data
        assert sender.get_statistics().packets_sent >= 4  # 3 data + EOT

    async def test_500_byte_transfer(self):
        # the reference's large-payload browser E2E
        # (fsk-processor-integration-browser.test.ts:123-269): 500 bytes
        # = 4 fragments at the 128-byte default payload size, decoded
        # exactly through the full audio stack
        graph, sender, receiver = _make_stack()
        events = []
        receiver.on("fragmentReceived",
                    lambda ev: events.append(ev.data["seq_num"]))
        data = bytes((i * 7 + 13) & 0xFF for i in range(500))
        received = await _transfer(graph, sender, receiver, data,
                                   timeout=500)
        assert received == data
        assert sender.get_statistics().bytes_transferred == 500
        assert sender.get_statistics().packets_sent >= 5  # 4 data + EOT
        assert events == [1, 2, 3, 4]  # progress events in order

    async def test_payload_whose_own_crc_tail_is_a_control_byte(self):
        # regression: in the loopback hub the tail of one's OWN packet
        # decodes one feedback-quantum after the post-TX RX clear; this
        # payload's fragment-2 CRC low byte is 0x15 (NAK), which made
        # the sender retransmit forever before the post-TX RX guard
        # (runtime/processor.py modulate()).
        graph, sender, receiver = _make_stack()
        data = b"VECDRAIN-" * 40  # 360 bytes, 3 fragments
        received = await _transfer(graph, sender, receiver, data,
                                   timeout=500)
        assert received == data
        assert sender.get_statistics().packets_retransmitted == 0

    async def test_transfer_over_noisy_channel(self):
        # XModem over a noisy audio channel (BASELINE config 3); noise
        # power sized ~30 dB below the FSK tone power (~0.5)
        graph, sender, receiver = _make_stack(
            channel_fn=make_awgn_channel(noise_power=5e-4, seed=3))
        data = b"noisy channel payload"
        received = await _transfer(graph, sender, receiver, data)
        assert received == data

    async def test_transfer_over_lossy_channel_with_retransmission(self):
        # burst loss severe enough to corrupt packets: the ARQ layer
        # must recover via NAK/timeout retransmission (BASELINE cfg 3)
        from webaudio_modem.sim import make_dropout_channel

        graph, sender, receiver = _make_stack(
            channel_fn=make_dropout_channel(drop_probability=0.004,
                                            seed=11, block=256))
        sender.configure({"max_payload_size": 24, "max_retries": 8})
        receiver.configure({"max_retries": 8})
        data = bytes(range(96))  # 4 fragments through a lossy channel
        received = await _transfer(graph, sender, receiver, data,
                                   timeout=600)
        assert received == data
        stats = sender.get_statistics()
        total = stats.packets_sent + stats.packets_retransmitted
        assert total >= 5  # 4 data + EOT (+ any retransmits)


if __name__ == "__main__":  # pragma: no cover
    import sys

    import pytest

    pytest.main([__file__, "-v"] + sys.argv[1:])
