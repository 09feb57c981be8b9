"""Port of the reference's AbortSignal matrix, timeout paths, fault
injection and sequential-operation stress
(tests/transports/xmodem/xmodem.node.test.ts:522-611, 1149-1301,
1618-1837)."""

import asyncio

import pytest

from webaudio_modem.transports.xmodem import (ControlType, XModemPacket,
                                                  XModemTransport)
from webaudio_modem.runtime.data_channel import QueueDataChannel
from webaudio_modem.utils.abort import AbortController, AbortError

ACK = XModemPacket.serialize_control(ControlType.ACK)
NAK = XModemPacket.serialize_control(ControlType.NAK)
EOT = XModemPacket.serialize_control(ControlType.EOT)


@pytest.fixture
def channel():
    return QueueDataChannel()


@pytest.fixture
def transport(channel):
    t = XModemTransport(channel)
    t.configure({"timeout_ms": 500, "max_retries": 3})
    return t


async def _tick(n: int = 2):
    for _ in range(n):
        await asyncio.sleep(0)


# -- AbortSignal matrix (xmodem.node.test.ts:1618-1837) ----------------------

class TestSendAbortMatrix:
    async def test_abort_during_initial_nak_wait(self, transport, channel):
        # :1619-1642
        task = asyncio.ensure_future(transport.send_data(b"\x42"))
        await _tick()
        assert not transport.is_ready()  # busy
        channel.trigger_abort("Demodulation aborted")
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()

    async def test_abort_during_ack_wait(self, transport, channel):
        # :1644-1664
        task = asyncio.ensure_future(transport.send_data(b"\x42"))
        channel.add_received_data(NAK)
        await _tick(8)
        assert len(channel.sent_data) == 1  # data packet sent
        channel.trigger_abort("Demodulation aborted")
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()

    async def test_abort_during_final_ack_wait(self, transport, channel):
        # :1666-1691
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.send_data(b"\x42", signal=controller.signal))
        channel.add_received_data(NAK)
        await _tick(8)
        channel.add_received_data(ACK)
        await _tick(8)
        assert len(channel.sent_data) == 2  # data + EOT
        channel.trigger_abort("Demodulation aborted")
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()

    async def test_external_abort_during_send(self, transport, channel):
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.send_data(b"\x42", signal=controller.signal))
        await _tick()
        controller.abort()
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()


class TestReceiveAbortMatrix:
    async def test_abort_during_initial_block_wait(self, transport,
                                                   channel):
        # :1693-1716
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.receive_data(signal=controller.signal))
        await _tick()
        assert not transport.is_ready()
        assert len(channel.sent_data) == 1  # initial NAK sent
        controller.abort()
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()

    async def test_abort_during_packet_reception(self, transport, channel):
        # :1718-1737
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.receive_data(signal=controller.signal))
        await _tick()
        assert len(channel.sent_data) == 1  # initial NAK
        channel.trigger_abort("Demodulation aborted")
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()

    async def test_abort_during_multi_packet_reception(self, transport,
                                                       channel):
        # :1739-1766
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.receive_data(signal=controller.signal))
        await _tick()
        pkt1 = XModemPacket.serialize(XModemPacket.create_data(1, b"\x41"))
        channel.add_received_data(pkt1)
        await _tick(8)
        assert len(channel.sent_data) == 2  # NAK + ACK
        channel.trigger_abort("Demodulation aborted")
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()

    async def test_delayed_external_abort(self, transport, channel):
        # :1768-1781 — abort arrives a bit later
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.receive_data(signal=controller.signal))
        loop = asyncio.get_running_loop()
        loop.call_later(0.05, controller.abort)
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()


class TestAbortHygiene:
    async def test_abort_does_not_corrupt_statistics(self, transport,
                                                     channel):
        # :1783-1802
        initial = transport.get_statistics()
        task = asyncio.ensure_future(transport.send_data(b"\x42"))
        await _tick()
        channel.trigger_abort("Demodulation aborted")
        with pytest.raises(AbortError):
            await task
        final = transport.get_statistics()
        assert final.bytes_transferred == initial.bytes_transferred
        assert final.packets_received == initial.packets_received
        assert final.packets_retransmitted == initial.packets_retransmitted

    async def test_abort_followed_by_successful_operation(self, transport,
                                                          channel):
        # :1804-1836
        task = asyncio.ensure_future(transport.send_data(b"\x41"))
        await _tick()
        channel.trigger_abort("Demodulation aborted")
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()
        channel.clear_sent_data()

        task = asyncio.ensure_future(transport.send_data(b"\x42"))
        channel.add_received_data(NAK)
        await _tick(8)
        channel.add_received_data(ACK)
        await _tick(8)
        channel.add_received_data(ACK)
        await task
        assert transport.is_ready()
        assert transport.get_statistics().bytes_transferred == 1

    async def test_external_signal_listeners_released(self, transport,
                                                      channel):
        """After an operation completes, no composite-timeout listeners
        may remain registered on the caller's long-lived signal (the
        leak a farm of thousands of sessions would otherwise hit)."""
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.send_data(b"\x42", signal=controller.signal))
        channel.add_received_data(NAK)
        await _tick(8)
        channel.add_received_data(ACK)
        await _tick(8)
        channel.add_received_data(ACK)
        await task
        assert controller.signal._listeners == []

    async def test_pre_aborted_signal_rejects_immediately(self, transport):
        controller = AbortController()
        controller.abort()
        with pytest.raises(AbortError):
            await transport.send_data(b"\x42", signal=controller.signal)
        with pytest.raises(AbortError):
            await transport.receive_data(signal=controller.signal)
        assert transport.is_ready()


# -- timeout paths with short real timeouts (:522-571) -----------------------

class TestTimeouts:
    async def test_timeout_then_retry_succeeds(self, channel):
        # :522-550 — first ACK wait times out, retry is ACKed
        t = XModemTransport(channel)
        t.configure({"timeout_ms": 100, "max_retries": 2})
        channel.add_received_data(NAK)
        task = asyncio.ensure_future(t.send_data(b"\x42"))
        # no ACK: let the first wait time out (retransmission)
        await asyncio.sleep(0.15)
        channel.add_received_data(ACK)
        await asyncio.sleep(0.02)
        channel.add_received_data(ACK)  # final ACK for EOT
        await task
        assert len(channel.sent_data) >= 3  # packet, retransmit, EOT
        assert t.get_statistics().packets_retransmitted >= 1

    async def test_receive_timeout_sends_nak_retries(self, channel):
        t = XModemTransport(channel)
        t.configure({"timeout_ms": 80, "max_retries": 2})
        task = asyncio.ensure_future(t.receive_data())
        # never send anything: the receiver NAKs per timeout then fails
        with pytest.raises(TimeoutError):
            await task
        # initial NAK + one per retry
        naks = [d for d in channel.sent_data if d == NAK]
        assert len(naks) >= 2
        assert t.is_ready()

    async def test_max_retries_exceeded_leaves_ready(self, channel):
        # :552-571
        t = XModemTransport(channel)
        t.configure({"timeout_ms": 60, "max_retries": 1})
        channel.add_received_data(NAK)
        with pytest.raises(TimeoutError, match="max retries"):
            await t.send_data(b"\x42")
        assert t.is_ready()


# -- fault injection via rejecting modulate (:591-611) ------------------------

class TestModulateFaultInjection:
    async def test_send_fails_when_modulate_rejects(self, channel):
        t = XModemTransport(channel)
        t.configure({"timeout_ms": 300, "max_retries": 1})
        original = channel.modulate
        calls = {"n": 0}

        async def failing_modulate(data, signal=None):
            calls["n"] += 1
            raise ConnectionError("Network error")

        channel.modulate = failing_modulate
        task = asyncio.ensure_future(t.send_data(b"\x42"))
        await _tick()
        assert len(channel.sent_data) == 0  # nothing hit the wire
        channel.add_received_data(NAK)  # triggers the failing modulate
        with pytest.raises(ConnectionError):
            await task
        assert calls["n"] >= 1
        channel.modulate = original
        assert t.is_ready()

    async def test_receive_fails_when_initial_nak_modulate_rejects(
            self, channel):
        t = XModemTransport(channel)

        async def failing_modulate(data, signal=None):
            raise ConnectionError("Network error")

        channel.modulate = failing_modulate
        with pytest.raises(ConnectionError):
            await t.receive_data()
        assert t.is_ready()


# -- sequential / alternating operations (:1149-1301) -------------------------

class TestSequentialOperations:
    async def _complete_send(self, transport, channel, data):
        task = asyncio.ensure_future(transport.send_data(data))
        channel.add_received_data(NAK)
        await _tick(8)
        channel.add_received_data(ACK)
        await _tick(8)
        channel.add_received_data(ACK)
        await task

    async def _complete_receive(self, transport, channel, payload):
        task = asyncio.ensure_future(transport.receive_data())
        await _tick()
        pkt = XModemPacket.serialize(XModemPacket.create_data(1, payload))
        channel.add_received_data(pkt)
        await _tick(8)
        channel.add_received_data(EOT)
        return await task

    async def test_sequential_sends(self, transport, channel):
        # :1150-1187
        await self._complete_send(transport, channel, b"\x41")
        assert transport.is_ready()
        channel.clear_sent_data()
        await self._complete_send(transport, channel, b"\x42")
        assert transport.is_ready()
        assert len(channel.sent_data) == 2  # packet + EOT
        assert transport.get_statistics().bytes_transferred == 2

    async def test_sequential_receives(self, transport, channel):
        # :1189-1239
        r1 = await self._complete_receive(transport, channel, b"\x41")
        assert r1 == b"\x41"
        assert transport.is_ready()
        channel.clear_sent_data()
        r2 = await self._complete_receive(transport, channel, b"\x42")
        assert r2 == b"\x42"
        assert transport.is_ready()
        # second receive: NAK + ACK + final ACK for EOT
        assert channel.sent_data[0] == NAK

    async def test_alternating_send_receive_send(self, transport, channel):
        # :1241-1301
        await self._complete_send(transport, channel, b"S")
        assert transport.is_ready()
        channel.clear_sent_data()

        received = await self._complete_receive(transport, channel, b"R")
        assert received == b"R"
        assert transport.is_ready()
        channel.clear_sent_data()

        await self._complete_send(transport, channel, b"S2")
        assert transport.is_ready()

        stats = transport.get_statistics()
        assert stats.bytes_transferred == 4  # 1 + 1 + 2
        assert stats.packets_received == 1   # only the receive

    async def test_many_alternating_operations_stress(self, transport,
                                                      channel):
        for i in range(10):
            await self._complete_send(transport, channel, bytes([i]))
            got = await self._complete_receive(transport, channel,
                                               bytes([0x80 + i]))
            assert got == bytes([0x80 + i])
        stats = transport.get_statistics()
        assert stats.bytes_transferred == 20
        assert stats.packets_received == 10
