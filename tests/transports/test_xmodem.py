"""XModem transport tests — port of the central scenarios of the
reference suite (tests/transports/xmodem/xmodem.node.test.ts, 1838 LoC)
against QueueDataChannel (the MockDataChannel analog)."""

import asyncio

import pytest

from webaudio_modem.transports.xmodem import (ControlType, XModemPacket,
                                                  XModemTransport)
from webaudio_modem.runtime.data_channel import (QueueDataChannel,
                                                     make_loopback_pair)
from webaudio_modem.utils.abort import AbortController, AbortError
from webaudio_modem.utils.crc16 import CRC16

ACK = XModemPacket.serialize_control(ControlType.ACK)
NAK = XModemPacket.serialize_control(ControlType.NAK)
EOT = XModemPacket.serialize_control(ControlType.EOT)


@pytest.fixture
def channel():
    return QueueDataChannel()


@pytest.fixture
def transport(channel):
    t = XModemTransport(channel)
    t.configure({"timeout_ms": 300, "max_retries": 3})
    return t


# -- packet codec (packet.ts) -------------------------------------------------

class TestPacket:
    def test_create_and_serialize(self):
        pkt = XModemPacket.create_data(1, b"\x41\x42")
        wire = XModemPacket.serialize(pkt)
        assert wire[0] == 0x01          # SOH
        assert wire[1] == 1             # SEQ
        assert wire[2] == 0xFE          # ~SEQ
        assert wire[3] == 2             # LEN
        assert wire[4:6] == b"\x41\x42"
        crc = CRC16.calculate(b"\x41\x42")
        assert wire[6] == (crc >> 8) and wire[7] == (crc & 0xFF)

    def test_sequence_bounds(self):
        with pytest.raises(ValueError):
            XModemPacket.create_data(0, b"")
        with pytest.raises(ValueError):
            XModemPacket.create_data(256, b"")

    def test_payload_too_large(self):
        with pytest.raises(ValueError):
            XModemPacket.create_data(1, bytes(256))

    def test_verify(self):
        pkt = XModemPacket.create_data(5, b"hello")
        assert XModemPacket.verify(pkt)

    def test_control_bytes(self):
        assert XModemPacket.serialize_control(ControlType.ACK) == b"\x06"
        assert XModemPacket.serialize_control(ControlType.NAK) == b"\x15"
        assert XModemPacket.serialize_control(ControlType.EOT) == b"\x04"


# -- mock channel self-tests (xmodem.node.test.ts:161-276) --------------------

class TestQueueDataChannel:
    async def test_modulate_records(self, channel):
        await channel.modulate(b"\x01\x02")
        assert channel.sent_data == [b"\x01\x02"]

    async def test_demodulate_returns_queued(self, channel):
        channel.add_received_data(b"\xAA")
        assert await channel.demodulate() == b"\xAA"

    async def test_demodulate_waits_for_data(self, channel):
        async def feed():
            await asyncio.sleep(0.01)
            channel.add_received_data(b"\x42")

        task = asyncio.ensure_future(feed())
        assert await channel.demodulate() == b"\x42"
        await task

    async def test_byte_by_byte_mode(self, channel):
        channel.add_received_data_by_byte(b"\x01\x02\x03")
        assert await channel.demodulate() == b"\x01"
        assert await channel.demodulate() == b"\x02"
        assert await channel.demodulate() == b"\x03"

    async def test_abort_rejects(self, channel):
        controller = AbortController()

        async def abort_soon():
            await asyncio.sleep(0.01)
            controller.abort()

        task = asyncio.ensure_future(abort_soon())
        with pytest.raises(AbortError):
            await channel.demodulate(signal=controller.signal)
        await task

    async def test_reset_drops_pending_waiters(self, channel):
        # reference mock reset() discards demodulateResolvers but keeps
        # sent/queued data (xmodem.node.test.ts:143-151)
        await channel.modulate(b"\x99")
        waiter = asyncio.ensure_future(channel.demodulate())
        await asyncio.sleep(0)           # let the waiter park
        await channel.reset()
        with pytest.raises(AbortError):
            await waiter
        assert channel.sent_data == [b"\x99"]  # kept for inspection
        channel.add_received_data(b"ok")       # channel still usable
        assert await channel.demodulate() == b"ok"

    async def test_reset_keeps_queued_data(self, channel):
        channel.add_received_data(b"\x01")
        await channel.reset()
        assert await channel.demodulate() == b"\x01"

    async def test_external_cancellation_propagates(self, channel):
        # asyncio.wait_for/task.cancel must NOT be swallowed into
        # AbortError — only reset()-induced drops are translated
        waiter = asyncio.ensure_future(channel.demodulate())
        await asyncio.sleep(0)
        waiter.cancel()
        with pytest.raises(asyncio.CancelledError):
            await waiter

    async def test_wait_for_timeout_is_timeout(self, channel):
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(channel.demodulate(), timeout=0.05)


# -- send path ---------------------------------------------------------------

class TestSend:
    async def test_simple_send(self, transport, channel):
        channel.add_received_data(NAK)   # initial NAK
        channel.add_received_data(ACK)   # fragment ACK
        channel.add_received_data(ACK)   # final ACK for EOT
        await transport.send_data(b"\x42")
        assert len(channel.sent_data) == 2  # data packet + EOT
        pkt = channel.sent_data[0]
        assert pkt[0] == 0x01 and pkt[1] == 1 and pkt[3] == 1
        assert channel.sent_data[1] == EOT

    async def test_send_without_initial_nak(self, transport, channel):
        # standalone mode (xmodem.ts:109-121): missing NAK tolerated; the
        # ACKs arrive only after the data packet goes out (as in real use)
        async def late_acks():
            while not channel.sent_data:  # wait for the data packet
                await asyncio.sleep(0.01)
            channel.add_received_data(ACK)
            channel.add_received_data(ACK)

        task = asyncio.ensure_future(late_acks())
        await transport.send_data(b"\x42")
        await task
        assert channel.sent_data[-1] == EOT

    async def test_fragmentation(self, transport, channel):
        transport.configure({"max_payload_size": 4})
        channel.add_received_data(NAK)
        for _ in range(3):
            channel.add_received_data(ACK)
        channel.add_received_data(ACK)  # EOT
        await transport.send_data(bytes(range(10)))
        # 3 fragments (4+4+2) + EOT
        assert len(channel.sent_data) == 4
        assert channel.sent_data[0][3] == 4
        assert channel.sent_data[2][3] == 2
        assert [p[1] for p in channel.sent_data[:3]] == [1, 2, 3]

    async def test_send_empty_data(self, transport, channel):
        # one empty fragment (xmodem.ts:504-514)
        channel.add_received_data(NAK)
        channel.add_received_data(ACK)
        channel.add_received_data(ACK)
        await transport.send_data(b"")
        assert len(channel.sent_data) == 2
        assert channel.sent_data[0][3] == 0
        assert channel.sent_data[1] == EOT

    async def test_nak_triggers_retransmission(self, transport, channel):
        channel.add_received_data(NAK)   # initial
        channel.add_received_data(NAK)   # reject fragment once
        channel.add_received_data(ACK)   # accept retransmit
        channel.add_received_data(ACK)   # EOT
        await transport.send_data(b"\x42")
        # fragment sent twice + EOT
        assert len(channel.sent_data) == 3
        assert channel.sent_data[0] == channel.sent_data[1]
        assert transport.get_statistics().packets_retransmitted >= 1

    async def test_max_retries_exceeded(self, transport, channel):
        transport.configure({"timeout_ms": 30, "max_retries": 1})
        with pytest.raises(TimeoutError):
            await transport.send_data(b"\x42")
        assert transport.is_ready()  # back to IDLE

    async def test_eot_echo_immunity(self, transport, channel):
        # sender hears its own EOT; must keep waiting for the real ACK
        # (xmodem.ts:442-470, tests :653-730)
        channel.add_received_data(NAK)
        channel.add_received_data(ACK)
        channel.add_received_data(EOT)   # echo of own EOT
        channel.add_received_data(ACK)   # real final ACK
        await transport.send_data(b"\x42")
        assert transport.is_ready()

    async def test_busy_rejected(self, transport, channel):
        task = asyncio.ensure_future(transport.send_data(b"\x42"))
        await asyncio.sleep(0.01)
        with pytest.raises(RuntimeError, match="busy"):
            await transport.send_data(b"\x43")
        with pytest.raises(RuntimeError, match="busy"):
            await transport.receive_data()
        channel.add_received_data(NAK)
        channel.add_received_data(ACK)
        channel.add_received_data(ACK)
        await task

    async def test_statistics(self, transport, channel):
        channel.add_received_data(NAK)
        channel.add_received_data(ACK)
        channel.add_received_data(ACK)
        await transport.send_data(b"\x01\x02\x03")
        stats = transport.get_statistics()
        assert stats.packets_sent == 2  # data + EOT
        assert stats.bytes_transferred == 3


# -- receive path -------------------------------------------------------------

def _packet_bytes(seq, payload):
    return XModemPacket.serialize(XModemPacket.create_data(seq, payload))


class TestReceive:
    async def test_simple_receive(self, transport, channel):
        channel.add_received_data(_packet_bytes(1, b"\x42"))
        channel.add_received_data(EOT)
        result = await transport.receive_data()
        assert result == b"\x42"
        # initial NAK + ACK + final ACK
        assert channel.sent_data[0] == NAK
        assert channel.sent_data[1] == ACK
        assert channel.sent_data[2] == ACK

    async def test_receive_byte_by_byte(self, transport, channel):
        # simulates FSK demod granularity (xmodem.node.test.ts:107-122)
        channel.add_received_data_by_byte(_packet_bytes(1, b"hello"))
        channel.add_received_data_by_byte(EOT)
        assert await transport.receive_data() == b"hello"

    async def test_reassembly(self, transport, channel):
        channel.add_received_data(_packet_bytes(1, b"abc"))
        channel.add_received_data(_packet_bytes(2, b"def"))
        channel.add_received_data(EOT)
        assert await transport.receive_data() == b"abcdef"

    async def test_duplicate_previous_seq_reacked_and_dropped(
            self, transport, channel):
        # (xmodem.ts:309-314)
        channel.add_received_data(_packet_bytes(1, b"abc"))
        channel.add_received_data(_packet_bytes(1, b"abc"))  # duplicate
        channel.add_received_data(_packet_bytes(2, b"def"))
        channel.add_received_data(EOT)
        assert await transport.receive_data() == b"abcdef"
        assert transport.get_statistics().packets_dropped == 1
        # duplicate got an ACK too: NAK + 3 ACKs + final ACK
        acks = [d for d in channel.sent_data if d == ACK]
        assert len(acks) == 4

    async def test_unexpected_sequence_fatal(self, transport, channel):
        transport.configure({"timeout_ms": 50, "max_retries": 1})
        channel.add_received_data(_packet_bytes(1, b"abc"))
        channel.add_received_data(_packet_bytes(5, b"bad"))
        channel.add_received_data(_packet_bytes(5, b"bad"))
        with pytest.raises((ValueError, TimeoutError)):
            await transport.receive_data()
        assert transport.is_ready()

    async def test_corrupted_crc_naked(self, transport, channel):
        wire = bytearray(_packet_bytes(1, b"abc"))
        wire[-1] ^= 0xFF  # corrupt CRC
        channel.add_received_data(bytes(wire))
        channel.add_received_data(_packet_bytes(1, b"abc"))  # retransmit
        channel.add_received_data(EOT)
        assert await transport.receive_data() == b"abc"
        # NAK(initial) ... NAK(error) ... ACK
        naks = [d for d in channel.sent_data if d == NAK]
        assert len(naks) >= 2
        assert transport.get_statistics().packets_dropped == 1

    async def test_invalid_inverse_seq_naked(self, transport, channel):
        wire = bytearray(_packet_bytes(1, b"abc"))
        wire[2] = 0x00  # seq + nseq != 255
        channel.add_received_data(bytes(wire))
        channel.add_received_data(_packet_bytes(1, b"abc"))
        channel.add_received_data(EOT)
        assert await transport.receive_data() == b"abc"

    async def test_ignores_garbage_bytes(self, transport, channel):
        channel.add_received_data(b"\x99")  # not SOH/EOT
        channel.add_received_data(_packet_bytes(1, b"x"))
        channel.add_received_data(EOT)
        assert await transport.receive_data() == b"x"

    async def test_fragment_received_events(self, transport, channel):
        events = []
        transport.on("fragmentReceived", lambda ev: events.append(ev.data))
        channel.add_received_data(_packet_bytes(1, b"ab"))
        channel.add_received_data(_packet_bytes(2, b"cd"))
        channel.add_received_data(EOT)
        await transport.receive_data()
        assert len(events) == 2
        assert events[0]["seq_num"] == 1
        assert events[1]["total_bytes_received"] == 4

    async def test_statechange_events(self, transport, channel):
        states = []
        transport.on("statechange",
                     lambda ev: states.append(ev.data["new_state"]))
        channel.add_received_data(_packet_bytes(1, b"x"))
        channel.add_received_data(EOT)
        await transport.receive_data()
        assert "RECEIVING_WAIT_BLOCK" in states
        assert states[-1] == "IDLE"


# -- sequence wrap ------------------------------------------------------------

class TestSequenceWrap:
    async def test_seq_wraps_255_to_1(self, transport, channel):
        # (xmodem.ts:143,303)
        transport._send_sequence = 255
        transport._recv_expected_sequence = 255
        channel.add_received_data(_packet_bytes(255, b"a"))
        channel.add_received_data(_packet_bytes(1, b"b"))
        channel.add_received_data(EOT)
        transport._state = transport._state  # keep idle
        # drive the private helpers through receive_data with a
        # pre-positioned expected sequence
        transport._initialize_receive = _keep_seq(transport, 255)
        assert await transport.receive_data() == b"ab"


def _keep_seq(transport, seq):
    original = XModemTransport._initialize_receive

    def patched():
        original(transport)
        transport._recv_expected_sequence = seq
    return patched


# -- end-to-end over loopback channels ---------------------------------------

class TestEndToEnd:
    async def test_transfer_between_two_transports(self):
        a, b = make_loopback_pair()
        sender = XModemTransport(a)
        receiver = XModemTransport(b)
        data = bytes(range(256)) * 2  # 512 bytes -> 4 fragments
        send_task = asyncio.ensure_future(sender.send_data(data))
        received = await receiver.receive_data()
        await send_task
        assert received == data
        assert sender.get_statistics().bytes_transferred == len(data)
        assert receiver.get_statistics().bytes_transferred == len(data)

    async def test_transfer_with_echo_hub(self):
        # loopback-hub topology: every node hears its own TX
        a, b = make_loopback_pair(echo=True)
        sender = XModemTransport(a)
        receiver = XModemTransport(b)
        data = b"Hello over the echoing hub!"
        send_task = asyncio.ensure_future(sender.send_data(data))
        received = await receiver.receive_data()
        await send_task
        assert received == data

    async def test_sequential_transfers(self):
        # alternating ops (xmodem.node.test.ts:1149-1301)
        a, b = make_loopback_pair()
        t1, t2 = XModemTransport(a), XModemTransport(b)
        for payload in (b"first", b"second", b"third"):
            task = asyncio.ensure_future(t1.send_data(payload))
            assert await t2.receive_data() == payload
            await task
        # reverse direction
        task = asyncio.ensure_future(t2.send_data(b"reply"))
        assert await t1.receive_data() == b"reply"
        await task


# -- abort matrix (xmodem.node.test.ts:1618-1837) -----------------------------

class TestAbort:
    async def test_abort_before_start(self, transport):
        controller = AbortController()
        controller.abort()
        with pytest.raises(AbortError):
            await transport.send_data(b"x", signal=controller.signal)

    async def test_abort_during_send(self, transport, channel):
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.send_data(b"x", signal=controller.signal))
        await asyncio.sleep(0.02)
        controller.abort()
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()

    async def test_abort_during_receive(self, transport, channel):
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.receive_data(signal=controller.signal))
        await asyncio.sleep(0.02)
        controller.abort()
        with pytest.raises(AbortError):
            await task
        assert transport.is_ready()

    async def test_reset_aborts_operation(self, transport, channel):
        task = asyncio.ensure_future(transport.receive_data())
        await asyncio.sleep(0.02)
        transport.reset()
        with pytest.raises((AbortError, TimeoutError)):
            await task
        assert transport.is_ready()

    async def test_operations_after_abort(self, transport, channel):
        controller = AbortController()
        task = asyncio.ensure_future(
            transport.send_data(b"x", signal=controller.signal))
        await asyncio.sleep(0.02)
        controller.abort()
        with pytest.raises(AbortError):
            await task
        # transport usable again
        channel.add_received_data(NAK)
        channel.add_received_data(ACK)
        channel.add_received_data(ACK)
        await transport.send_data(b"y")
