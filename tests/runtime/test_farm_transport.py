"""Farm-scale transport integration: N concurrent XModem sessions over
ONE batched ModemFarm pair, decoded bytes drained through the native
C++ deframer (the BASELINE north-star topology: transport per channel
x thousands of channels per chip, reference analog core.ts:297-305 x
demo/demo.js:233-250)."""

import asyncio

import numpy as np
import pytest

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem.runtime.farm_channel import FarmLoopbackHub
from webaudio_modem.transports.xmodem import XModemTransport


def awgn(noise_power: float, seed: int = 0):
    # single AWGN model shared with the sim layer (sim/channels.py)
    from webaudio_modem.sim import make_awgn_channel

    return make_awgn_channel(noise_power, seed=seed)


async def _run_sessions(B, payloads, channel_fn=None, timeout_ms=60000,
                        config=None, quantum=4800):
    hub = FarmLoopbackHub(config or DEFAULT_FSK_CONFIG, B,
                          quantum=quantum, channel_fn=channel_fn)
    pump = asyncio.ensure_future(hub.run())
    senders = [XModemTransport(hub.channel("a", i)) for i in range(B)]
    receivers = [XModemTransport(hub.channel("b", i)) for i in range(B)]
    for t in senders + receivers:
        t.configure({"timeout_ms": timeout_ms})
    try:
        recv_tasks = [asyncio.ensure_future(r.receive_data())
                      for r in receivers]
        await asyncio.sleep(0)
        send_tasks = [asyncio.ensure_future(s.send_data(p))
                      for s, p in zip(senders, payloads)]
        await asyncio.gather(*send_tasks)
        results = await asyncio.gather(*recv_tasks)
    finally:
        hub.stop()
        await pump
    return results, hub, senders, receivers


async def test_64_concurrent_sessions_exact():
    """>= 64 concurrent ARQ sessions over one batched audio stream with
    AWGN on; every payload must arrive exactly."""
    B = 64
    payloads = [bytes([i]) + f"session {i:03d} payload".encode()
                + bytes(range(i % 32)) for i in range(B)]
    results, hub, senders, _ = await _run_sessions(
        B, payloads, channel_fn=awgn(1e-4))
    assert results == payloads
    status = hub.get_status()
    assert status["native_deframer"], \
        "C++ deframer must be on the farm drain path"
    for s in senders:
        assert s.get_statistics().packets_sent >= 2  # data + EOT


async def test_multi_fragment_farm_transfer():
    """Payloads spanning several XModem fragments, smaller batch."""
    B = 8
    payloads = [bytes([0x40 + i]) * (200 + i) for i in range(B)]
    results, hub, senders, _ = await _run_sessions(B, payloads)
    assert results == payloads
    for s in senders:
        assert s.get_statistics().packets_sent >= 3  # 2 fragments + EOT


async def test_farm_channel_frame_path_used():
    """The transport must take the framed (deframer) receive path over
    a FarmDataChannel."""
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, 2)
    ch = hub.channel("a", 0)
    t = XModemTransport(ch)
    assert ch.supports_frames
    assert t._frames_supported()


async def test_farm_channel_modulate_resolves_on_playout():
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, 2, quantum=4800)
    ch = hub.channel("a", 0)
    done = []

    async def tx():
        await ch.modulate(b"\x06")
        done.append(True)

    task = asyncio.ensure_future(tx())
    await asyncio.sleep(0)
    assert not done  # nothing pumped yet
    for _ in range(10):
        hub.step()
        await asyncio.sleep(0)
        if done:
            break
    assert done
    await task
    # drain the pipelined last quantum (step() overlaps device compute
    # with the previous quantum's host-side parsing)
    hub.flush()
    # and the peer side decoded the control byte through the deframer
    frame = await asyncio.wait_for(hub.channel("b", 0).next_frame(), 1)
    assert frame.kind == "control" and frame.byte == 0x06


async def test_aborted_modulate_stops_playout():
    # an aborted transmission must not keep feeding the wire
    from webaudio_modem.utils.abort import AbortController, AbortError

    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, 2, quantum=512)
    ch = hub.channel("a", 0)
    ctrl = AbortController()
    task = asyncio.ensure_future(ch.modulate(b"X" * 40,
                                             signal=ctrl.signal))
    await asyncio.sleep(0)
    hub.step()          # starts playing
    ctrl.abort()
    with pytest.raises(AbortError):
        await task
    assert not hub.tx_pending("a", 0)  # remainder dropped
    # and the playing cohort row is deactivated — no further samples
    for c in hub._cohorts["a"]:
        assert not c.active.any()


async def test_farm_channel_reset_clears_pending():
    from webaudio_modem.utils.abort import AbortError

    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, 2)
    ch = hub.channel("a", 1)
    waiter = asyncio.ensure_future(ch.modulate(b"xx"))
    await asyncio.sleep(0)
    await ch.reset()
    with pytest.raises(AbortError):
        await waiter


async def test_corrupted_frames_recovered_by_retry():
    """Zero out a burst mid-transfer on the a->b direction: the CRC
    fails or the packet is lost, the receiver NAKs, the sender
    retransmits, and the payload still arrives exactly."""
    B = 4
    # channel_fn runs a->b first, then b->a, each pump step
    state = {"call": 0, "killed": False}

    def burst(frame):
        state["call"] += 1
        a2b = state["call"] % 2 == 1
        if a2b and not state["killed"] and np.abs(frame).max() > 0.1:
            state["killed"] = True  # kill the first active data quantum
            return np.zeros_like(frame)
        return frame

    payloads = [bytes([0x30 + i]) * 80 for i in range(B)]
    results, hub, senders, receivers = await _run_sessions(
        B, payloads, channel_fn=burst, timeout_ms=8000)
    assert results == payloads
    assert state["killed"]
    # the killed quantum must have caused recovery (retransmits)
    assert sum(s.get_statistics().packets_retransmitted
               for s in senders) > 0


async def test_farm_sessions_are_independent():
    """A channel with no traffic stays silent while others transfer."""
    B = 4
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, B)
    pump = asyncio.ensure_future(hub.run())
    tx = XModemTransport(hub.channel("a", 2))
    rx = XModemTransport(hub.channel("b", 2))
    tx.configure({"timeout_ms": 60000})
    rx.configure({"timeout_ms": 60000})
    try:
        recv = asyncio.ensure_future(rx.receive_data())
        await tx.send_data(b"only channel 2")
        assert await recv == b"only channel 2"
        # the idle channels saw no frames
        for b in (0, 1, 3):
            assert hub.channel("b", b)._frames_q.empty()
            assert hub.channel("a", b)._frames_q.empty()
    finally:
        hub.stop()
        await pump


async def test_psk_farm_transport_sessions():
    """The hub dispatches modulation through the model family: PSK
    configs carry ARQ sessions too."""
    from webaudio_modem.models.psk import PSKConfig

    B = 4
    payloads = [bytes([0x50 + i]) * 24 for i in range(B)]
    results, hub, senders, _ = await _run_sessions(
        B, payloads, config=PSKConfig())
    assert results == payloads


async def test_sequential_rounds_queues_stay_bounded():
    """Multi-round soak: after each completed transfer round the
    per-channel queues must be drained — the surface the consumer
    doesn't use stops filling (long-run leak regression)."""
    B = 2
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, B)
    pump = asyncio.ensure_future(hub.run())
    txs = [XModemTransport(hub.channel("a", i)) for i in range(B)]
    rxs = [XModemTransport(hub.channel("b", i)) for i in range(B)]
    for t in txs + rxs:
        t.configure({"timeout_ms": 60000})
    try:
        for rnd in range(3):
            recvs = [asyncio.ensure_future(r.receive_data()) for r in rxs]
            await asyncio.gather(*(t.send_data(bytes([rnd]) * 20)
                                   for t in txs))
            assert await asyncio.gather(*recvs) == [bytes([rnd]) * 20] * B
        for i in range(B):
            assert hub.channel("b", i)._bytes_q.qsize() == 0
            assert hub.channel("b", i)._frames_q.qsize() == 0
            assert hub.channel("a", i)._bytes_q.qsize() == 0
    finally:
        hub.stop()
        await pump


async def test_farm_hub_on_device_mesh():
    """The hub's farms shard their channel batch over a device mesh
    (multi-chip layout on the 8-device virtual CPU mesh)."""
    import jax

    if len(jax.devices()) < 8:
        return
    from webaudio_modem.parallel.sharding import make_mesh

    B = 8
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, B, mesh=make_mesh(8))
    pump = asyncio.ensure_future(hub.run())
    tx = XModemTransport(hub.channel("a", 3))
    rx = XModemTransport(hub.channel("b", 3))
    tx.configure({"timeout_ms": 60000})
    rx.configure({"timeout_ms": 60000})
    try:
        recv = asyncio.ensure_future(rx.receive_data())
        await tx.send_data(b"sharded hub")
        assert await recv == b"sharded hub"
    finally:
        hub.stop()
        await pump


async def test_reset_wakes_blocked_waiters():
    # FarmDataChannel.reset must drop coroutines blocked in
    # demodulate()/next_frame() with AbortError (QueueDataChannel /
    # reference reset-rejects-pending contract)
    import asyncio

    from webaudio_modem.models.config import FSKConfig
    from webaudio_modem.runtime.farm_channel import FarmLoopbackHub
    from webaudio_modem.utils.abort import AbortError

    hub = FarmLoopbackHub(FSKConfig(baud_rate=1200), batch=2,
                          quantum=1024)
    ch = hub.channel("a", 0)
    waiter_b = asyncio.ensure_future(ch.demodulate())
    waiter_f = asyncio.ensure_future(ch.next_frame())
    await asyncio.sleep(0)          # let both block on their queues
    await ch.reset()
    for w in (waiter_b, waiter_f):
        with pytest.raises(AbortError):
            await w


def test_unconsumed_channel_backlog_bounded():
    # channels nobody consumes must not grow their queues forever
    from webaudio_modem.models.config import FSKConfig
    from webaudio_modem.runtime.farm_channel import (FarmDataChannel,
                                                         FarmLoopbackHub)

    hub = FarmLoopbackHub(FSKConfig(baud_rate=1200), batch=1,
                          quantum=1024)
    ch = hub.channel("a", 0)
    for _ in range(FarmDataChannel.UNCONSUMED_BACKLOG + 500):
        ch._deliver(b"x", [])
    assert ch._bytes_q.qsize() <= FarmDataChannel.UNCONSUMED_BACKLOG


async def test_pump_crash_fails_fast_not_deadlock():
    """A dispatch exception inside hub.step() must poison the hub:
    blocked modulate/demodulate waits raise immediately and later
    channel operations re-raise, instead of ARQ sessions hanging on
    queues only the dead pump can fill (round-5 regression: an illegal
    Pallas block shape raised at lowering inside the soft hub's decode
    dispatch; through ensure_future(hub.run()) the endurance run
    deadlocked for 28 minutes with zero diagnostics)."""
    from webaudio_modem.models.config import FSKConfig

    class Boom(RuntimeError):
        pass

    class CrashingHub(FarmLoopbackHub):
        def step(self):
            raise Boom("lowering rejected")

    hub = CrashingHub(FSKConfig(baud_rate=1200), batch=2, quantum=1024)
    ch_a, ch_b = hub.channel("a", 0), hub.channel("b", 0)
    # block BEFORE the crash: a demodulate wait and a queued modulate
    demod = asyncio.ensure_future(ch_b.demodulate())
    mod = asyncio.ensure_future(ch_a.modulate(b"hello"))
    await asyncio.sleep(0)
    pump = asyncio.ensure_future(hub.run())
    with pytest.raises(Boom):
        await pump
    with pytest.raises(Boom):
        await demod
    with pytest.raises(Boom):
        await mod
    # operations AFTER the crash re-raise instead of blocking
    with pytest.raises(Boom):
        await ch_a.modulate(b"more")
    with pytest.raises(Boom):
        await ch_b.demodulate()
