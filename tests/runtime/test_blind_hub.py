"""BlindSoftFarmHub: ARQ over the soft wire with a fully blind RX.

The hub's receive path is ops/soft_blind.BlindSoftBatchReceiver —
frames are DISCOVERED by the sync correlation and lengths read from
decoded headers; playout bookkeeping never reaches RX (reference
acquisition model, fsk.ts:297-315).  CPU-sized checks; at-scale runs
live in examples/farm_endurance.py --blind (on chip)."""

import asyncio

import numpy as np

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem.runtime.soft_hub import BlindSoftFarmHub
from webaudio_modem.sim import make_device_awgn
from webaudio_modem.transports.xmodem import XModemTransport


async def _run_sessions(B, payloads, hub=None, timeout_ms=120000,
                        stagger_quanta=0, **hub_kwargs):
    hub = hub or BlindSoftFarmHub(DEFAULT_FSK_CONFIG, B, **hub_kwargs)
    pump = asyncio.ensure_future(hub.run())
    senders = [XModemTransport(hub.channel("a", i)) for i in range(B)]
    receivers = [XModemTransport(hub.channel("b", i)) for i in range(B)]
    for t in senders + receivers:
        t.configure({"timeout_ms": timeout_ms})

    async def _send(i):
        if stagger_quanta:
            # start sessions at DIFFERENT hub steps: TX cohorts no
            # longer align, so any schedule-shaped assumption in RX
            # would decode the wrong windows
            target = hub.steps + (i * stagger_quanta) % (4 * B)
            while hub.steps < target:
                await asyncio.sleep(0)
        await senders[i].send_data(payloads[i])

    try:
        recv_tasks = [asyncio.ensure_future(r.receive_data())
                      for r in receivers]
        await asyncio.sleep(0)
        await asyncio.gather(*[_send(i) for i in range(B)])
        results = await asyncio.gather(*recv_tasks)
    finally:
        hub.stop()
        await pump
    return results, hub, senders, receivers


async def test_blind_arq_sessions_with_device_awgn():
    """Concurrent XModem sessions over the blind wire with ON-DEVICE
    noise: every payload exact, no timing knowledge on the RX path."""
    B = 4
    payloads = [bytes([i]) + f"blindhub {i:02d}".encode()
                + bytes(range((i * 5) % 16)) for i in range(B)]
    results, hub, senders, _ = await _run_sessions(
        B, payloads, device_channel_fn=make_device_awgn(1e-4))
    assert results == payloads
    st = hub.get_status()
    assert st["native_deframer"]
    rx = st["rx"]
    # each direction moved frames: data+EOT towards b, ACKs towards a
    assert rx["b"]["frames_decoded"] >= 2 * B
    assert rx["a"]["frames_decoded"] >= 2 * B
    assert rx["a"]["dropped_ring"] == rx["b"]["dropped_ring"] == 0


async def test_blind_staggered_sessions():
    """Sessions launched at different hub steps (jittered TX): blind
    acquisition must not depend on cohort alignment."""
    B = 3
    payloads = [f"staggered payload {i}".encode() * (i + 1)
                for i in range(B)]
    results, hub, _, _ = await _run_sessions(
        B, payloads, stagger_quanta=5)
    assert results == payloads


async def test_blind_hub_on_device_mesh():
    """ARQ over the blind wire with the RECEIVER state sharded across
    the 8-device channel mesh (mesh= threads through to
    BlindSoftBatchReceiver): payloads exact, sharding intact."""
    import jax
    import pytest

    from webaudio_modem.parallel.sharding import (channel_sharding,
                                                      make_mesh)

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8)
    B = 8
    payloads = [f"mesh blind {i}".encode() for i in range(B)]
    hub = BlindSoftFarmHub(DEFAULT_FSK_CONFIG, B, mesh=mesh)
    assert hub._rx["a"]._rx.ev_best.sharding == channel_sharding(mesh)
    results, hub, _, _ = await _run_sessions(B, payloads, hub=hub)
    assert results == payloads


async def test_blind_lost_frame_retransmits():
    """A lost data frame (delivery suppressed once) is recovered by
    the ARQ timeout/retransmit flow over the blind wire."""
    B = 1
    hub = BlindSoftFarmHub(DEFAULT_FSK_CONFIG, B)
    dropped = []
    orig = hub._deliver

    def deliver(rx_side, events):
        if rx_side == "b" and not dropped:
            kept = []
            for ch, pl in events:
                if len(pl) > 1:
                    dropped.append((ch, pl))
                else:
                    kept.append((ch, pl))
            events = kept
        orig(rx_side, events)

    hub._deliver = deliver
    payloads = [b"retransmit me blindly"]
    results, hub, senders, _ = await _run_sessions(
        B, payloads, hub=hub, timeout_ms=4000)
    assert results == payloads
    assert dropped, "the data frame never decoded"
    assert senders[0].get_statistics().packets_retransmitted >= 1


async def test_blind_back_to_back_controls_in_order():
    """Several short frames per channel in quick succession must
    deliver in wire order (per-channel FIFO delivery — body decodes
    of different lengths resolve at different feeds)."""
    B = 2
    hub = BlindSoftFarmHub(DEFAULT_FSK_CONFIG, B)
    pump = asyncio.ensure_future(hub.run())
    try:
        cha = [hub.channel("a", i) for i in range(B)]
        chb = [hub.channel("b", i) for i in range(B)]
        seqs = [[bytes([10 + i]), b"longer frame body %d" % i,
                 bytes([20 + i]), bytes([30 + i])] for i in range(B)]
        want = [b"".join(s) for s in seqs]

        async def collect(i):
            buf = b""
            while len(buf) < len(want[i]):
                buf += await chb[i].demodulate()
            return buf

        readers = [asyncio.ensure_future(collect(i)) for i in range(B)]
        for rep in range(4):
            await asyncio.gather(*[
                cha[i].modulate(seqs[i][rep]) for i in range(B)])
        got = await asyncio.wait_for(asyncio.gather(*readers), 120)
        assert got == want
    finally:
        hub.stop()
        await pump


async def test_blind_status_counts_events():
    hub = BlindSoftFarmHub(DEFAULT_FSK_CONFIG, 2)
    pump = asyncio.ensure_future(hub.run())
    try:
        await hub.channel("a", 0).modulate(b"hello")
        while hub._tx_active():
            await asyncio.sleep(0)
    finally:
        hub.stop()
        await pump
    rx = hub.get_status()["rx"]["b"]
    assert rx["events_detected"] == 1
    assert rx["frames_decoded"] == 1
    assert rx["headers_failed"] == 0
