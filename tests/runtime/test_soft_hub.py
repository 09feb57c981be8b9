"""SoftFarmHub: farm-scale ARQ over the soft-decision FEC physical
layer, wire in device HBM (the FEC memo's receive pipeline at the
BASELINE north-star topology — advanced-error-correction.md receive
flow x one-transport-per-node, core.ts:297-305 / demo/demo.js:233-250).

CPU-sized checks; the at-scale run lives in examples/farm_endurance.py
--soft (on chip)."""

import asyncio

import numpy as np
import pytest

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem.runtime.soft_hub import SoftFarmHub
from webaudio_modem.sim import make_device_awgn
from webaudio_modem.transports.xmodem import XModemTransport


async def _run_sessions(B, payloads, hub=None, timeout_ms=60000,
                        **hub_kwargs):
    hub = hub or SoftFarmHub(DEFAULT_FSK_CONFIG, B, **hub_kwargs)
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


async def test_soft_arq_sessions_with_device_awgn():
    """Concurrent XModem sessions over FEC-coded frames with ON-DEVICE
    noise: every payload exact, deliveries through the C++ deframer."""
    B = 4
    payloads = [bytes([i]) + f"softhub {i:02d}".encode()
                + bytes(range((i * 5) % 16)) for i in range(B)]
    results, hub, senders, _ = await _run_sessions(
        B, payloads, device_channel_fn=make_device_awgn(1e-4))
    assert results == payloads
    st = hub.get_status()
    assert st["native_deframer"]
    # every session moved at least NAK + DATA + EOT worth of frames
    assert st["frames_decoded"] >= 3 * B
    for s in senders:
        assert s.get_statistics().packets_sent >= 2


async def test_erased_frame_triggers_retransmit_and_recovers():
    """A CRC-erased data frame is a clean erasure: nothing is
    delivered, the ARQ timeout fires and the retransmission completes
    the transfer (failure-recovery parity: xmodem.ts timeout/NAK)."""
    B = 1
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, B)
    # deterministically erase the FIRST data-packet window (payload
    # length 133 = XModem SOH packet) by suppressing its delivery
    orig = hub._finalize
    erased = []

    def finalize(rx_side, group, packed_dev):
        if group.payload_len > 1 and not erased:
            erased.append(group)
            hub.frames_erased += int(group.active.sum())
            return
        orig(rx_side, group, packed_dev)

    hub._finalize = finalize
    payloads = [b"retransmit me"]
    results, hub, senders, _ = await _run_sessions(
        B, payloads, hub=hub, timeout_ms=4000)
    assert results == payloads
    assert erased, "the data window never decoded"
    assert senders[0].get_statistics().packets_retransmitted >= 1
    assert hub.get_status()["frames_erased"] >= 1


async def test_modulate_resolves_on_playout():
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, 2)
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
    # the scheduled window decode delivers the 1-byte control frame
    for _ in range(4):
        hub.step()
        await asyncio.sleep(0)
    hub.flush()
    frame = await asyncio.wait_for(hub.channel("b", 0).next_frame(), 1)
    assert frame.kind == "control" and frame.byte == 0x06


async def test_aborted_modulate_clears_ring_and_suppresses_decode():
    from webaudio_modem.utils.abort import AbortController, AbortError

    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, 2, ring_quanta=32)
    ch = hub.channel("a", 0)
    ctrl = AbortController()
    task = asyncio.ensure_future(ch.modulate(b"X" * 40,
                                             signal=ctrl.signal))
    await asyncio.sleep(0)
    hub.step()          # launches + starts playing
    ctrl.abort()
    with pytest.raises(AbortError):
        await task
    assert not hub.tx_pending("a", 0)
    # everything beyond the already-consumed quantum is silence now
    ring = np.asarray(hub._rings["a"])
    start = hub.steps * hub.quantum
    assert np.abs(ring[0, start:]).max() == 0.0
    # the cancelled row is masked out of its scheduled window decode
    for _ in range(40):
        hub.step()
    hub.flush()
    assert hub.get_status()["frames_decoded"] == 0
    assert hub.channel("b", 0)._frames_q.empty()


async def test_rs_and_ldpc_body_modes_transfer():
    """The hub's coding knobs mirror the soft_fsk surface: a transfer
    completes under the concatenated-RS and LDPC-body modes."""
    from webaudio_modem.ops.ldpc import LDPCCode

    for kwargs in ({"rs_parity": 8},
                   {"body_code": LDPCCode(n=120, wc=3, wr=6)}):
        payloads = [b"coded-mode payload"]
        results, hub, *_ = await _run_sessions(1, payloads, **kwargs)
        assert results == payloads
        st = hub.get_status()
        assert (st["rs_parity"], st["body_code"]) in (
            (8, None), (0, "LDPCCode"))


async def test_undersized_ring_raises():
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, 1, ring_quanta=4)
    ch = hub.channel("a", 0)
    task = asyncio.ensure_future(ch.modulate(bytes(120)))
    await asyncio.sleep(0)
    with pytest.raises(ValueError, match="ring_quanta"):
        hub.step()
    task.cancel()


async def test_back_to_back_controls_arrive_in_order():
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, 1)
    pump = asyncio.ensure_future(hub.run())
    a = hub.channel("a", 0)
    b = hub.channel("b", 0)
    try:
        await a.modulate(b"\x15")   # NAK
        await a.modulate(b"\x06")   # ACK
        kinds = []
        for _ in range(2):
            f = await asyncio.wait_for(b.next_frame(), 10)
            kinds.append(f.byte)
        assert kinds == [0x15, 0x06]
    finally:
        hub.stop()
        await pump


async def test_soft_hub_on_mesh():
    """SoftFarmHub over the 8-device channel mesh (advisor r4): rings
    stay P('channels', None), ARQ payloads exact, and the wire is
    still sharded after the run (a jitted step silently resharding
    to replicated would fail here)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from webaudio_modem.parallel.sharding import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8)
    B = 8
    payloads = [f"mesh softhub {i}".encode() for i in range(B)]
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, B, mesh=mesh,
                      device_channel_fn=make_device_awgn(1e-4))
    ring_sh = NamedSharding(mesh, P("channels", None))
    assert hub._rings["a"].sharding == ring_sh
    results, hub, _, _ = await _run_sessions(B, payloads, hub=hub)
    assert results == payloads
    assert hub._rings["a"].sharding == ring_sh
    assert hub._keys["a"].sharding.is_fully_replicated


async def test_mesh_batch_divisibility_validated():
    """A batch that does not divide the channel mesh fails fast with a
    clear error, not an opaque device_put sharding error (advisor r4)."""
    import jax

    from webaudio_modem.parallel.sharding import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8)
    with pytest.raises(ValueError, match="must divide the mesh"):
        SoftFarmHub(DEFAULT_FSK_CONFIG, 12, mesh=mesh)
    from webaudio_modem.models.config import FSKParams
    from webaudio_modem.ops.soft_blind import BlindSoftBatchReceiver

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    with pytest.raises(ValueError, match="must divide the mesh"):
        BlindSoftBatchReceiver(params, 12, 4800, max_payload=8,
                               mesh=mesh)
