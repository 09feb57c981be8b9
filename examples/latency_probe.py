"""End-to-end ARQ latency probe — modulate() to payload-delivered.

The reference's implicit latency budget is the WebAudio render
quantum: every DSP hop advances in 128-sample steps, 2.67 ms at
48 kHz (/root/reference/src/core.ts:31,
src/webaudio/processors/fsk-processor.ts:152-167).  This harness puts
a NUMBER on the analog here, on both topologies:

  * the interactive ``FSKProcessor`` path at the reference's own
    128-sample quantum (``--interactive``), and
  * the farm hubs — hard / soft / blind — at their default 4800-sample
    (100 ms) quantum or any ``--quantum`` (``--farm hard|soft|blind``).

One XModem transfer of a single fragment is FIVE signal hops
(initial NAK -> DATA -> ACK -> EOT -> final ACK, xmodem.ts:109-184 /
232-263), so the floor of the audio-time latency is the summed
playout duration of those five signals; everything above the floor is
quantum-granularity + pipeline overhead, reported per hop.  Wall time
per quantum is reported against the realtime budget (quantum/fs).

    python examples/latency_probe.py --interactive
    python examples/latency_probe.py --farm soft --batch 1024
    python examples/latency_probe.py --farm blind --batch 256 --quantum 480
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import numpy as np  # noqa: E402


def _tail_s(config) -> float:
    """Per-signal trailing silence: one byte-time on both wires
    (fsk.ts:389-395 / soft_fsk.frame_signal_length).  A hop's byte
    decodes at its stop bit, BEFORE this tail plays, so the decode
    floor subtracts one tail per hop."""
    from webaudio_modem.models.config import FSKParams

    p = FSKParams.from_config(config)
    return p.bits_per_byte * p.samples_per_bit / config.sample_rate


def _signal_floor_uart(config, payload_size: int) -> tuple:
    """Summed playout seconds of the 5 ARQ hop signals (hard UART),
    and the decode floor (signals minus trailing-silence tails)."""
    from webaudio_modem.models.fsk import FSKCore
    from webaudio_modem.transports.xmodem.packet import XModemPacket
    from webaudio_modem.transports.xmodem.types import ControlType

    core = FSKCore(config)
    ctrl = core.modulate_data(
        XModemPacket.serialize_control(ControlType.NAK)).shape[0]
    data = core.modulate_data(XModemPacket.serialize(
        XModemPacket.create_data(1, bytes(payload_size)))).shape[0]
    full = (4 * ctrl + data) / config.sample_rate
    return full, full - 5 * _tail_s(config)


def _signal_floor_soft(config, payload_size: int, rs_parity: int,
                       body_code) -> tuple:
    """Same floors over the soft-FEC wire (coded frame lengths)."""
    from webaudio_modem.models.config import FSKParams
    from webaudio_modem.ops import soft_fsk

    params = FSKParams.from_config(config)
    ctrl = soft_fsk.frame_signal_length(params, 1, rs_parity, body_code)
    data = soft_fsk.frame_signal_length(params, payload_size + 6,
                                        rs_parity, body_code)
    full = (4 * ctrl + data) / config.sample_rate
    return full, full - 5 * _tail_s(config)


async def interactive_probe(payload_size: int, quantum: int,
                            reps: int) -> dict:
    """Reference-parity topology: two FSKProcessors on a loopback
    AudioGraph at the given quantum (128 = the reference budget)."""
    from webaudio_modem.models.config import FSKConfig
    from webaudio_modem.runtime import AudioGraph, FSKProcessor
    from webaudio_modem.transports.xmodem import XModemTransport

    config = FSKConfig()
    s_proc, r_proc = FSKProcessor("s"), FSKProcessor("r")
    s_proc.configure(config)
    r_proc.configure(config)
    graph = AudioGraph(quantum=quantum)
    graph.connect(s_proc)
    graph.connect(r_proc)
    sender = XModemTransport(s_proc)
    receiver = XModemTransport(r_proc)
    pump = asyncio.ensure_future(graph.run(yield_every=1))

    lat_audio, lat_wall = [], []
    payload = bytes(range(payload_size % 256)) * (payload_size // 256 + 1)
    payload = payload[:payload_size]
    try:
        # warmup: compile every jitted path before timing
        rx = asyncio.ensure_future(receiver.receive_data())
        await asyncio.sleep(0)
        await sender.send_data(payload)
        assert await rx == payload
        t_all0 = time.perf_counter()
        s_all0 = graph.steps
        for _ in range(reps):
            # clock from BEFORE the receiver's initial NAK dispatch —
            # the transfer's first hop
            s0, t0 = graph.steps, time.perf_counter()
            rx = asyncio.ensure_future(receiver.receive_data())
            await asyncio.sleep(0)
            await sender.send_data(payload)
            got = await rx
            s1, t1 = graph.steps, time.perf_counter()
            assert got == payload
            lat_audio.append((s1 - s0) * quantum / config.sample_rate)
            lat_wall.append(t1 - t0)
        wall_all = time.perf_counter() - t_all0
        steps_all = graph.steps - s_all0
    finally:
        graph.stop()
        await pump
    floor, dfloor = _signal_floor_uart(config, payload_size)
    return {
        "topology": f"interactive 2x FSKProcessor, quantum={quantum} "
                    f"({quantum / config.sample_rate * 1e3:.2f} ms)",
        "decode_floor_s": dfloor,
        "audio_latency_s": float(np.mean(lat_audio)),
        "wall_latency_s": float(np.mean(lat_wall)),
        "floor_s": floor,
        "ms_per_quantum": wall_all / max(steps_all, 1) * 1e3,
        "budget_ms": quantum / config.sample_rate * 1e3,
        "quantum": quantum,
        "sample_rate": config.sample_rate,
    }


async def farm_probe(kind: str, batch: int, payload_size: int,
                     quantum: int, reps: int, noise: float) -> dict:
    """Farm topology: B concurrent transfers over one device hub;
    latency = round start -> LAST delivery (cohort completion)."""
    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
    from webaudio_modem.sim import make_device_awgn
    from webaudio_modem.transports.xmodem import XModemTransport

    config = DEFAULT_FSK_CONFIG
    chan = make_device_awgn(noise) if noise else None
    if kind == "hard":
        from webaudio_modem.runtime.device_hub import DeviceFarmHub
        hub = DeviceFarmHub(config, batch, quantum=quantum,
                            ring_quanta=max(16, 80000 // quantum + 2),
                            device_channel_fn=chan)
        floor, dfloor = _signal_floor_uart(config, payload_size)
    else:
        from webaudio_modem.models.config import FSKParams
        from webaudio_modem.ops import soft_fsk
        from webaudio_modem.runtime.soft_hub import (BlindSoftFarmHub,
                                                         SoftFarmHub)
        params = FSKParams.from_config(config)
        need = -(-soft_fsk.frame_signal_length(params, 133, 0, None)
                 // quantum) + 2
        cls = BlindSoftFarmHub if kind == "blind" else SoftFarmHub
        kw = {"max_payload": 160} if kind == "blind" else {}
        hub = cls(config, batch, quantum=quantum,
                  ring_quanta=max(16, need), device_channel_fn=chan,
                  **kw)
        floor, dfloor = _signal_floor_soft(config, payload_size, 0, None)

    senders = [XModemTransport(hub.channel("a", i)) for i in range(batch)]
    receivers = [XModemTransport(hub.channel("b", i))
                 for i in range(batch)]
    for t in senders + receivers:
        t.configure({"timeout_ms": 600000})
    pump = asyncio.ensure_future(hub.run())
    payload = bytes(range(payload_size % 256)) * (payload_size // 256 + 1)
    payload = payload[:payload_size]

    lat_audio, lat_wall = [], []
    t_all0 = time.perf_counter()
    s_all0 = hub.steps
    try:
        # warmup (compiles every jitted path)
        rx = asyncio.ensure_future(receivers[0].receive_data())
        await asyncio.sleep(0)
        await senders[0].send_data(payload)
        assert await rx == payload
        t_all0 = time.perf_counter()
        s_all0 = hub.steps
        for _ in range(reps):
            s0, t0 = hub.steps, time.perf_counter()
            rxs = [asyncio.ensure_future(r.receive_data())
                   for r in receivers]
            await asyncio.sleep(0)
            await asyncio.gather(*(s.send_data(payload) for s in senders))
            got = await asyncio.gather(*rxs)
            s1, t1 = hub.steps, time.perf_counter()
            assert all(g == payload for g in got)
            lat_audio.append((s1 - s0) * quantum / config.sample_rate)
            lat_wall.append(t1 - t0)
    finally:
        hub.stop()
        await pump
    wall_all = time.perf_counter() - t_all0
    steps_all = hub.steps - s_all0
    return {
        "topology": f"{kind} farm hub, B={batch}, quantum={quantum} "
                    f"({quantum / config.sample_rate * 1e3:.1f} ms)",
        "decode_floor_s": dfloor,
        "audio_latency_s": float(np.mean(lat_audio)),
        "wall_latency_s": float(np.mean(lat_wall)),
        "floor_s": floor,
        "ms_per_quantum": wall_all / max(steps_all, 1) * 1e3,
        "budget_ms": quantum / config.sample_rate * 1e3,
        "quantum": quantum,
        "sample_rate": config.sample_rate,
    }


def report(r: dict) -> None:
    over = r["audio_latency_s"] - r["decode_floor_s"]
    print(f"{r['topology']}")
    print(f"  transfer latency (audio time): "
          f"{r['audio_latency_s'] * 1e3:8.1f} ms "
          f"(signal playout {r['floor_s'] * 1e3:.1f} ms, decode floor "
          f"{r['decode_floor_s'] * 1e3:.1f} ms, "
          f"overhead {over * 1e3:.1f} ms = {over * 1e3 / 5:.1f} ms/hop "
          f"over 5 hops)")
    print(f"  transfer latency (wall):       "
          f"{r['wall_latency_s'] * 1e3:8.1f} ms")
    print(f"  host+device per quantum:       "
          f"{r['ms_per_quantum']:8.2f} ms "
          f"(realtime budget {r['budget_ms']:.2f} ms -> "
          f"{'REALTIME' if r['ms_per_quantum'] <= r['budget_ms'] else 'over budget'}, "
          f"{r['budget_ms'] / r['ms_per_quantum']:.2f}x)")


async def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--farm", choices=["hard", "soft", "blind"])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--payload", type=int, default=32)
    p.add_argument("--quantum", type=int, default=0,
                   help="0 = topology default (128 interactive, "
                        "4800 farm)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--noise", type=float, default=0.0)
    args = p.parse_args()
    if not args.interactive and not args.farm:
        args.interactive = True
    if args.interactive:
        q = args.quantum or 128
        report(await interactive_probe(args.payload, q, args.reps))
    if args.farm:
        q = args.quantum or 4800
        report(await farm_probe(args.farm, args.batch, args.payload, q,
                                args.reps, args.noise))
    return 0


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
