#!/usr/bin/env python
"""CLI demo — the analog of the reference Vue demo (demo/demo.js):
bring up two modem stations on a simulated loopback audio hub and
transfer text (or any file) over the XModem transport, with progress
events and transport statistics.

Usage:
  python examples/demo.py                         # default text message
  python examples/demo.py --message "hi there"
  python examples/demo.py --file path/to/payload.bin
  python examples/demo.py --noise 1e-4 --baud 300
  python examples/demo.py --fec                   # convolutional FEC framing
"""

import argparse
import asyncio
import sys
import time

sys.path.insert(0, ".")


from webaudio_modem.models.config import FSKConfig  # noqa: E402
from webaudio_modem.runtime import AudioGraph, FSKProcessor  # noqa: E402
from webaudio_modem.sim import make_awgn_channel  # noqa: E402
from webaudio_modem.transports.xmodem import XModemTransport  # noqa: E402


async def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--message", default="Hello from the batched modem!")
    ap.add_argument("--file", default=None)
    ap.add_argument("--baud", type=int, default=1200)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="AWGN noise power on the hub")
    ap.add_argument("--quantum", type=int, default=512)
    ap.add_argument("--fec", action="store_true",
                    help="wrap the payload in a convolutional FEC frame "
                         "(rate-1/2 K=7 + Viterbi, docs/FEC.md)")
    ap.add_argument("--soft", action="store_true",
                    help="replace the hard UART modem with the soft "
                         "FEC physical layer (SoftModemCore: coded "
                         "frames, no start/stop bits, docs/FEC.md)")
    args = ap.parse_args()
    if args.soft and args.fec:
        ap.error("--soft already codes every frame; drop --fec")

    payload = (open(args.file, "rb").read() if args.file
               else args.message.encode())
    if args.fec:
        from webaudio_modem.transports.fec_frame import FrameEncoder

        data = FrameEncoder.encode_frame(payload)
        print(f"FEC framing: {len(payload)} B payload -> {len(data)} B "
              f"coded frame")
    else:
        data = payload
    config = FSKConfig(baud_rate=args.baud)

    # system bring-up (demo.js initializeSystem, :210-266)
    if args.soft:
        from webaudio_modem.models import SoftModemCore

        sender_proc = FSKProcessor(name="sender", core=SoftModemCore())
        receiver_proc = FSKProcessor(name="receiver",
                                     core=SoftModemCore())
    else:
        sender_proc = FSKProcessor(name="sender")
        receiver_proc = FSKProcessor(name="receiver")
    sender_proc.configure(config)
    receiver_proc.configure(config)
    channel_fn = make_awgn_channel(args.noise) if args.noise else None
    graph = AudioGraph(quantum=args.quantum, channel_fn=channel_fn)
    graph.connect(sender_proc)
    graph.connect(receiver_proc)

    sender = XModemTransport(sender_proc)
    receiver = XModemTransport(receiver_proc)
    for t in (sender, receiver):
        t.configure({"timeout_ms": 30000, "max_retries": 5})

    receiver.on("fragmentReceived", lambda ev: print(
        f"  fragment {ev.data['seq_num']}: "
        f"{ev.data['total_bytes_received']} bytes received"))

    print(f"transferring {len(data)} bytes at {args.baud} baud "
          f"(noise power {args.noise})...")
    t0 = time.time()
    drive = asyncio.ensure_future(graph.run())
    try:
        send_task = asyncio.ensure_future(sender.send_data(data))
        received = await receiver.receive_data()
        await send_task
    finally:
        graph.stop()
        await drive
    wall = time.time() - t0

    if args.fec:
        from webaudio_modem.transports.fec_frame import FrameDecoder

        frames = FrameDecoder().process(received)
        received = frames[0] if frames else b""
        ok = received == payload
    else:
        ok = received == data
    audio_seconds = graph.steps * args.quantum / config.sample_rate
    print(f"result: {'OK' if ok else 'MISMATCH'} — {len(received)} bytes "
          f"in {wall:.2f}s wall ({audio_seconds:.1f}s simulated audio)")
    stats = sender.get_statistics()
    print(f"sender stats: {stats.packets_sent} packets, "
          f"{stats.packets_retransmitted} retransmitted, "
          f"{stats.bytes_transferred} bytes")
    from webaudio_modem.utils.trace import metrics
    snap = metrics.snapshot()
    print(f"metrics: {snap['counters']}")
    if "farm.chunk" in snap["timings"]:
        print(f"farm.chunk: {snap['timings']['farm.chunk']}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(asyncio.run(main()))
