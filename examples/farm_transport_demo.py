"""Farm-scale transport demo: N concurrent XModem sessions over ONE
batched modem farm per direction (the BASELINE north-star topology).

Each of N independent "wires" carries a full ARQ session — sender and
receiver transports, FSK audio both ways, AWGN — while the DSP for all
wires runs as single [N, T] batched kernel dispatches and the decoded
byte streams are parsed by the native C++ deframer.

    JAX_PLATFORMS=cpu python examples/farm_transport_demo.py -n 64
"""

import argparse
import asyncio
import sys
import time

sys.path.insert(0, ".")


from webaudio_modem.models.config import FSKConfig  # noqa: E402
from webaudio_modem.runtime.farm_channel import FarmLoopbackHub  # noqa: E402
from webaudio_modem.transports.xmodem import XModemTransport  # noqa: E402
from webaudio_modem.utils.trace import metrics  # noqa: E402


def awgn(noise_power: float, seed: int = 0):
    # single AWGN model shared with the sim layer (sim/channels.py)
    from webaudio_modem.sim import make_awgn_channel

    return make_awgn_channel(noise_power, seed=seed)


async def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--sessions", type=int, default=64)
    ap.add_argument("--noise", type=float, default=1e-4)
    ap.add_argument("--payload", type=int, default=96,
                    help="bytes per session")
    ap.add_argument("--baud", type=int, default=1200)
    args = ap.parse_args()

    config = FSKConfig(baud_rate=args.baud)
    hub = FarmLoopbackHub(config, args.sessions, quantum=4800,
                          channel_fn=awgn(args.noise))
    payloads = [bytes([i & 0xFF]) + f"session {i:04d} ".encode()
                + bytes((i + j) & 0xFF for j in range(args.payload))
                for i in range(args.sessions)]

    senders = [XModemTransport(hub.channel("a", i))
               for i in range(args.sessions)]
    receivers = [XModemTransport(hub.channel("b", i))
                 for i in range(args.sessions)]
    for t in senders + receivers:
        t.configure({"timeout_ms": 120000})

    print(f"{args.sessions} concurrent XModem sessions, "
          f"{args.payload + 14} B payload each, {args.baud} baud, "
          f"noise={args.noise} "
          f"(native deframer: {hub.get_status()['native_deframer']})")
    t0 = time.time()
    pump = asyncio.ensure_future(hub.run())
    try:
        recv_tasks = [asyncio.ensure_future(r.receive_data())
                      for r in receivers]
        await asyncio.sleep(0)
        await asyncio.gather(*(s.send_data(p)
                               for s, p in zip(senders, payloads)))
        results = await asyncio.gather(*recv_tasks)
    finally:
        hub.stop()
        await pump
    wall = time.time() - t0

    ok = results == payloads
    total = sum(len(p) for p in payloads)
    audio = hub.steps * hub.quantum / config.sample_rate
    retrans = sum(s.get_statistics().packets_retransmitted
                  for s in senders)
    print(f"result: {'ALL OK' if ok else 'MISMATCH'} — {total} bytes "
          f"across {args.sessions} sessions in {wall:.1f}s wall "
          f"({audio:.1f}s simulated audio, {hub.steps} quanta, "
          f"{retrans} retransmits)")
    snap = metrics.snapshot()
    if "farm_hub.chunk" in snap["timings"]:
        t = snap["timings"]["farm_hub.chunk"]
        print(f"farm chunk: {t['count']} dispatches, "
              f"mean {t['mean_ms']:.1f} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(asyncio.run(main()))
