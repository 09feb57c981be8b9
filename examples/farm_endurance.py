"""On-chip farm-transport endurance: N concurrent XModem ARQ sessions
over ONE device-resident hub — the BASELINE north star topology at
full scale (reference analog: one transport per modem node,
core.ts:297-305 x demo/demo.js:233-250, times thousands).

Every session runs the complete Stop-and-Wait protocol (initial NAK,
data packets, ACKs, EOT) over the batched farm wire living in device
HBM (runtime/device_hub.DeviceFarmHub): per audio quantum the host
dispatches one fused pump per direction and receives ONLY the decoded
byte aggregates, drained through the batched C++ deframer.

    python examples/farm_endurance.py --batch 4096 --rounds 3

``--soft`` runs the same topology over the soft-decision FEC wire
(runtime/soft_hub.SoftFarmHub — the FEC memo's receive pipeline at
farm scale; ``--rs-parity`` / ``--body ldpc|turbo`` select the body
coding):

    python examples/farm_endurance.py --soft --batch 1024 --rounds 3

``--blind`` (implies the soft wire) swaps in the fully blind receive
path (runtime/soft_hub.BlindSoftFarmHub): frames are ACQUIRED by the
streaming sync scan and lengths read from decoded headers — no playout
knowledge reaches RX:

    python examples/farm_endurance.py --blind --batch 1024 --rounds 3

Prints per-round results, per-quantum host time (from the metrics
timers), and a final ALL OK / MISMATCH verdict with RSS.  Exits
non-zero on any payload mismatch.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import resource
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))



def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


async def run(batch: int, rounds: int, payload_size: int,
              noise_power: float, quantum: int, ring_quanta: int,
              timeout_ms: float, soft: bool = False,
              rs_parity: int = 0, body: str = "",
              blind: bool = False, stages: bool = False) -> int:
    import jax

    # Persistent compile cache only on an accelerator: XLA:CPU cache
    # (de)serialization has crashed under load (CLAUDE.md "Suite
    # stability").
    if jax.default_backend() != "cpu":
        from webaudio_modem.utils.platform import init_compile_cache

        init_compile_cache()

    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
    from webaudio_modem.runtime.device_hub import DeviceFarmHub
    from webaudio_modem.sim import make_device_awgn
    from webaudio_modem.transports.xmodem import XModemTransport
    from webaudio_modem.utils.trace import metrics

    chan = make_device_awgn(noise_power) if noise_power else None
    soft = soft or blind
    if soft:
        from webaudio_modem.models.config import FSKParams
        from webaudio_modem.ops import soft_fsk
        from webaudio_modem.runtime.soft_hub import SoftFarmHub

        body_code = None
        if body == "ldpc":
            from webaudio_modem.ops.ldpc import default_code
            body_code = default_code()
        elif body == "turbo":
            from webaudio_modem.ops.turbo import TurboCode
            body_code = TurboCode()
        elif body:
            raise SystemExit(f"unknown --body {body!r}")
        # the ring must hold the longest frame (a 133-byte XModem
        # packet) plus a quantum of slack
        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        need = -(-soft_fsk.frame_signal_length(
            params, 133, rs_parity, body_code) // quantum) + 2
        hub_cls = SoftFarmHub
        hub_kwargs = {}
        if blind:
            from webaudio_modem.runtime.soft_hub import \
                BlindSoftFarmHub
            hub_cls = BlindSoftFarmHub
            hub_kwargs["max_payload"] = 160
        hub = hub_cls(
            DEFAULT_FSK_CONFIG, batch, quantum=quantum,
            ring_quanta=max(ring_quanta, need),
            device_channel_fn=chan, rs_parity=rs_parity,
            body_code=body_code, **hub_kwargs)
    else:
        hub = DeviceFarmHub(
            DEFAULT_FSK_CONFIG, batch, quantum=quantum,
            ring_quanta=ring_quanta, device_channel_fn=chan)
    kind = (f"{'BLIND ' if blind else ''}soft-FEC "
            f"(rs_parity={rs_parity}, body={body or 'conv'})"
            if soft else "hard-UART")
    print(f"{batch} concurrent XModem sessions over the {kind} wire, "
          f"{payload_size} B payload, "
          f"{DEFAULT_FSK_CONFIG.baud_rate} baud, noise={noise_power} "
          f"(native deframer: {hub._deframers['a'].is_native}, "
          f"ring {hub.ring_len} samples/side)")

    senders = [XModemTransport(hub.channel("a", i)) for i in range(batch)]
    receivers = [XModemTransport(hub.channel("b", i))
                 for i in range(batch)]
    # generous timeout during warmup (cold compiles stall wall time);
    # the configured timeout applies from round 1
    for t in (senders[0], receivers[0]):
        t.configure({"timeout_ms": 600000})

    pump = asyncio.ensure_future(hub.run())
    ok = True
    total_bytes = 0
    retx = 0

    # Warmup: one single-session transfer compiles every jitted path
    # (pump, control + packet synth lengths, ring writes) BEFORE the
    # fleet starts — otherwise cold-start compile stalls eat the ARQ
    # wall-clock timeouts and push every session into timeout storms.
    warm_rx = asyncio.ensure_future(receivers[0].receive_data())
    await asyncio.sleep(0)
    await senders[0].send_data(bytes(payload_size))
    assert await warm_rx == bytes(payload_size)
    print(f"  warmup transfer OK ({hub.steps} quanta)", flush=True)
    for t in senders + receivers:
        t.configure({"timeout_ms": timeout_ms})

    t0 = time.perf_counter()
    try:
        for rnd in range(rounds):
            payloads = [bytes([rnd & 0xFF, i & 0xFF, (i >> 8) & 0xFF])
                        + bytes((rnd * 131 + i * 7 + k) & 0xFF
                                for k in range(payload_size - 3))
                        for i in range(batch)]
            t_rnd = time.perf_counter()
            steps0 = hub.steps
            snap_r0 = metrics.snapshot()["timings"] if stages else None
            recv_tasks = [asyncio.ensure_future(r.receive_data())
                          for r in receivers]
            await asyncio.sleep(0)
            send_tasks = [asyncio.ensure_future(s.send_data(p))
                          for s, p in zip(senders, payloads)]
            await asyncio.gather(*send_tasks)
            results = await asyncio.gather(*recv_tasks)
            bad = sum(1 for r, p in zip(results, payloads) if r != p)
            total_bytes += sum(len(p) for p in payloads)
            dt = time.perf_counter() - t_rnd
            print(f"  round {rnd + 1}/{rounds}: "
                  f"{'OK' if bad == 0 else f'{bad} MISMATCHES'} — "
                  f"{batch} transfers in {dt:.1f}s / "
                  f"{hub.steps - steps0} quanta "
                  f"({dt / max(hub.steps - steps0, 1) * 1000:.0f} ms/"
                  f"quantum, RSS {_rss_mb():.0f} MB)", flush=True)
            if stages:
                # per-round stage deltas, normalized per quantum — the
                # steady-state budget without warm-up/compile skew
                snap_r1 = metrics.snapshot()["timings"]
                q = max(hub.steps - steps0, 1)
                deltas = sorted(
                    ((k, v["total_s"]
                      - snap_r0.get(k, {"total_s": 0.0})["total_s"])
                     for k, v in snap_r1.items()),
                    key=lambda kv: -kv[1])
                print("    stages ms/q: " + "  ".join(
                    f"{k.split('.', 1)[-1]}={v / q * 1e3:.1f}"
                    for k, v in deltas[:9] if v > 0.0005), flush=True)
            if bad:
                ok = False
                break
    finally:
        hub.stop()
        await pump

    wall = time.perf_counter() - t0
    retx = sum(s.get_statistics().packets_retransmitted for s in senders)
    snap = metrics.snapshot()["timings"]

    def t_ms(name):
        agg = snap.get(name)
        return (f"{agg['mean_ms']:.2f} ms mean / {agg['max_ms']:.1f} ms "
                f"max over {agg['count']}") if agg else "n/a"

    audio_s = hub.steps * quantum / DEFAULT_FSK_CONFIG.sample_rate
    print(f"result: {'ALL OK' if ok else 'MISMATCH'} — "
          f"{total_bytes} bytes across {batch} sessions x {rounds} "
          f"rounds in {wall:.1f}s wall ({audio_s:.1f}s simulated audio, "
          f"{retx} retransmits, RSS {_rss_mb():.0f} MB)")
    print(f"host tx/launch per direction-quantum: "
          f"{t_ms('farm_hub.host_tx')}")
    print(f"host drain per direction-quantum:    "
          f"{t_ms('farm_hub.host_drain')}")
    if snap.get("farm_hub.fetch_wait"):
        print(f"device fetch wait per finalize:      "
              f"{t_ms('farm_hub.fetch_wait')}")
    print(f"dispatch+drain (chunk) per direction-quantum: "
          f"{t_ms('farm_hub.chunk')}")
    print(f"event-loop yield pump per quantum:   "
          f"{t_ms('farm_hub.yield_pump')}")

    def total_s(name):
        agg = snap.get(name)
        return agg["mean_ms"] * agg["count"] / 1e3 if agg else 0.0

    budget = {n: total_s(f"farm_hub.{n}") for n in
              ("host_tx", "host_drain", "soft_finalize", "chunk",
               "yield_pump", "fetch_wait")}
    print(f"host budget totals (s): " + ", ".join(
        f"{k}={v:.2f}" for k, v in budget.items())
        + f" | wall {wall:.2f}")
    return 0 if ok else 1


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--payload", type=int, default=40,
                   help="payload bytes per session per round")
    p.add_argument("--noise", type=float, default=1e-4)
    p.add_argument("--quantum", type=int, default=4800)
    p.add_argument("--ring-quanta", type=int, default=16)
    p.add_argument("--timeout-ms", type=float, default=30000)
    p.add_argument("--soft", action="store_true",
                   help="run over the soft-FEC wire "
                        "(runtime/soft_hub.SoftFarmHub)")
    p.add_argument("--stages", action="store_true",
                   help="print per-round stage deltas (ms/quantum)")
    p.add_argument("--blind", action="store_true",
                   help="soft wire with the fully blind receive path "
                        "(runtime/soft_hub.BlindSoftFarmHub)")
    p.add_argument("--rs-parity", type=int, default=0,
                   help="soft wire: concatenated RS parity symbols")
    p.add_argument("--body", default="",
                   help="soft wire body code: ldpc | turbo "
                        "(default: convolutional)")
    args = p.parse_args()
    return asyncio.run(run(args.batch, args.rounds, args.payload,
                           args.noise, args.quantum, args.ring_quanta,
                           args.timeout_ms, soft=args.soft,
                           rs_parity=args.rs_parity, body=args.body,
                           blind=args.blind, stages=args.stages))


if __name__ == "__main__":
    sys.exit(main())
