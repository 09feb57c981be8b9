"""Pure host cost of a farm-hub ARQ round at scale, device stubbed.

The endurance harness measures wall-clock WITH device work and
dispatch; this one isolates the HOST topology cost the
VERDICT r4 weak #1 implicates: ring-write bookkeeping, cohort launch,
drain/delivery, protocol coroutines, and event-loop pumping, for a
full B-session XModem round over the scheduled soft hub — with every
device program replaced by a host stub (ring writes are identity,
window decodes return the exact payload bytes recorded at write time).

If THIS number exceeds the 100 ms audio quantum, no kernel can make
the topology realtime; if it is far under, the gap is device/dispatch
cost.  Run on any backend (forces CPU; no chip needed):

    python examples/farm_host_cost.py --batch 4096
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


import numpy as np  # noqa: E402


def make_stub_hub(batch: int, quantum: int):
    """SoftFarmHub with every device program stubbed on the host."""
    from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                  FSKParams)
    from webaudio_modem.ops import soft_fsk
    from webaudio_modem.runtime.soft_hub import SoftFarmHub

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)

    class StubSoftHub(SoftFarmHub):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            # (side, w) -> {row: payload bytes} recorded at write time
            self._written = {}
            # stub the jitted ring programs: the wire carries no audio
            self._ring_write = lambda ring, sig, mask, woff: ring
            self._ring_write_row = lambda ring, row, mask, woff: ring
            self._ring_clear = lambda ring, keep, coff, w: ring

        def _write_group(self, side, w, t_read, rows, datas, entries,
                         length):
            # RingHubBase._write_group minus the device ops (synth,
            # pad, mask device_put, ring-write dispatches) — on a device
            # those are device compute + ~4 dispatch submissions per
            # cohort, excluded by design here.  Every line of Python
            # bookkeeping is kept 1:1 (defer, busy_until, resolve_at,
            # _on_group_written).
            T = soft_fsk.frame_signal_length(
                params, length, self._rs, self._body)
            Lpad = self._quanta(T)
            if w + Lpad - t_read > self.ring_len:
                self._defer(side, rows, entries)
                return
            mask = np.zeros((self.batch,), np.float32)
            mask[rows] = 1.0
            s_end = (w + T - 1) // self.quantum
            for i, e in zip(rows, entries):
                self._busy_until[side][i] = w + T
                e.cohort = (w, Lpad)
                self._resolve_at[side][s_end].append((i, e))
            self._on_group_written(side, w, Lpad, T, rows, entries,
                                   length)

        def _on_group_written(self, side, w, Lpad, T, rows, entries,
                              length):
            self._written[(side, w, Lpad)] = {
                i: e.data for i, e in zip(rows, entries)}
            super()._on_group_written(side, w, Lpad, T, rows, entries,
                                      length)

        def _dispatch_group(self, tx_side, rx_side, group):
            for i in group.rows:
                hit = self._sched.get((tx_side, i))
                if hit is not None and hit[0] is group:
                    del self._sched[(tx_side, i)]
            if not group.active.any():
                return
            datas = self._written.pop((tx_side, group.w, group.Lpad))
            pl = group.payload_len
            packed = np.zeros((self.batch, pl + 1), np.uint8)
            for i, d in datas.items():
                packed[i, :len(d)] = np.frombuffer(d, np.uint8)
                packed[i, pl] = 1
            self._pending_dec[rx_side].append((group, packed,
                                               self.steps))

    return StubSoftHub(DEFAULT_FSK_CONFIG, batch, quantum=quantum,
                       ring_quanta=24)


async def run(batch: int, rounds: int, payload_size: int,
              quantum: int) -> int:
    from webaudio_modem.transports.xmodem import XModemTransport
    from webaudio_modem.utils.trace import metrics

    hub = make_stub_hub(batch, quantum)
    senders = [XModemTransport(hub.channel("a", i)) for i in range(batch)]
    receivers = [XModemTransport(hub.channel("b", i))
                 for i in range(batch)]
    for t in senders + receivers:
        t.configure({"timeout_ms": 600000})
    pump = asyncio.ensure_future(hub.run())
    ok = True
    t0 = time.perf_counter()
    steps0 = hub.steps
    try:
        for rnd in range(rounds):
            payloads = [bytes([rnd & 0xFF, i & 0xFF, (i >> 8) & 0xFF])
                        + bytes((rnd * 131 + i * 7 + k) & 0xFF
                                for k in range(payload_size - 3))
                        for i in range(batch)]
            rxs = [asyncio.ensure_future(r.receive_data())
                   for r in receivers]
            await asyncio.sleep(0)
            await asyncio.gather(*(s.send_data(p)
                                   for s, p in zip(senders, payloads)))
            got = await asyncio.gather(*rxs)
            bad = sum(1 for g, p in zip(got, payloads) if g != p)
            if bad:
                ok = False
                print(f"  round {rnd + 1}: {bad} MISMATCHES")
    finally:
        hub.stop()
        await pump
    wall = time.perf_counter() - t0
    steps = hub.steps - steps0
    audio = steps * quantum / 48000
    print(f"B={batch} x {rounds} rounds ({payload_size} B payloads), "
          f"device stubbed: {'ALL OK' if ok else 'MISMATCH'}")
    print(f"  host wall {wall:.2f} s for {audio:.2f} s of audio "
          f"({steps} quanta) -> {wall / steps * 1e3:.1f} ms/quantum "
          f"host cost vs the {quantum / 48:.0f} ms budget "
          f"({'REALTIME' if wall < audio else 'OVER'}, "
          f"{audio / wall:.2f}x)")
    snap = metrics.snapshot()["timings"]
    for name in ("farm_hub.host_tx", "farm_hub.host_drain",
                 "farm_hub.soft_finalize", "farm_hub.chunk",
                 "farm_hub.yield_pump", "farm_hub.fetch_wait"):
        agg = snap.get(name)
        if agg:
            total = agg["mean_ms"] * agg["count"] / 1e3
            print(f"  {name.split('.')[1]:12s} "
                  f"{agg['mean_ms']:7.2f} ms mean x {agg['count']:5d} "
                  f"= {total:6.2f} s total")
    return 0 if ok else 1


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--payload", type=int, default=40)
    p.add_argument("--quantum", type=int, default=4800)
    args = p.parse_args()
    return asyncio.run(run(args.batch, args.rounds, args.payload,
                           args.quantum))


if __name__ == "__main__":
    sys.exit(main())
