#!/usr/bin/env python
"""Batched modem farm demo (BASELINE config 5): N independent 48 kHz FSK
streams demodulated with carried filter/NCO state, chunked streaming.

  python examples/farm_demo.py --channels 256 --baud 300
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


import numpy as np  # noqa: E402

from webaudio_modem.models.config import FSKConfig  # noqa: E402
from webaudio_modem.models.farm import ModemFarm  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--baud", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=4800)
    ap.add_argument("--group", type=int, default=0,
                    help="chunks per dispatch (throughput mode via "
                         "ModemFarm.demodulate_stream; 0 = per-chunk "
                         "interactive loop)")
    args = ap.parse_args()

    config = FSKConfig(baud_rate=args.baud, mark_frequency=1270,
                       space_frequency=1070)
    farm = ModemFarm(config, args.channels, donate=False)

    # distinct per-channel payloads, equal length
    msgs = [bytes([i & 0xFF, (i >> 8) & 0xFF, 0x42]) for i in
            range(args.channels)]
    signals = np.asarray(farm.modulate(msgs))
    print(f"{args.channels} channels x {signals.shape[1]} samples "
          f"({signals.shape[1] / config.sample_rate:.2f}s of audio each)")

    t0 = time.time()
    if args.group > 1:
        decoded = farm.demodulate_stream(signals, chunk_size=args.chunk,
                                         group=args.group)
    else:
        decoded = farm.demodulate(signals, chunk_size=args.chunk)
    wall = time.time() - t0
    ok = sum(1 for d, m in zip(decoded, msgs) if d == m)
    audio = signals.shape[1] / config.sample_rate
    print(f"decoded {ok}/{args.channels} channels exactly in {wall:.2f}s "
          f"({args.channels * audio / wall:.0f} realtime channels)")
    status = farm.get_status()
    print(f"sync detections: {status['sync_detections'].sum()}, "
          f"EOD events: {status['eod_events'].sum()}")


if __name__ == "__main__":
    main()
