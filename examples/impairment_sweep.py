#!/usr/bin/env python
"""Impairment tolerance curves: carrier offset & sample-clock skew.

The reference declares ``SignalQuality.carrierOffset`` /
``timingJitter`` (core.ts:10-16) but never feeds or tests them; these
sweeps document the tolerance envelopes of both physical layers here
(hard UART and soft FEC), optionally with the golden scalar comparator
on identical impaired signals (hard path only).

  python examples/impairment_sweep.py                      # both curves
  python examples/impairment_sweep.py --golden             # + comparator
  python examples/impairment_sweep.py --soft               # soft FEC layer
  python examples/impairment_sweep.py --snr 15             # noisier floor
"""

import argparse
import sys

sys.path.insert(0, ".")


from webaudio_modem.models.config import FSKConfig  # noqa: E402
from webaudio_modem.sim.ber import golden_demodulate  # noqa: E402
from webaudio_modem.sim.impairments import (  # noqa: E402
    carrier_offset_sweep, clock_skew_sweep)


def table(name, unit, runs):
    cols = list(runs)
    print(f"\n{name}")
    print("| " + unit + " | " + " | ".join(
        f"{c} FER | {c} BER" for c in cols) + " |")
    print("|---:" + "|---:|---:" * len(cols) + "|")
    for i, p in enumerate(runs[cols[0]]):
        row = [f"| {p.value:g} "]
        for c in cols:
            q = runs[c][i]
            row.append(f"| {q.fer:.3f} | {q.ber:.5f} ")
        print("".join(row) + "|")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--offsets", type=float, nargs="+",
                    default=[0, 10, 20, 30, 40, 50, 60, 80, 100])
    ap.add_argument("--skews", type=float, nargs="+",
                    default=[0, 0.001, 0.002, 0.005, 0.008, 0.01,
                             0.015, 0.02])
    ap.add_argument("--messages", type=int, default=16)
    ap.add_argument("--payload", type=int, default=4)
    ap.add_argument("--snr", type=float, default=30.0)
    ap.add_argument("--baud", type=int, default=1200)
    ap.add_argument("--golden", action="store_true",
                    help="add the golden comparator column (hard path)")
    ap.add_argument("--soft", action="store_true",
                    help="sweep the soft FEC physical layer instead")
    args = ap.parse_args()
    if args.golden and args.soft:
        ap.error("--golden compares the hard path only")

    config = FSKConfig(baud_rate=args.baud)
    message = bytes((37 * k + 11) & 0xFF for k in range(args.payload))
    layer = "soft FEC" if args.soft else "hard UART"
    print(f"{layer} layer, {args.baud} baud, mark "
          f"{config.mark_frequency:g} / space "
          f"{config.space_frequency:g} Hz, {args.messages} x "
          f"{args.payload} B messages / point, SNR {args.snr:g} dB")

    kw = dict(message=message, messages_per_point=args.messages,
              snr_db=args.snr, soft=args.soft)
    runs = {"device": carrier_offset_sweep(config, args.offsets, **kw)}
    if args.golden:
        runs["golden"] = carrier_offset_sweep(
            config, args.offsets,
            demodulate=golden_demodulate(config), **kw)
    table("Carrier offset (TX tones shifted +df, RX nominal)", "df (Hz)",
          runs)

    runs = {"device": clock_skew_sweep(config, args.skews, **kw)}
    if args.golden:
        runs["golden"] = clock_skew_sweep(
            config, args.skews,
            demodulate=golden_demodulate(config), **kw)
    table("Receiver clock skew (eps fractional)", "eps", runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
