#!/usr/bin/env python
"""BER-vs-SNR sweep (BASELINE config 2): Bell-202-style 1200 baud over
AWGN, device demodulator vs the golden bit-exact comparator on
identical noise.

  python examples/ber_sweep.py --snrs 30 25 20 15 10 5 --messages 64
  python examples/ber_sweep.py --soft --snrs 10 8 6 4 2 0   # frame-success:
      hard UART modem vs the soft-decision FSK+FEC physical path
"""

import argparse
import sys

sys.path.insert(0, ".")


from webaudio_modem.models.config import FSKConfig  # noqa: E402
from webaudio_modem.sim.ber import (ber_sweep,  # noqa: E402
                                        golden_demodulate)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--snrs", type=float, nargs="+",
                    default=[30, 25, 20, 15, 10])
    ap.add_argument("--messages", type=int, default=32)
    ap.add_argument("--golden", action="store_true",
                    help="also run the (slow) golden comparator")
    ap.add_argument("--baud", type=int, default=1200)
    ap.add_argument("--mark", type=float, default=1200.0)
    ap.add_argument("--space", type=float, default=2200.0)
    ap.add_argument("--soft", action="store_true",
                    help="frame-success sweep: hard UART modem vs the "
                         "soft FSK+FEC physical path (docs/FEC.md)")
    ap.add_argument("--payload", type=int, default=20)
    ap.add_argument("--rs", type=int, default=0, metavar="PARITY",
                    help="with --soft: add a concatenated RS-outer "
                         "column (rs_parity bytes, docs/FEC.md)")
    ap.add_argument("--body", choices=["ldpc", "turbo"],
                    help="with --soft: add a column where the frame "
                         "body uses this block code (docs/FEC.md)")
    args = ap.parse_args()
    if (args.rs or args.body) and not args.soft:
        ap.error("--rs/--body are columns of the --soft sweep")

    if args.soft:
        return soft_sweep(args)

    config = FSKConfig(baud_rate=args.baud, mark_frequency=args.mark,
                       space_frequency=args.space)
    print(f"config: {args.baud} baud, mark {args.mark} / space {args.space}")
    device = ber_sweep(config, args.snrs,
                       messages_per_point=args.messages)
    golden = (ber_sweep(config, args.snrs,
                        messages_per_point=args.messages,
                        demodulate=golden_demodulate(config))
              if args.golden else None)

    hdr = f"{'SNR dB':>8} {'BER(dev)':>12} {'FER(dev)':>10}"
    if golden:
        hdr += f" {'BER(gold)':>12} {'FER(gold)':>10}"
    print(hdr)
    for i, p in enumerate(device):
        row = f"{p.snr_db:>8.1f} {p.ber:>12.5f} {p.fer:>10.3f}"
        if golden:
            row += f" {golden[i].ber:>12.5f} {golden[i].fer:>10.3f}"
        print(row)


def soft_sweep(args):
    import numpy as np

    from webaudio_modem.models.config import FSKConfig, FSKParams
    from webaudio_modem.models.fsk import FSKCore
    from webaudio_modem.ops import soft_fsk

    config = FSKConfig(baud_rate=args.baud, mark_frequency=args.mark,
                       space_frequency=args.space)
    params = FSKParams.from_config(config)
    payload = bytes((i * 29 + 3) & 0xFF for i in range(args.payload))
    soft_sig = soft_fsk.encode_frame_signal(params, payload)
    print(f"soft FSK+FEC vs hard UART, {args.payload} B payload, "
          f"{args.messages} frames/point, {args.baud} baud")

    def add_noise(sig, snr_db, rng):
        power = float(np.mean(np.asarray(sig, np.float64) ** 2))
        amp = np.sqrt(3 * power / (10 ** (snr_db / 10)))
        noise = amp * (rng.uniform(size=len(sig)) * 2 - 1)
        return (np.asarray(sig) + noise).astype(np.float32)

    rs_sig = (soft_fsk.encode_frame_signal(params, payload,
                                           rs_parity=args.rs)
              if args.rs else None)
    body_code = None
    if args.body == "ldpc":
        from webaudio_modem.ops.ldpc import default_code
        body_code = default_code(n=648, wc=3, wr=6)
    elif args.body == "turbo":
        from webaudio_modem.ops.turbo import default_code
        body_code = default_code(K=256)
    body_sig = (soft_fsk.encode_frame_signal(params, payload,
                                             body_code=body_code)
                if body_code else None)
    hdr = f"{'SNR dB':>8} {'soft+FEC FSR':>14} {'hard UART FSR':>14}"
    if args.rs:
        hdr += f" {'+RS(%d) FSR' % args.rs:>14}"
    if body_code:
        hdr += f" {'%s-body FSR' % args.body:>14}"
    print(hdr)
    for snr in args.snrs:
        rng = np.random.RandomState(1000 + int(snr * 10))
        # the RS / body columns draw from their OWN streams so the
        # soft/hard columns print identical values with or without them
        rng_rs = np.random.RandomState(5000 + int(snr * 10))
        rng_body = np.random.RandomState(9000 + int(snr * 10))
        s_ok = h_ok = r_ok = b_ok = 0
        for _ in range(args.messages):
            s_ok += soft_fsk.decode_frame_signal(
                params, add_noise(soft_sig, snr, rng)) == payload
            core = FSKCore(config)
            h_ok += core.demodulate_data(
                add_noise(core.modulate_data(payload), snr, rng)) == payload
            if args.rs:
                r_ok += soft_fsk.decode_frame_signal(
                    params, add_noise(rs_sig, snr, rng_rs),
                    rs_parity=args.rs) == payload
            if body_code:
                b_ok += soft_fsk.decode_frame_signal(
                    params, add_noise(body_sig, snr, rng_body),
                    body_code=body_code) == payload
        row = (f"{snr:>8.1f} {s_ok / args.messages:>14.2f} "
               f"{h_ok / args.messages:>14.2f}")
        if args.rs:
            row += f" {r_ok / args.messages:>14.2f}"
        if body_code:
            row += f" {b_ok / args.messages:>14.2f}"
        print(row)


if __name__ == "__main__":
    main()
