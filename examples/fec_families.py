"""Compare the four FEC families on one AWGN channel.

The reference's error-correction memo
(/root/reference/advanced-error-correction.md) names four algorithm
families: convolutional (畳み込み符号), block/Reed-Solomon, LDPC, and
turbo.  This example runs all four — each batched on the device —
over the same BPSK/AWGN channel and prints a BER / frame-success
table per Eb/N0 point, normalizing for code rate so the comparison is
energy-fair.

Usage:
    python examples/fec_families.py [--points 3 1.5 0 ...] [--frames N]

Runs anywhere (CPU or GPU); on CPU expect ~1 min with defaults.
"""

import argparse
import sys

sys.path.insert(0, ".")


import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=float, nargs="+",
                    default=[4.0, 3.0, 2.0, 1.0],
                    help="Eb/N0 points in dB")
    ap.add_argument("--frames", type=int, default=64,
                    help="frames per family per point")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from webaudio_modem.ops import fec, rs
    from webaudio_modem.ops.ldpc import default_code as ldpc_code
    from webaudio_modem.ops.turbo import default_code as turbo_code

    B = args.frames
    rng = np.random.RandomState(args.seed)

    # --- family adapters: encode K data bits -> coded bits; decode
    # channel LLRs (positive = bit 0) -> K data bits -----------------
    ldpc = ldpc_code(n=648, wc=3, wr=6)
    turbo = turbo_code(K=256)
    CONV_K = 256

    def conv_run(llr, cw, data):
        # soft Viterbi wants bit-1-positive soft values = -llr
        return np.asarray(fec.viterbi_decode_soft(-llr, CONV_K))

    def conv_encode(data):
        return np.asarray(fec.conv_encode_bits_batch(data))

    # RS(64, 48) over GF(256): 8 data bits per symbol; hard-decision
    # bytes from the channel LLRs (RS is the memo's hard block code).
    RS_N, RS_K = 64, 48

    def rs_encode(data_bits):
        by = np.packbits(data_bits.astype(np.uint8), axis=1)
        cw = np.asarray(rs.rs_encode_batch(by, RS_N, RS_K))
        return np.unpackbits(cw.astype(np.uint8), axis=1)

    def rs_run(llr, cw_bits, data_bits):
        hard = (llr < 0).astype(np.uint8)
        by = np.packbits(hard, axis=1)
        dec, ok, _ = rs.rs_decode_batch(by, RS_N, RS_K)
        dec = np.asarray(dec)[:, :RS_K]
        return np.unpackbits(dec.astype(np.uint8), axis=1)

    families = [
        # (name, K data bits, encode, decode)
        ("conv r=1/2 K7", CONV_K, conv_encode, conv_run),
        (f"RS({RS_N},{RS_K}) hard", RS_K * 8, rs_encode, rs_run),
        ("LDPC(648) r~1/2", ldpc.k,
         lambda d: np.asarray(ldpc.encode_batch(d)),
         lambda llr, cw, d: np.asarray(
             ldpc.decode_batch(llr.astype(np.float32))[0])),
        ("turbo r~1/3 K=256", turbo.K,
         lambda d: np.asarray(turbo.encode_batch(d)),
         lambda llr, cw, d: np.asarray(
             turbo.decode_batch(llr.astype(np.float32)))),
    ]

    print(f"{'family':>20} | " +
          " | ".join(f"{p:>5.1f} dB" for p in args.points))
    print("-" * (23 + 11 * len(args.points)))
    for name, K, encode, decode in families:
        data = rng.randint(0, 2, size=(B, K))
        cw = encode(data)
        rate = K / cw.shape[1]
        cells = []
        for ebn0 in args.points:
            sigma = float(np.sqrt(1.0 / (2 * rate * 10 ** (ebn0 / 10))))
            tx = 1.0 - 2.0 * cw.astype(np.float64)
            rx = tx + sigma * rng.standard_normal(tx.shape)
            llr = 2.0 * rx / sigma ** 2
            out = decode(llr, cw, data)
            ber = float((out != data).mean())
            fs = float((out == data).all(axis=1).mean())
            cells.append(f"{ber:.1e}/{fs:.2f}")
        print(f"{name:>20} | " + " | ".join(f"{c:>8}" for c in cells))
    print("\ncells are BER / frame-success over "
          f"{B} frames (rate-normalized Eb/N0)")
    print("note: hard-decision RS is burst armor, not an AWGN code — "
          "see the interleaver burst tests and the concatenated "
          "RS-outer/conv-inner mode (docs/FEC.md)")


if __name__ == "__main__":
    main()
