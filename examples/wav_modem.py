#!/usr/bin/env python
"""Modulate bytes to a .wav file / demodulate bytes from a .wav file —
the CLI analog of the reference demo's real audio endpoints (speaker
output / microphone input, demo/demo.js:403-425).

  python examples/wav_modem.py tx --message "hello" --out hello.wav
  python examples/wav_modem.py rx --in hello.wav
  python examples/wav_modem.py tx --file payload.bin --out p.wav --baud 300

``--stream`` swaps the .wav file for a raw PCM PIPE (the reference's
live microphone/speaker path, demo/demo.js:420-425): tx writes raw
samples to stdout, rx reads them from stdin INCREMENTALLY — fixed
``--chunk``-sample blocks through the carried-state streaming
demodulator (FSKCore.demodulate_data / SoftFrameDecoder.feed), with
decoded bytes flushed as they complete, so it works on an unbounded
live stream, e.g.:

  python examples/wav_modem.py tx --stream --message "hi" |
      python examples/wav_modem.py rx --stream
  arecord -f FLOAT_LE -r 48000 -c 1 -t raw |
      python examples/wav_modem.py rx --stream --fmt float32
"""

import argparse
import sys

sys.path.insert(0, ".")


import numpy as np  # noqa: E402

from webaudio_modem.models.config import FSKConfig  # noqa: E402
from webaudio_modem.models.fsk import FSKCore  # noqa: E402
from webaudio_modem.utils.audio_io import read_wav, write_wav  # noqa: E402


def _rx_stream(core, args) -> int:
    """Incremental demodulation of a live raw-PCM pipe: read fixed
    sample blocks from stdin, feed the carried-state streaming
    demodulator, flush decoded bytes as they complete.  Bounded
    memory, unbounded stream — the reference's microphone receive
    loop (demo/demo.js:420-425) as a UNIX pipe."""
    itemsize = 4 if args.fmt == "float32" else 2
    block = args.chunk * itemsize
    total_samples = 0
    total_bytes = 0
    out = (open(args.file, "wb") if args.file else sys.stdout.buffer)
    try:
        pending = b""   # partial trailing sample across reads
        while True:
            buf = sys.stdin.buffer.read(block)
            data = pending + buf
            usable = len(data) - (len(data) % itemsize)
            raw, pending = data[:usable], data[usable:]
            if raw:
                if args.fmt == "float32":
                    samples = np.frombuffer(raw, np.float32)
                else:
                    samples = np.frombuffer(raw, np.int16) \
                        .astype(np.float32) / 32768.0
                total_samples += len(samples)
                decoded = core.demodulate_data(samples)
                if decoded:
                    total_bytes += len(decoded)
                    out.write(decoded)
                    out.flush()
            if not buf:
                break
    finally:
        if args.file:
            out.close()
    print(f"stream ended: {total_samples} samples in, "
          f"{total_bytes} bytes decoded"
          + (f" -> {args.file}" if args.file else ""),
          file=sys.stderr)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["tx", "rx"])
    ap.add_argument("--message", default="Hello from the batched modem!")
    ap.add_argument("--file", default=None)
    ap.add_argument("--in", dest="wav_in", default=None)
    ap.add_argument("--out", dest="wav_out", default="modem.wav")
    ap.add_argument("--baud", type=int, default=1200)
    ap.add_argument("--fmt", choices=["pcm16", "float32"],
                    default="pcm16")
    ap.add_argument("--soft", action="store_true",
                    help="use the soft FEC physical layer instead of "
                         "the hard UART modem (coded frames, "
                         "docs/FEC.md) — decode with --soft too")
    ap.add_argument("--stream", action="store_true",
                    help="raw PCM over stdin/stdout instead of .wav "
                         "files (live pipe mode)")
    ap.add_argument("--chunk", type=int, default=4800,
                    help="--stream rx: samples per incremental "
                         "demodulator feed")
    args = ap.parse_args()

    config = FSKConfig(baud_rate=args.baud)
    if args.soft:
        from webaudio_modem.models import SoftModemCore

        core = SoftModemCore(config)
    else:
        core = FSKCore(config)

    if args.mode == "tx":
        data = (open(args.file, "rb").read() if args.file
                else args.message.encode())
        sig = np.asarray(core.modulate_data(data))
        if args.stream:
            pcm = (sig.astype(np.float32) if args.fmt == "float32" else
                   np.clip(sig * 32767.0, -32768, 32767)
                   .astype(np.int16))
            sys.stdout.buffer.write(pcm.tobytes())
            sys.stdout.buffer.flush()
            print(f"streamed {len(data)} bytes -> {len(sig)} samples "
                  f"({args.fmt} raw PCM)", file=sys.stderr)
            return 0
        write_wav(args.wav_out, sig, config.sample_rate, fmt=args.fmt)
        print(f"wrote {args.wav_out}: {len(data)} bytes -> "
              f"{len(sig)} samples ({len(sig) / config.sample_rate:.2f}s "
              f"at {args.baud} baud, {args.fmt})")
        return 0

    if args.stream:
        return _rx_stream(core, args)

    if not args.wav_in:
        print("rx needs --in <file.wav>", file=sys.stderr)
        return 2
    samples, rate = read_wav(args.wav_in)
    if rate != config.sample_rate:
        print(f"note: file is {rate} Hz, config expects "
              f"{config.sample_rate} Hz — configure accordingly",
              file=sys.stderr)
    decoded = core.demodulate_data(samples)
    status = core.get_status()
    print(f"decoded {len(decoded)} bytes "
          f"(syncs={status['sync_detections']}): {decoded!r}")
    if args.file:
        open(args.file, "wb").write(decoded)
        print(f"wrote {args.file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
