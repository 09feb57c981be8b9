"""Isolated host-bookkeeping cost of the blind receiver at farm scale.

The blind receiver's device programs are measured by ``bench.py
--family blind``; this harness times ONLY the host pipeline stages
(``_collect_events`` / ``_dispatch_headers`` / ``_finalize_headers`` /
``_finalize_bodies`` / ``_emit_ready``) under the WORST-CASE arrival
pattern: cohort-aligned frames, i.e. all B channels close a sync event
in the same quantum (what a farm ARQ flood produces — every session
transmits its packet in the same direction-quantum).

Device work is stubbed out: detector emits are injected as numpy
planes and the header/body programs are replaced with hosts-side
constants, so the timers see pure Python/numpy bookkeeping.  Run on
any backend (forces CPU; no chip needed):

    python examples/blind_host_cost.py --batch 4096 --reps 20
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


import numpy as np  # noqa: E402


def run(B: int, reps: int) -> dict:
    from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                  FSKParams)
    from webaudio_modem.ops import soft_fsk
    from webaudio_modem.ops.soft_blind import BlindSoftBatchReceiver

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    quantum = 4800
    rx = BlindSoftBatchReceiver(params, B, quantum, max_payload=160)
    n_ds = rx._n_ds
    ln = 133                               # XModem packet
    h_span = soft_fsk.HEADER_CODED_BITS * params.ds_samples_per_bit

    # header/body program stubs: every channel found, length ln,
    # start ds//4 (host-resident numpy outs — np.asarray is free)
    found = np.ones((B,), bool)
    lns = np.full((B,), ln, np.int32)
    sts = np.full((B,), params.ds_samples_per_bit // 4, np.int32)
    packed = np.zeros((B, ln + 1), np.uint8)
    packed[:, ln] = 1
    rx._header_prog = lambda *a, **k: (found, lns, sts)
    rx._get_body_prog = lambda _ln: (lambda *a, **k: packed)

    # cohort-aligned worst case: ALL B channels close an event in the
    # same quantum (phase-2 closes), peaks mid-quantum
    emit_none = np.zeros((B,), bool)
    pos_none = np.zeros((B,), np.int32)
    emit_all = np.ones((B,), bool)

    timings: dict = {k: [] for k in
                     ("collect", "disp_hdr", "fin_hdr", "disp_body",
                      "fin_body", "emit", "total")}
    K_b = rx._K_b(ln)
    for rep in range(reps):
        # one cohort per ring cycle so slots never recycle mid-decode
        q = rx._fed + 2
        pos_all = (q * n_ds + n_ds // 2
                   + np.arange(B, dtype=np.int32) % 3)
        rx._pend_detect.append((q, (emit_none, pos_none,
                                    emit_all, pos_all)))
        rx._fed = q + 1

        t0 = time.perf_counter()
        rx._collect_events()
        t1 = time.perf_counter()
        # make the group due: advance fed past q + K_h - 2 and q + 2
        rx._fed = q + max(rx._K_h, 4)
        rx._dispatch_headers()
        t2 = time.perf_counter()
        rx._fed += 1
        rx._finalize_headers()
        t3 = time.perf_counter()
        rx._fed = q + K_b + 2
        rx._dispatch_bodies()
        t4 = time.perf_counter()
        rx._fed += 1
        rx._finalize_bodies()
        t5 = time.perf_counter()
        got = rx._emit_ready()
        t6 = time.perf_counter()
        assert len(got) == B, (rep, len(got))

        if rep >= 2:                       # skip warmup reps
            for k, a, b in (("collect", t0, t1), ("disp_hdr", t1, t2),
                            ("fin_hdr", t2, t3), ("disp_body", t3, t4),
                            ("fin_body", t4, t5), ("emit", t5, t6),
                            ("total", t0, t6)):
                timings[k].append((b - a) * 1e3)

    means = {k: float(np.mean(v)) for k, v in timings.items()}
    print(f"B={B} cohort-aligned (all {B} channels close an event in "
          f"one quantum), payload={ln} B, {reps - 2} timed reps")
    for k in ("collect", "disp_hdr", "fin_hdr", "disp_body",
              "fin_body", "emit", "total"):
        print(f"  {k:10s} {means[k]:8.2f} ms/cohort-quantum "
              f"({means[k] / B * 1e3:6.2f} us/event)")
    assert rx.frames_decoded == (reps) * B
    return means


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--reps", type=int, default=12)
    args = p.parse_args()
    run(args.batch, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
