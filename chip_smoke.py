"""Smoke test of the modem farm on the GPU, through its user entry points.

One process.  Each phase prints what it checked on stdout; the last line
is one JSON object, printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Phases (one card, no arguments):
  device     jax.devices(), the card's name and power limit
  golden     FSKCore == GoldenFSK on clean and 25 dB signals
  farm       ModemFarm, B=4096 channels at 300 baud with distinct
             payloads, streamed in 4800-sample chunks: every channel
             exact, kernel path == lax path (FORCE_LAX_SEQ) byte for byte
  kernels    each Triton kernel against its lax stage at B=4096 on the
             chunks of the farm signal; memory_analysis of the chunk step
  arq        DeviceFarmHub at batch 4096: 256 concurrent XModem
             transfers, all exact; whether the native deframer loaded
  secondary  DBPSK farm, soft farm at 8 dB, LDPC and turbo bodies,
             header LLRs against a host gather, soft-hub and blind-hub
             ARQ
  timings    each kernel against XLA's lax stage, and per chunk at
             B=4096 (profiler trace for device time, host clock with
             block_until_ready end to end, compile time apart)

Options:
  --chips 4  only the channel-sharded path on four cards: a B=4x4096
             sharded demod compared byte for byte with the same channels
             on one card, a sharded hub ARQ transfer, and each shard's
             buffers on its own card
  --sweep    also sweep the lax stages' unroll and the kernels' block
             width (the numbers behind fsk_demod._UNROLL and BLOCK)
  --phases   run a subset of the one-card phases

Exits non-zero, with no result line, when JAX finds no GPU or a phase
fails.  Run from the root of a checkout: ``python chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import glob
import json
import os
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TRACES = os.path.join(REPO, ".traces")     # git-ignored, reduced and removed

B_FARM = 4096                 # the north star's channel count
CHUNK = 4800                  # 0.1 s of 48 kHz audio
ARQ_SESSIONS = 256
TIMED_CALLS = 20
# stage A float streams: atan2 and the biquad sums round differently
# in their last bits on the two routes
RTOL, ATOL = 1e-4, 5e-5
# a sliced bit may differ only where the reference soft value sits
# within this margin of the slicer threshold
SOFT_TIE = 1e-4
# stage D's float carry (silence threshold, rolling amplitude sum): the
# sum starts each chunk from the same fixed-order window sum on both
# routes (fsk_demod._pairwise_sum) and takes the same adds, while the
# threshold (mean * 0.1) divides, which Triton does in float32 without
# IEEE rounding.  Both are held to the float32 bound for summing the
# amp_window positive terms in any order, amp_window * eps, and the
# worst relative difference is printed (phase_kernels)
INTERPRET = False             # True only for CPU rehearsals


def log(msg: str) -> None:
    print(msg, flush=True)


def config_300():
    from webaudio_modem.models.config import FSKConfig

    return FSKConfig(baud_rate=300, mark_frequency=1270,
                     space_frequency=1070)


def payloads(n: int, size: int = 6):
    """Distinct payload per channel."""
    return [bytes([i & 0xFF, (i >> 8) & 0xFF, (i * 37) & 0xFF, 0x5A,
                   (i * 11) & 0xFF, 0xC3])[:size] for i in range(n)]


def _retrace() -> None:
    """Traces read FORCE_LAX_SEQ and _UNROLL once; drop every cached
    trace so the next call reads them again."""
    import jax

    from webaudio_modem.models import farm
    from webaudio_modem.ops import fsk_demod, psk

    fsk_demod.make_demod_chunk.cache_clear()
    psk.make_demod_chunk.cache_clear()
    farm._make_group_runner.cache_clear()
    jax.clear_caches()


@contextlib.contextmanager
def lax_path(unroll: int = 0):
    """The plain version: lax stages, optionally at another unroll."""
    from webaudio_modem.ops import fsk_demod

    prev = fsk_demod.FORCE_LAX_SEQ, fsk_demod._UNROLL
    fsk_demod.FORCE_LAX_SEQ = True
    fsk_demod._UNROLL = unroll or prev[1]
    _retrace()
    try:
        yield
    finally:
        fsk_demod.FORCE_LAX_SEQ, fsk_demod._UNROLL = prev
        _retrace()


def farm_signal(n: int, noise: float = 0.0):
    """[n, T] farm signal of distinct payloads, T padded with silence
    to whole chunks, plus the payloads; ``noise`` adds seeded Gaussian
    noise of that RMS (the carrier's amplitude is 1)."""
    from webaudio_modem.models.config import FSKParams
    from webaudio_modem.ops import fsk_mod

    msgs = payloads(n)
    sig = np.asarray(fsk_mod.modulate_batch(
        FSKParams.from_config(config_300()), msgs))
    pad = -sig.shape[1] % CHUNK + CHUNK       # and one chunk of silence
    sig = np.pad(sig, ((0, 0), (0, pad)))
    if noise:
        sig = sig + noise * np.random.RandomState(5).standard_normal(
            sig.shape)
    return sig.astype(np.float32), msgs


# ---------------------------------------------------------------- phases

def phase_golden():
    from webaudio_modem.golden import GoldenFSK
    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
    from webaudio_modem.models.fsk import FSKCore

    core = FSKCore(DEFAULT_FSK_CONFIG)
    golden = GoldenFSK(DEFAULT_FSK_CONFIG)
    rng = np.random.RandomState(11)
    for data in (b"\x00" * 13, b"Hello, World!", bytes(range(13))):
        sig = core.modulate_data(data)
        assert core.demodulate_data(sig) == golden.demodulate(sig) \
            == data, f"clean mismatch for {data!r}"
        core.reset()
        golden.reset()
        power = float(np.mean(np.asarray(sig, np.float64) ** 2))
        amp = np.sqrt(3 * power / (10 ** 2.5))       # 25 dB SNR
        noisy = (np.asarray(sig)
                 + amp * (rng.uniform(size=len(sig)) * 2 - 1)
                 ).astype(np.float32)
        assert core.demodulate_data(noisy) == golden.demodulate(noisy), \
            f"noisy differential mismatch for {data!r}"
        core.reset()
        golden.reset()
    log("golden: FSKCore == GoldenFSK on 3 payloads, clean and 25 dB")


def phase_farm():
    from webaudio_modem.models.farm import ModemFarm
    from webaudio_modem.ops.pallas import fsk_framing, fsk_seq

    sig, msgs = farm_signal(B_FARM)
    log(f"farm: B={B_FARM} channels, {sig.shape[1]} samples in "
        f"{sig.shape[1] // CHUNK} chunks of {CHUNK}; kernels in the "
        f"path: stage A {fsk_seq.available()}, stage D "
        f"{fsk_framing.available(8)}")
    t0 = time.perf_counter()
    got = ModemFarm(config_300(), B_FARM, donate=False).demodulate(
        sig, chunk_size=CHUNK)
    t_kernel = time.perf_counter() - t0
    bad = sum(1 for g, m in zip(got, msgs) if g != m)
    assert bad == 0, f"{bad}/{B_FARM} channels decoded wrong bytes"
    with lax_path():
        t0 = time.perf_counter()
        ref = ModemFarm(config_300(), B_FARM, donate=False).demodulate(
            sig, chunk_size=CHUNK)
        t_lax = time.perf_counter() - t0
    diff = sum(1 for a, b in zip(got, ref) if a != b)
    assert diff == 0, f"{diff}/{B_FARM} channels differ kernel vs lax"
    log(f"farm: {B_FARM}/{B_FARM} channels exact; kernel path == lax "
        f"path byte for byte on every channel (walls incl. compile: "
        f"kernel {t_kernel:.1f} s, lax {t_lax:.1f} s)")


def _stage_fns(params):
    """Jitted kernel and lax versions of stages A and D on one chunk."""
    import jax

    from webaudio_modem.ops import fsk_demod
    from webaudio_modem.ops.pallas import fsk_framing, fsk_seq

    def seq_kernel(state, x, block=fsk_seq.BLOCK, ahead=fsk_seq.AHEAD):
        fr = (state.agc_gain, state.pre, state.phi, state.iq_i,
              state.iq_q)
        return fsk_seq.seq_main(params, fr, (state.last_phase, state.post),
                                x.T, block=block, ahead=ahead,
                                interpret=INTERPRET)

    def seq_lax(state, x):
        out = fsk_demod._sequential_stage(params, 0, state, x)
        return out[0], out[1], out[4], out[5], out[6]

    def d_inputs(state, bits, amps):
        rsum = fsk_demod.sliding_bit_sums(params, state.bit_tail, bits)
        ratios = fsk_demod._sync_ratios_from_r(params, state.r_tail, rsum)
        ext_amps = jax.numpy.concatenate([state.amp_tail, amps], 0)
        return ratios, ext_amps

    def d_kernel(state, bits, amps, block=fsk_framing.BLOCK,
                 ahead=fsk_framing.AHEAD):
        ratios, ext_amps = d_inputs(state, bits, amps)
        maxb = fsk_demod.max_bytes(params, bits.shape[0])
        carry, (byts, cnt, eod, syn, fire_t) = \
            fsk_framing.stage_d_compact(params, state, bits, amps, ratios,
                                        ext_amps, maxb, block=block,
                                        ahead=ahead, interpret=INTERPRET)
        return carry, byts.astype(jax.numpy.uint8), cnt, eod, syn, fire_t

    def d_lax(state, bits, amps):
        ratios, ext_amps = d_inputs(state, bits, amps)
        maxb = fsk_demod.max_bytes(params, bits.shape[0])
        return fsk_demod.framing_stage(params, state, bits, amps, ratios,
                                       ext_amps, maxb)

    return (jax.jit(seq_kernel, static_argnames=("block", "ahead")),
            jax.jit(seq_lax),
            jax.jit(d_kernel, static_argnames=("block", "ahead")),
            jax.jit(d_lax))


def _check_stage_a(got, ref, tag):
    """Stage A outputs (fr, dsc, bits, amps, softs): float32 streams and
    state within RTOL/ATOL, bits equal except at slicer ties.  Returns
    the number of tied bits that differ."""
    import jax

    as_np = lambda t: [np.asarray(a, np.float32)  # noqa: E731
                       for a in jax.tree.leaves(t)]
    bits_k, bits_l = as_np(got[2])[0], as_np(ref[2])[0]
    softs_l = as_np(ref[4])[0]
    mism = bits_k != bits_l
    worst = float(np.abs(softs_l[mism]).max()) if mism.any() else 0.0
    assert worst <= SOFT_TIE, (
        f"{tag}: {int(mism.sum())} bits differ, one at |soft|={worst:g}"
        f" > {SOFT_TIE:g}")
    for k in (0, 1, 3, 4):          # carried state, amps, softs
        for a, b in zip(as_np(got[k]), as_np(ref[k])):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=tag)
    return int(mism.sum())


def phase_kernels():
    import jax

    from webaudio_modem.models.config import FSKParams
    from webaudio_modem.ops import fsk_demod

    params = FSKParams.from_config(config_300())
    # a noise floor (37 dB below the carrier): in exact digital silence
    # the decaying filter states reach denormals and the discriminator's
    # phase is rounding noise on any route
    sig, _ = farm_signal(B_FARM, noise=0.01)
    d_rtol = params.amp_window * float(np.finfo(np.float32).eps)
    seq_k, seq_l, d_k, d_l = _stage_fns(params)
    step = fsk_demod.make_demod_chunk(params, 0, donate=False)
    state = fsk_demod.init_state(params, B_FARM)
    flips = fires = emits = 0
    d_worst = 0.0
    with lax_path():
        step_lax = fsk_demod.make_demod_chunk(params, 0, donate=False)
        for c in range(sig.shape[1] // CHUNK):
            x = jax.device_put(sig[:, c * CHUNK:(c + 1) * CHUNK])
            ref_a = seq_l(state, x)
            got_a = seq_k(state, x)
            flips += _check_stage_a(got_a, ref_a, f"stage A chunk {c}")
            bits, amps = ref_a[2], ref_a[3]
            ref_d = d_l(state, bits, amps)
            got_d = d_k(state, bits, amps)
            for name, a, b in zip(
                    ("carry", "bytes", "count", "eod", "sync", "fire_t"),
                    got_d, ref_d):
                for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                    u, v = np.asarray(u), np.asarray(v)
                    msg = f"stage D chunk {c}: {name}"
                    if u.dtype == np.float32:
                        rel = np.abs(u - v) / np.maximum(np.abs(v), 1e-30)
                        d_worst = max(d_worst, float(rel.max()))
                        np.testing.assert_allclose(
                            u, v, rtol=d_rtol, atol=0, err_msg=msg)
                    else:
                        np.testing.assert_array_equal(u, v, err_msg=msg)
            fires += int(np.asarray(ref_d[4]).sum())
            emits += int(np.asarray(ref_d[2]).sum())
            state, _ = step_lax(state, x)
    log(f"kernels: stage A (fsk_seq) vs lax scan at B={B_FARM}, "
        f"{sig.shape[1] // CHUNK} chunks of {CHUNK} with a 37 dB noise "
        f"floor: float32 streams "
        f"within rtol={RTOL:g}/atol={ATOL:g}; {flips} sliced bits "
        f"differ, all at |soft| <= {SOFT_TIE:g}")
    log(f"kernels: stage D (fsk_framing) vs lax scan + masked-sum "
        f"compaction on the same streams: bytes, counters, fire "
        f"positions and integer carry exact, float carry within rtol "
        f"{d_rtol:.3g} (worst {d_worst:.3g}; {fires} sync fires, "
        f"{emits} bytes)")
    x = jax.device_put(sig[:, :CHUNK])
    mem = step.lower(fsk_demod.init_state(params, B_FARM), x).compile() \
        .memory_analysis()
    log(f"kernels: chunk step memory_analysis: {mem}")


def phase_arq():
    from webaudio_modem.native import get_lib
    from webaudio_modem.runtime.device_hub import DeviceFarmHub
    from webaudio_modem.transports.xmodem import XModemTransport

    n, payload = ARQ_SESSIONS, 11
    chans = [i * (B_FARM // n) for i in range(n)]

    async def run():
        hub = DeviceFarmHub(config_300(), B_FARM, quantum=CHUNK,
                            ring_quanta=24)
        senders = [XModemTransport(hub.channel("a", c)) for c in chans]
        receivers = [XModemTransport(hub.channel("b", c)) for c in chans]
        for t in senders + receivers:
            t.configure({"timeout_ms": 600000})
        data = [bytes((i + k) & 0xFF for k in range(payload))
                for i in range(n)]
        pump = asyncio.ensure_future(hub.run())
        try:
            recv = [asyncio.ensure_future(r.receive_data())
                    for r in receivers]
            await asyncio.sleep(0)
            await asyncio.gather(*(s.send_data(p)
                                   for s, p in zip(senders, data)))
            results = await asyncio.gather(*recv)
        finally:
            hub.stop()
            await pump
        return (sum(1 for r, p in zip(results, data) if r != p),
                hub.steps, hub.get_status()["native_deframer"])

    t0 = time.perf_counter()
    bad, steps, native = asyncio.run(run())
    assert bad == 0, f"{bad}/{n} ARQ payloads mismatched"
    log(f"arq: DeviceFarmHub batch {B_FARM}: {n}/{n} concurrent XModem "
        f"transfers exact ({steps} quanta, "
        f"{time.perf_counter() - t0:.1f} s); native deframer loaded: "
        f"{get_lib() is not None and native}")


def _soft_farm_run(B, payload, snr_db, key, body_code=None, stride=7):
    import jax
    import jax.numpy as jnp

    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
    from webaudio_modem.ops import soft_fsk

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    data = [bytes((i * stride + k) & 0xFF for k in range(payload))
            for i in range(B)]
    sigs = soft_fsk.encode_frames_batch(params, data, body_code=body_code)
    power = float(jnp.mean(sigs[0].astype(jnp.float32) ** 2))
    amp = np.sqrt(power / (10 ** (snr_db / 10)))
    noise = jax.random.normal(jax.random.PRNGKey(key), sigs.shape,
                              jnp.float32)
    noisy = (sigs + jnp.float32(amp) * noise).astype(jnp.float32)
    out = soft_fsk.decode_frames_batch(params, noisy, payload,
                                       body_code=body_code)
    failed = sum(1 for o, p in zip(out, data) if o != p)
    assert failed == 0, f"{failed}/{B} frames failed at {snr_db:g} dB"
    return params, noisy


def _check_header_llrs(params, noisy, payload):
    """The top-k header selection is a one-hot contraction: on the GPU
    it must not round the LLRs (TF32).  Compare it with a host gather
    of the same windows, which must match exactly."""
    import jax

    from webaudio_modem.ops import soft_fsk

    B = noisy.shape[0]
    state_fn = jax.jit(lambda s: soft_fsk.fsk_demod._sequential_stage(
        params, 0, soft_fsk.fsk_demod.init_state(params, B), s,
        with_rsum=True))
    out = state_fn(noisy)
    body_n = soft_fsk._body_coded_bits(payload)
    t_peak, peak_ok, csum, _, _, _ = soft_fsk._batch_header_stage(
        params, out[4], out[6], body_n, soft_fsk.HEADER_TOP_K, out[7])
    starts, h_llr, valid = jax.jit(
        soft_fsk._candidate_llrs, static_argnums=(0, 4, 5))(
        params, csum, t_peak, peak_ok, body_n, soft_fsk.HEADER_TOP_K)
    csum, starts = np.asarray(csum), np.asarray(starts)
    h_llr, valid = np.asarray(h_llr), np.asarray(valid)
    ds = params.ds_samples_per_bit
    wsum = np.float32(params.polarity) * (csum[ds:] - csum[:-ds])
    j = np.arange(soft_fsk.HEADER_CODED_BITS) * ds
    b_idx, k_idx = np.nonzero(valid)
    rows = starts[b_idx, k_idx][:, None] + j[None, :]
    want = wsum[rows, b_idx[:, None]]
    got = h_llr[b_idx, k_idx]
    assert np.array_equal(got, want), (
        f"header LLRs differ from the host gather: max |diff| "
        f"{np.abs(got - want).max():g}")
    return len(b_idx)


def phase_secondary():
    from webaudio_modem.models.farm import ModemFarm
    from webaudio_modem.models.psk import PSKConfig
    from webaudio_modem.ops.ldpc import default_code as ldpc_code
    from webaudio_modem.ops.turbo import default_code as turbo_code

    B = 2048
    farm = ModemFarm(PSKConfig(), B, donate=False)
    msgs = [bytes([i & 0xFF, (i >> 8) & 0xFF, (i * 13) & 0xFF])
            for i in range(B)]
    decoded = farm.demodulate(np.asarray(farm.modulate(msgs)))
    bad = sum(1 for d, m in zip(decoded, msgs) if d != m)
    assert bad == 0, f"{bad}/{B} DBPSK channels decoded wrong payloads"
    log(f"secondary: DBPSK farm {B}/{B} channels exact")

    params, noisy = _soft_farm_run(1024, 9, 8.0, key=3)
    log("secondary: soft farm 1024/1024 FEC frames exact at 8 dB")
    n = _check_header_llrs(params, noisy, 9)
    log(f"secondary: header LLRs of {n} top-k candidates equal the host "
        f"gather exactly (no TF32 rounding in the selection)")
    _soft_farm_run(512, 9, 8.0, key=5, stride=11,
                   body_code=ldpc_code(n=648, wc=3, wr=6))
    log("secondary: LDPC-body farm 512/512 frames exact at 8 dB")
    _soft_farm_run(256, 9, 8.0, key=7, stride=13,
                   body_code=turbo_code(K=256))
    log("secondary: turbo-body farm 256/256 frames exact at 8 dB")
    for blind in (False, True):
        bad, steps = _soft_hub_arq(blind)
        kind = "blind-hub" if blind else "soft-hub"
        assert bad == 0, f"{kind} ARQ: {bad}/32 payloads mismatched"
        log(f"secondary: {kind} ARQ 32/32 transfers exact ({steps} "
            f"quanta)")


def _soft_hub_arq(blind: bool, batch: int = 32, payload: int = 11):
    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
    from webaudio_modem.runtime.soft_hub import (BlindSoftFarmHub,
                                                 SoftFarmHub)
    from webaudio_modem.sim import make_device_awgn
    from webaudio_modem.transports.xmodem import XModemTransport

    async def run():
        cls = BlindSoftFarmHub if blind else SoftFarmHub
        hub = cls(DEFAULT_FSK_CONFIG, batch, quantum=4800, ring_quanta=24,
                  device_channel_fn=make_device_awgn(1e-4))
        senders = [XModemTransport(hub.channel("a", i))
                   for i in range(batch)]
        receivers = [XModemTransport(hub.channel("b", i))
                     for i in range(batch)]
        for t in senders + receivers:
            t.configure({"timeout_ms": 600000})
        data = [bytes((i * 3 + k) & 0xFF for k in range(payload))
                for i in range(batch)]
        pump = asyncio.ensure_future(hub.run())
        try:
            recv = [asyncio.ensure_future(r.receive_data())
                    for r in receivers]
            await asyncio.sleep(0)
            await asyncio.gather(*(s.send_data(p)
                                   for s, p in zip(senders, data)))
            results = await asyncio.gather(*recv)
        finally:
            hub.stop()
            await pump
        return sum(1 for r, p in zip(results, data) if r != p), hub.steps

    return asyncio.run(run())


# ---------------------------------------------------------------- timings

def _time_calls(fn, *args, n=TIMED_CALLS):
    """Steady-state seconds per call on the host clock, warm, ending in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def _compile_seconds(fn, *args):
    t0 = time.perf_counter()
    fn.lower(*args).compile()
    return time.perf_counter() - t0


def device_breakdown(trace_dir: str):
    """Reduce a profiler trace to device time: per-kernel totals (ns),
    the union of busy intervals and the window, over the GPU planes'
    stream lines."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    data = ProfileData.from_file(paths[-1])
    per_kernel, spans, names = {}, [], set()
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            names.add(f"{plane.name}|{line.name}")
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per_kernel[ev.name] = per_kernel.get(ev.name, 0) \
                    + ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    if not spans:
        log(f"  no GPU stream events in the trace; lines: {sorted(names)}")
    return per_kernel, busy, window


def _traced(tag, fn, *args, n=5):
    import shutil

    import jax

    d = os.path.join(TRACES, tag)
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(d):
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
    per_kernel, busy, window = device_breakdown(d)
    shutil.rmtree(d, ignore_errors=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    log(f"  trace {tag}: device busy {busy / n / 1e3:.1f} us/call, "
        f"idle share {1 - busy / max(window, 1):.3f} of the traced "
        f"window; top kernels (us/call): " + ", ".join(
            f"{k[:48]}={v / n / 1e3:.1f}" for k, v in top))
    return per_kernel, busy / n


def phase_timings(sweep: bool = False):
    import jax

    from webaudio_modem.models.config import FSKParams
    from webaudio_modem.ops import fsk_demod
    from webaudio_modem.ops.pallas import fsk_framing, fsk_seq
    from webaudio_modem.utils.platform import card_name_and_power

    card = card_name_and_power()
    params = FSKParams.from_config(config_300())
    sig, _ = farm_signal(B_FARM)
    x = jax.device_put(sig[:, CHUNK:2 * CHUNK])     # a chunk with data
    state = fsk_demod.init_state(params, B_FARM)
    seq_k, seq_l, d_k, d_l = _stage_fns(params)
    log(f"timings on {card} (B={B_FARM}, chunk {CHUNK}, 300 baud; "
        f"host clock over {TIMED_CALLS} warm calls):")

    with lax_path():
        bits, amps = seq_l(state, x)[2:4]
        rows = {
            "stage A lax": (seq_l, (state, x)),
            "stage D lax": (d_l, (state, bits, amps)),
            "chunk lax": (fsk_demod.make_demod_chunk(params, 0, False),
                          (state, x)),
        }
        lax_t = {k: (_compile_seconds(f, *a), _time_calls(f, *a))
                 for k, (f, a) in rows.items()}
        for k, (f, a) in rows.items():
            _traced(k.replace(" ", "_"), f, *a)
    rows = {
        "stage A kernel": (seq_k, (state, x)),
        "stage D kernel": (d_k, (state, bits, amps)),
        "chunk kernel": (fsk_demod.make_demod_chunk(params, 0, False),
                         (state, x)),
    }
    ker_t = {k: (_compile_seconds(f, *a), _time_calls(f, *a))
             for k, (f, a) in rows.items()}
    for k, (f, a) in rows.items():
        _traced(k.replace(" ", "_"), f, *a)
    for name in ("stage A", "stage D", "chunk"):
        (ck, tk), (cl, tl) = ker_t[f"{name} kernel"], lax_t[f"{name} lax"]
        log(f"  {name}: kernel {tk * 1e3:.3f} ms vs lax "
            f"(unroll {fsk_demod._UNROLL}) {tl * 1e3:.3f} ms per call "
            f"(x{tl / tk:.2f}); compile kernel {ck:.1f} s, lax {cl:.1f} s")
    per_chunk = ker_t["chunk kernel"][1]
    log(f"  per chunk at B={B_FARM}: {per_chunk * 1e3:.3f} ms for 0.1 s "
        f"of audio -> {B_FARM * 0.1 / per_chunk:.0f} realtime channels "
        f"on this card ({card})")
    _secondary_shares()
    if not sweep:
        return
    step_args = (state, x)
    for u in (4, 8, 16, 32, 64):
        with lax_path(unroll=u):
            f = fsk_demod.make_demod_chunk(params, 0, False)
            c = _compile_seconds(f, *step_args)
            t = _time_calls(f, *step_args)
        log(f"  sweep lax unroll {u}: chunk {t * 1e3:.3f} ms, compile "
            f"{c:.1f} s")
    for blk in (16, 32, 64, 128):
        for ah in (1, 2, 4, 8, 16):
            ta = _time_calls(lambda s, v: seq_k(s, v, block=blk, ahead=ah),
                             state, x)
            td = _time_calls(
                lambda s, b, a: d_k(s, b, a, block=blk, ahead=ah),
                state, bits, amps)
            log(f"  sweep block {blk} ahead {ah}: stage A kernel "
                f"{ta * 1e3:.3f} ms, stage D kernel {td * 1e3:.3f} ms")
    log(f"  sweep defaults: unroll {fsk_demod._UNROLL}; block/ahead "
        f"stage A {fsk_seq.BLOCK}/{fsk_seq.AHEAD}, stage D "
        f"{fsk_framing.BLOCK}/{fsk_framing.AHEAD}")


def _secondary_shares():
    """Device-time shares of stages that run as lax on the card and had
    a kernel on the old accelerator: DBPSK's stage A in its chunk step,
    and the Viterbi in the soft farm decode."""
    import jax
    import jax.numpy as jnp

    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
    from webaudio_modem.ops import fec, psk, soft_fsk

    params = psk.psk_params()
    x = jax.device_put(np.asarray(psk.modulate_batch(
        params, payloads(B_FARM, 3)))[:, :CHUNK])
    state = psk.init_state(params, B_FARM)
    _, chunk = _traced("psk_chunk", psk.make_demod_chunk(params, 0, False),
                       state, x)
    _, seq = _traced("psk_stage_A", jax.jit(
        lambda s, v: psk._sequential_stage(params, 0, s, v)), state, x)
    log(f"  DBPSK (1200 baud) B={B_FARM} chunk: lax stage A "
        f"{seq / 1e3:.1f} us of {chunk / 1e3:.1f} us device time "
        f"({seq / max(chunk, 1):.2f})")

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    B, payload = 1024, 9
    sigs = soft_fsk.encode_frames_batch(
        params, [bytes((i + k) & 0xFF for k in range(payload))
                 for i in range(B)])
    noisy = sigs + 0.05 * jax.random.normal(jax.random.PRNGKey(1),
                                            sigs.shape, jnp.float32)
    _, total = _traced("soft_decode", lambda v: soft_fsk._decode_frames_fused(
        params, v, payload), noisy)
    top_k = soft_fsk.HEADER_TOP_K
    h = jnp.ones((B * top_k, soft_fsk.HEADER_CODED_BITS // 2, 2))
    body_bits = soft_fsk._body_coded_bits(payload)
    b = jnp.ones((B, body_bits // 2, 2))
    _, vh = _traced("viterbi_header", lambda v: fec._viterbi_core(
        v, 8 * soft_fsk.HEADER_PLAIN), h)
    _, vb = _traced("viterbi_body", lambda v: fec._viterbi_core(
        v, 8 * (payload + 2)), b)
    log(f"  soft decode B={B} payload {payload}: Viterbi (header + body) "
        f"{(vh + vb) / 1e3:.1f} us of {total / 1e3:.1f} us device time "
        f"({(vh + vb) / max(total, 1):.2f})")


# ------------------------------------------------------------ four cards

def phase_sharded():
    import jax

    from webaudio_modem.models.farm import ModemFarm
    from webaudio_modem.parallel.sharding import make_mesh
    from webaudio_modem.runtime.device_hub import DeviceFarmHub
    from webaudio_modem.transports.xmodem import XModemTransport

    n_dev = 4
    devices = jax.devices()
    assert len(devices) >= n_dev, f"need {n_dev} cards, have {len(devices)}"
    mesh = make_mesh(n_dev)
    B = n_dev * B_FARM
    sig, msgs = farm_signal(B)
    farm = ModemFarm(config_300(), B, mesh=mesh, donate=False)
    got = farm.demodulate(sig, chunk_size=CHUNK)
    bad = sum(1 for g, m in zip(got, msgs) if g != m)
    assert bad == 0, f"{bad}/{B} sharded channels decoded wrong bytes"
    one = []
    for k in range(n_dev):
        part = slice(k * B_FARM, (k + 1) * B_FARM)
        one += ModemFarm(config_300(), B_FARM, donate=False).demodulate(
            sig[part], chunk_size=CHUNK)
    diff = sum(1 for a, b in zip(got, one) if a != b)
    assert diff == 0, f"{diff}/{B} channels differ sharded vs one card"
    log(f"sharded: B={B} over {n_dev} cards, every channel exact and "
        f"byte-identical to the same channels on one card")

    homes = {}
    for leaf in jax.tree.leaves(farm.state):
        if leaf.ndim == 0:
            continue
        shards = leaf.addressable_shards
        assert len({s.device for s in shards}) == n_dev, \
            f"a state leaf sits on {len({s.device for s in shards})} cards"
        for s in shards:
            idx = s.index[-1]
            homes.setdefault(s.device.id, set()).add(
                (idx.start, idx.stop))
    assert len(homes) == n_dev and all(len(v) == 1 for v in homes.values())
    log("sharded: each state leaf has one shard per card; card -> "
        "channel slice " + ", ".join(
            f"{d}:{sorted(v)[0]}" for d, v in sorted(homes.items())))

    n = ARQ_SESSIONS
    chans = [i * (B // n) for i in range(n)]

    async def run():
        hub = DeviceFarmHub(config_300(), B, quantum=CHUNK,
                            ring_quanta=24, mesh=mesh)
        senders = [XModemTransport(hub.channel("a", c)) for c in chans]
        receivers = [XModemTransport(hub.channel("b", c)) for c in chans]
        for t in senders + receivers:
            t.configure({"timeout_ms": 600000})
        data = [bytes((i + k) & 0xFF for k in range(11))
                for i in range(n)]
        pump = asyncio.ensure_future(hub.run())
        try:
            recv = [asyncio.ensure_future(r.receive_data())
                    for r in receivers]
            await asyncio.sleep(0)
            await asyncio.gather(*(s.send_data(p)
                                   for s, p in zip(senders, data)))
            results = await asyncio.gather(*recv)
        finally:
            hub.stop()
            await pump
        ring_cards = len(hub._rings["a"].sharding.device_set)
        return (sum(1 for r, p in zip(results, data) if r != p),
                hub.steps, ring_cards)

    bad, steps, ring_cards = asyncio.run(run())
    assert bad == 0, f"sharded hub ARQ: {bad}/{n} payloads mismatched"
    assert ring_cards == n_dev, f"hub wire on {ring_cards} cards"
    log(f"sharded: DeviceFarmHub batch {B} over {n_dev} cards: {n}/{n} "
        f"XModem transfers exact ({steps} quanta), wire on {ring_cards} "
        f"cards")


PHASES = {
    "golden": phase_golden,
    "farm": phase_farm,
    "kernels": phase_kernels,
    "arq": phase_arq,
    "secondary": phase_secondary,
    "timings": phase_timings,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--phases", nargs="*", choices=sorted(PHASES))
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    log(f"device: {devices}")
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from webaudio_modem.utils.platform import (card_name_and_power,
                                                   init_compile_cache)
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repo ({e})",
              file=sys.stderr)
        return 1
    cache = init_compile_cache()
    log(f"device: kind {devices[0].device_kind}, count {len(devices)}; "
        f"compile cache {cache}")
    log(card_name_and_power())

    if args.chips == 4:
        todo = [("sharded", phase_sharded)]
    else:
        todo = [(k, f) for k, f in PHASES.items()
                if not args.phases or k in args.phases]
    failed = []
    for name, fn in todo:
        t0 = time.perf_counter()
        try:
            fn(args.sweep) if name == "timings" else fn()
        except Exception:  # reported below and fails the run
            traceback.print_exc()
            failed.append(name)
        log(f"[{'FAIL' if name in failed else 'PASS'}] {name} "
            f"({time.perf_counter() - t0:.1f} s)")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
