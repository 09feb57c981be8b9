"""Headline benchmark: concurrent 300-baud FSK channels demodulated
faster than realtime on one GPU.

Target: >= 4096 concurrent 300-baud channels realtime on one card (the
reference's implicit budget is ONE channel per JS audio thread,
src/webaudio/processors/fsk-processor.ts:152-167).  vs_baseline is the
achieved channel count over the 4096-channel target.

Runs only on the GPU (exits non-zero when JAX finds none) and prints
exactly one JSON line on stdout, naming the device beside the number.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _emit(record: dict) -> None:
    from webaudio_modem.utils.platform import device_record

    print(json.dumps({**record, "device": device_record()}))


def main():
    from webaudio_modem.utils.platform import (init_compile_cache,
                                               require_gpu)

    require_gpu()
    init_compile_cache()
    import jax
    import jax.numpy as jnp

    from webaudio_modem.models.config import FSKConfig, FSKParams
    from webaudio_modem.ops import fsk_demod, fsk_mod

    # the north star's farm: 4096 channels on one card
    B = int(sys.argv[sys.argv.index("--batch") + 1]) \
        if "--batch" in sys.argv else 4096
    family = sys.argv[sys.argv.index("--family") + 1] \
        if "--family" in sys.argv else "fsk"
    if family == "soft":
        return bench_soft(B)
    if family == "blind":
        return bench_blind(B)
    chunk_t = 4800          # 0.1 s of 48 kHz audio per step
    timed_chunks = 400      # 40 s of audio per timed pass
    if family == "psk":
        # DBPSK farm headline (secondary; the driver metric stays FSK):
        # python bench.py --family psk
        from webaudio_modem.models.farm import _resolve_family
        from webaudio_modem.models.psk import PSKConfig

        config = PSKConfig()        # 1200 baud, 1800 Hz carrier
        ops, params = _resolve_family(config)
        modulate_one = lambda p, m: ops.modulate_batch(p, [m])[0]  # noqa: E731
    else:
        config = FSKConfig(baud_rate=300, mark_frequency=1270,
                           space_frequency=1070)
        params = FSKParams.from_config(config)
        ops = None
        modulate_one = fsk_mod.modulate
    message = b"Hello, World!"

    # one message signal, tiled across channels ON DEVICE (uploading
    # [B, T] chunks over the wire would dominate setup time) and
    # streamed cyclically
    sig = np.asarray(modulate_one(params, message))
    reps = int(np.ceil(chunk_t * 2 / len(sig))) + 1
    loop = np.tile(sig, reps)
    n_chunks_cycle = len(loop) // chunk_t
    tile = jax.jit(lambda v: jnp.tile(v[None, :], (B, 1)))
    chunks = [tile(jnp.asarray(loop[i * chunk_t:(i + 1) * chunk_t]))
              for i in range(n_chunks_cycle)]
    jax.block_until_ready(chunks)

    if family == "psk":
        from webaudio_modem.ops import psk as family_ops
    else:
        family_ops = fsk_demod
    state = family_ops.init_state(params, batch=B)
    step = family_ops.make_demod_chunk(params, 0, donate=True)

    # warmup / compile + correctness GATE: the first full message must
    # decode EXACTLY on multiple channels — a pipeline that syncs but
    # produces garbage fails the bench loudly.
    check_channels = sorted({0, B // 2, B - 1})
    decoded = {c: bytearray() for c in check_channels}
    warm_chunks = int(np.ceil(len(sig) / chunk_t)) + 1
    for i in range(warm_chunks):
        state, out = step(state, chunks[i % n_chunks_cycle])
        counts = np.asarray(out.byte_count)
        vals = np.asarray(out.bytes_out)
        for c in check_channels:
            decoded[c] += bytes(vals[c, :counts[c]])
    jax.block_until_ready(state)
    for c in check_channels:
        assert message in bytes(decoded[c]), (
            f"bench warmup failed exact decode on channel {c}: "
            f"{bytes(decoded[c])!r}")

    # The timed stream scans ``group`` chunks per dispatch with the
    # state donated across groups: the per-chunk computation is
    # identical to the interactive path (0.1 s quanta, carried state),
    # but host round trips amortize over the group instead of being
    # charged once per 0.1 s of audio.
    import functools

    group = 50
    stacked = jnp.stack(chunks)                     # [n_cycle, B, T]

    @functools.partial(jax.jit, donate_argnums=0)
    def run_group(st, stk, idxs):
        def body(st, i):
            st, out = family_ops.demod_chunk(params, 0, st, stk[i])
            return st, out.byte_count
        return jax.lax.scan(body, st, idxs)

    idx_groups = [
        jnp.asarray([(g * group + i + warm_chunks) % n_chunks_cycle
                     for i in range(group)], jnp.int32)
        for g in range(timed_chunks // group)]
    state, _ = run_group(state, stacked, idx_groups[0])  # compile + warm
    jax.block_until_ready(state)

    # SLOPE-calibrated steady-state cost: a single pass obeys
    # wall = const + N*chunk_time, so timing two pass lengths and
    # taking (wall_hi - wall_lo) / (N_hi - N_lo) cancels the fixed
    # per-pass cost (dispatch, final sync) and reports what a
    # continuous stream pays per chunk.  Each pass length runs twice,
    # keeping the fastest.
    lo_groups = max(1, len(idx_groups) // 4)
    walls = {}
    byte_counts = []
    for n_groups in (lo_groups, len(idx_groups)):
        best = float("inf")
        for rep in range(2):
            counts_rep = []
            t0 = time.perf_counter()
            for idxs in idx_groups[:n_groups]:
                state, bcs = run_group(state, stacked, idxs)
                counts_rep.append(bcs)
            jax.block_until_ready(state)
            wall_rep = time.perf_counter() - t0
            if wall_rep < best:
                best = wall_rep
            if n_groups == len(idx_groups):
                byte_counts = counts_rep
        walls[n_groups] = best
    n_lo, n_hi = lo_groups * group, timed_chunks
    per_chunk = (walls[len(idx_groups)] - walls[lo_groups]) / (n_hi - n_lo)
    wall = per_chunk * timed_chunks    # steady-state wall for the stream

    syncs = int(np.asarray(state.sync_count)[0])
    decoded_bytes = int(sum(np.asarray(c).sum() for c in byte_counts))

    audio_seconds = timed_chunks * chunk_t / config.sample_rate
    channels_realtime = B * audio_seconds / wall
    print(f"B={B} per_chunk={per_chunk * 1e3:.3f}ms "
          f"(walls {walls[lo_groups]:.3f}s/{n_lo} -> "
          f"{walls[len(idx_groups)]:.3f}s/{n_hi} chunks) "
          f"audio={audio_seconds:.1f}s "
          f"throughput={B * timed_chunks * chunk_t / wall / 1e6:.0f} "
          f"Msamples/s decoded={decoded_bytes / wall / 1e3:.0f} kB/s "
          f"syncs(ch0)={syncs}", file=sys.stderr)
    # the timed pipeline includes the full SignalQuality surface
    # (the reference stubs it)
    ber, freq, jitter, eye = fsk_demod.quality_from_state(
        params, state, family=family)
    print(f"quality(ch0): ber={ber[0]:.4f} freq_offset={freq[0]:+.2f}Hz "
          f"jitter={jitter[0]:.4f} eye={eye[0]:.2f}", file=sys.stderr)

    metric = ("concurrent_300baud_channels_realtime" if family == "fsk"
              else "concurrent_1200baud_psk_channels_realtime")
    _emit({
        "metric": metric,
        "value": channels_realtime,
        "unit": "channels",
        "batch": B,
        "ms_per_chunk": per_chunk * 1e3,
        "vs_baseline": channels_realtime / 4096.0,
    })


def bench_soft(B):
    """Secondary headline: farm-scale soft-decision FEC frames
    (``python bench.py --family soft``).  Frame-granular, not
    streaming: each pass synthesizes nothing and uploads nothing —
    the noisy [B, T] batch lives in HBM and every timed iteration is
    one full decode_frames_batch (ONE fused device program; a single
    [B, payload+1] byte plane crosses to the host).  The metric is
    realtime channels: B x frame_audio_seconds / per-batch seconds.
    Correctness-gated: every payload in the warmup decode must be
    exact at 8 dB SNR."""
    import time as _time

    import jax
    import jax.numpy as jnp

    from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                  FSKParams)
    from webaudio_modem.ops import soft_fsk

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)   # 1200 baud
    payload = 16
    snr_db = 8.0
    payloads = [bytes((i * 13 + k) & 0xFF for k in range(payload))
                for i in range(B)]

    sigs = soft_fsk.encode_frames_batch(params, payloads)  # [B, T] dev
    T = sigs.shape[1]
    power = float(jnp.mean(sigs[0].astype(jnp.float32) ** 2))
    amp = np.sqrt(power / (10 ** (snr_db / 10)))
    noise = jax.random.normal(jax.random.PRNGKey(7), sigs.shape,
                              jnp.float32)
    noisy = jax.block_until_ready(
        (sigs + jnp.float32(amp) * noise).astype(jnp.float32))

    # warmup / compile + correctness gate
    out = soft_fsk.decode_frames_batch(params, noisy, payload)
    bad = sum(1 for o, p in zip(out, payloads) if o != p)
    assert bad == 0, f"soft bench gate: {bad}/{B} frames failed " \
                     f"exact decode at {snr_db:g} dB"

    # slope over two pass counts cancels one-time setup.  The stream
    # is PIPELINED exactly as a production drain loop would be
    # (decode_frames_batch_async: dispatch batch t+1 before fetching
    # batch t), so the per-call round trip overlaps device compute
    # instead of serializing with it.
    walls = {}
    for n_iter in (2, 8):
        best = float("inf")
        for _ in range(2):
            t0 = _time.perf_counter()
            pending = [soft_fsk.decode_frames_batch_async(
                params, noisy, payload) for _i in range(n_iter)]
            for p in pending:
                p()
            w = _time.perf_counter() - t0
            best = min(best, w)
        walls[n_iter] = best
    per_batch = (walls[8] - walls[2]) / 6
    audio_seconds = T / params.config.sample_rate
    channels_realtime = B * audio_seconds / per_batch
    frames_per_s = B / per_batch
    print(f"B={B} T={T} per_batch={per_batch * 1e3:.1f}ms "
          f"frames/s={frames_per_s:.0f} "
          f"frame_audio={audio_seconds:.3f}s snr={snr_db:g}dB",
          file=sys.stderr)
    _emit({
        "metric": "concurrent_1200baud_soft_fec_channels_realtime",
        "value": channels_realtime,
        "unit": "channels",
        "batch": B,
        "vs_baseline": channels_realtime / 4096.0,
    })


def bench_blind(B, snr_db: float = 20.0):
    """Blind-acquisition headline (``python bench.py --family blind``):
    steady-state STREAMING decode through ``BlindSoftBatchReceiver``
    with ZERO timing knowledge — frames sit at random per-channel
    offsets in a cyclic stream, sync peaks are discovered by the
    detector's scan, payload lengths come from decoded headers
    (the reference's acquisition model, src/modems/fsk.ts:297-315, at
    farm scale).  The metric is realtime channels: B x audio_seconds /
    steady-state wall, slope-calibrated over two feed counts.
    Correctness-gated: during warmup every channel must blindly decode
    its own frame exactly at ``snr_db``."""
    import time as _time

    import jax
    import jax.numpy as jnp

    from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                  FSKParams)
    from webaudio_modem.ops import soft_fsk
    from webaudio_modem.ops.soft_blind import BlindSoftBatchReceiver
    from webaudio_modem.utils.trace import metrics

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)   # 1200 baud
    payload = 16
    quantum = 4800

    rng = np.random.RandomState(9)
    payloads = [bytes(rng.randint(0, 256, payload, dtype=np.uint8))
                for _ in range(B)]
    sigs = soft_fsk.encode_frames_batch(params, payloads)  # [B, T_f]
    T_f = int(sigs.shape[1])
    # one frame per channel per cycle, random phase: frames close on
    # every feed in steady state (~B/period events per quantum)
    period = int(np.ceil(T_f / quantum)) + 3
    T_cyc = period * quantum
    offs = jnp.asarray(rng.randint(0, T_cyc, size=B), jnp.int32)

    @jax.jit
    def build_cycle(sigs, offs):
        t = jnp.arange(T_cyc, dtype=jnp.int32)[None, :]
        idx = (t - offs[:, None]) % T_cyc
        live = idx < T_f
        vals = jnp.take_along_axis(
            sigs, jnp.minimum(idx, T_f - 1), axis=1)
        return jnp.where(live, vals, 0.0).astype(jnp.float32)

    cycle = jax.block_until_ready(build_cycle(sigs, offs))

    sig_power = float(jnp.mean(sigs[0].astype(jnp.float32) ** 2))
    noise_power = sig_power / (10 ** (snr_db / 10))
    from webaudio_modem.sim import make_device_awgn

    rx = BlindSoftBatchReceiver(
        params, B, quantum, max_payload=32,
        channel_fn=make_device_awgn(noise_power), seed=3)

    slices = [jax.jit(lambda c, j=j: jax.lax.dynamic_slice(
        c, (0, j * quantum), (B, quantum)))(cycle)
        for j in range(period)]
    jax.block_until_ready(slices)

    # warmup + correctness gate: 3 cycles must blindly deliver every
    # channel's frame (exactly) at least twice
    got = [0] * B
    bad = 0
    for j in range(3 * period):
        for ch, pl in rx.feed(slices[j % period]):
            if pl == payloads[ch]:
                got[ch] += 1
            else:
                bad += 1
    assert bad == 0, f"blind bench gate: {bad} corrupt payloads"
    missing = sum(1 for g in got if g < 2)
    assert missing == 0, \
        f"blind bench gate: {missing}/{B} channels not acquired twice"

    # slope-calibrated steady state: wall(N) = const + N * per_feed;
    # two N cancel the constant
    walls = {}
    decoded = 0
    for n_cycles in (2, 6):
        best = float("inf")
        for _rep in range(2):
            n_dec = 0
            t0 = _time.perf_counter()
            for j in range(n_cycles * period):
                n_dec += len(rx.feed(slices[j % period]))
            jax.block_until_ready(rx._rx.ring)
            w = _time.perf_counter() - t0
            best = min(best, w)
            if n_cycles == 6:
                decoded = n_dec
        walls[n_cycles] = best
    per_feed = (walls[6] - walls[2]) / ((6 - 2) * period)
    audio_seconds = 6 * period * quantum / params.config.sample_rate
    wall = per_feed * 6 * period
    channels_realtime = B * audio_seconds / wall

    snap = metrics.snapshot()["timings"]

    def t_ms(name):
        agg = snap.get(f"blind_rx.{name}")
        return agg["mean_ms"] if agg else 0.0

    print(f"B={B} T_f={T_f} period={period}q per_feed="
          f"{per_feed * 1e3:.2f}ms decoded={decoded} "
          f"(6-cycle pass) snr={snr_db:g}dB "
          f"status={rx.get_status()}", file=sys.stderr)
    print("host stages ms/feed: " + " ".join(
        f"{n}={t_ms(n):.2f}" for n in
        ("collect_events", "detect_dispatch", "finalize",
         "dispatch_headers", "dispatch_bodies", "emit_ready")),
        file=sys.stderr)
    _emit({
        "metric": "concurrent_1200baud_blind_soft_channels_realtime",
        "value": channels_realtime,
        "unit": "channels",
        "batch": B,
        "vs_baseline": channels_realtime / 4096.0,
    })


if __name__ == "__main__":
    main()
