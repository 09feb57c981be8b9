"""Blind farm-scale soft-FEC receive: batched frame ACQUISITION.

The reference receiver discovers frames with ZERO timing knowledge —
the sync correlator scans a rolling window every quarter bit and fires
wherever the match ratio crosses the threshold
(/root/reference/src/modems/fsk.ts:297-315: sync is discovery, not
scheduling).  The hard-path farm hubs honor that (their per-quantum
demod pump is fully blind), and the single-channel streaming decoder
does too (``soft_fsk.SoftFrameDecoder``), but the scheduled
``SoftFarmHub`` launches window decodes from its own playout
bookkeeping.  This module is the missing piece: a BATCHED, STREAMING,
BLIND soft receiver — B channels acquired concurrently with no hints.

Architecture (everything hot stays in device HBM):

  * **Detector** — one jitted program per audio quantum: the carried
    sequential demod stage (``fsk_demod._sequential_stage`` with the
    fused rolling bit-sum R stream) feeds the band-matmul sync
    correlation (``_sync_ratios_from_r``), the fresh soft plane is
    written into a device-resident ds-domain ring, and a vectorized
    per-channel EVENT TRACKER turns threshold crossings into sync-peak
    events: an event opens at the first crossing past the refractory
    point, its peak is the ratio argmax within ``2·ds`` ticks of the
    crossing (the plateau — mirroring the window decoder's argmax
    anchoring), and it closes at most one quantum later.  Only six [B]
    planes cross to the host per quantum.
  * **Header stage** — events that closed with peaks in the same
    quantum decode together: one program slices a static window of
    whole quanta around the group from the soft ring, and the shared
    candidate machinery (``soft_fsk._candidate_headers`` — grid
    offsets around each channel's OWN detected peak, barrel-aligned
    LLR windows, top-k pruning, one batched Viterbi) CRC-validates
    headers.  Unlike the window decoder, the payload length is NOT an
    input: it is read from each frame's decoded header (bounded by
    ``max_payload``), exactly like the streaming single-channel path.
  * **Body stage** — found channels group by (window, decoded length);
    each distinct length launches one batched body decode
    (``soft_fsk._batch_body_stage`` — conv/RS/LDPC/turbo) when its
    coded span has fully streamed in, gated by the frame CRC
    (``_pack_bodies``).  A failed CRC is a clean erasure — the ARQ
    layer retransmits (failure-recovery parity: xmodem.ts timeout/NAK
    flow).

All dispatches pipeline: results are fetched with
``copy_to_host_async`` and finalized on a LATER ``feed``, so the
device-to-host copy overlaps device compute (the farm hubs' pattern).
Device programs are compiled once per (params, quantum) plus once per
distinct decoded payload length.
"""

from __future__ import annotations

import functools
from collections import defaultdict, deque
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from webaudio_modem.models.config import FSKParams
from webaudio_modem.ops import fsk_demod, soft_fsk
from webaudio_modem.utils.trace import metrics


class _Frame:
    """One detected sync event moving through the decode pipeline.

    Delivery is per-channel FIFO: body decodes of different lengths
    complete at different feeds (a short frame's body program can
    finish before an EARLIER long frame's on the same channel), so
    completions park here until every earlier frame on the channel
    has resolved — otherwise ARQ byte streams would reorder."""

    __slots__ = ("ch", "pos", "done", "payload")

    def __init__(self, ch: int, pos: int):
        self.ch = ch
        self.pos = pos
        self.done = False
        self.payload: Optional[bytes] = None



class _RxState(NamedTuple):
    """Donated device carry of the blind receiver."""

    demod: fsk_demod.DemodState   # sequential-stage carry [B]
    ring: jax.Array               # [ring_ds, B] f32 soft ds-plane ring
    ev_best: jax.Array            # [B] f32 best ratio of the open event
    ev_pos: jax.Array             # [B] i32 global ds tick of that best
    ev_open: jax.Array            # [B] bool an event is open
    refract: jax.Array            # [B] i32 first tick eligible to open
    key: jax.Array                # PRNG carry for the channel function


class BlindSoftBatchReceiver:
    """B-channel streaming blind acquisition + soft-FEC frame decode.

    ``feed(samples)`` ingests one [B, quantum] chunk (host or device
    resident) and returns the ``(channel, payload_bytes)`` events that
    COMPLETED on this feed (decodes pipeline across feeds; expect a
    frame's payload 2-4 feeds after its signal has fully streamed in —
    call ``flush()`` at end of stream).  No per-channel timing, length
    or count information enters from outside: frames are discovered by
    the sync correlation, lengths by each frame's own decoded header.

    Frames on one channel must not overlap (they cannot on a physical
    wire); concurrent frames on different channels are independent.

    ``channel_fn`` (optional, jittable ``fn(frame, key) -> frame``,
    see sim.make_device_awgn) is applied to each quantum INSIDE the
    detector program — noise lands on the wire, upstream of
    demodulation, acquisition and decode alike.

    ``max_payload`` bounds the per-length decode-program set (a real
    receiver knows its protocol's maximum frame size; the reference's
    LEN field is likewise bounded by its buffer).  ``ring_quanta``
    (default: sized for ``max_payload``) bounds how long a frame may
    keep streaming after its sync peak before the soft ring recycles;
    undersized rings turn late bodies into counted erasures
    (``dropped_ring``), never corruption.
    """

    def __init__(self, params: FSKParams, batch: int, quantum: int,
                 ring_quanta: Optional[int] = None,
                 rs_parity: int = 0, body_code=None,
                 channel_fn: Optional[Callable] = None,
                 top_k: Optional[int] = None,
                 max_payload: int = 255, seed: int = 0,
                 mesh=None):
        if mesh is not None:
            from webaudio_modem.parallel.sharding import \
                check_mesh_batch

            check_mesh_batch(batch, mesh, type(self).__name__)
        soft_fsk._check_rs(0, rs_parity, body_code)
        if quantum % params.downsample_ratio != 0:
            raise ValueError(
                f"quantum ({quantum}) must be a multiple of the "
                f"downsample ratio ({params.downsample_ratio})")
        if params.ds_samples_per_bit > 256:
            raise ValueError("blind receiver needs the R-fused sync "
                             "path (ds_samples_per_bit <= 256)")
        self._params = params
        self.batch = batch
        self.quantum = quantum
        self._n_ds = quantum // params.downsample_ratio
        self._rs = rs_parity
        self._body = body_code
        self._chan = channel_fn
        self._top_k = (soft_fsk.HEADER_TOP_K if top_k is None else top_k)
        self._max_payload = max_payload

        ds = params.ds_samples_per_bit
        self._margin = 2 * ds         # plateau search span past a crossing
        # a TRUE peak is followed by at least header + minimum body
        # before the next frame's peak can occur; refract only needs to
        # be a lower bound (false re-opens decode to CRC-failed junk,
        # they never corrupt)
        self._refract_span = (soft_fsk.HEADER_CODED_BITS
                              + soft_fsk._body_coded_bits(
                                  0, rs_parity, body_code)) * ds
        n_ds = self._n_ds
        if n_ds < self._margin + 1:
            raise ValueError(f"quantum too small: {n_ds} ds ticks < "
                             f"event margin {self._margin + 1}")
        # header window: K_h whole quanta anchored one quantum before
        # the group's peak quantum; peaks sit in [n_ds, 2*n_ds) of it
        h_reach = ds // 4 + soft_fsk.HEADER_CODED_BITS * ds
        self._K_h = 2 + -(-h_reach // n_ds)
        kb_max = self._K_b(max_payload)
        if ring_quanta is None:
            ring_quanta = kb_max + 6
        if ring_quanta < kb_max + 3:
            raise ValueError(
                f"ring_quanta ({ring_quanta}) cannot hold a "
                f"max_payload ({max_payload}) body span plus decode "
                f"latency — need >= {kb_max + 3}")
        self._n_slots = ring_quanta
        self._ring_ds = ring_quanta * n_ds

        self._rx = _RxState(
            demod=fsk_demod.init_state(params, batch=batch),
            ring=jnp.zeros((self._ring_ds, batch), jnp.float32),
            ev_best=jnp.full((batch,), -jnp.inf, jnp.float32),
            ev_pos=jnp.zeros((batch,), jnp.int32),
            ev_open=jnp.zeros((batch,), bool),
            refract=jnp.full((batch,), params.sync_window, jnp.int32),
            key=jax.random.PRNGKey(seed))
        if mesh is not None:
            # channel-batch data parallelism over the mesh: every state
            # leaf shards its [B] axis (rank rule — parallel/sharding),
            # EXCEPT the PRNG key, whose [2] axis is key words, not
            # channels — replicate it.  Detector/header/body programs
            # are pure per-channel math, so XLA propagates the sharding
            # with zero collectives (same layout as ModemFarm).
            from jax.sharding import NamedSharding, PartitionSpec as P
            from webaudio_modem.parallel.sharding import shard_state

            key = jax.device_put(self._rx.key, NamedSharding(mesh, P()))
            placed = shard_state(self._rx._replace(key=None), mesh)
            self._rx = placed._replace(key=key)

        self._detect = self._build_detector()
        self._header_prog = self._build_header_prog()
        self._body_progs: Dict[int, Callable] = {}

        # host pipeline.  Detected events stay STRUCT-OF-ARRAYS until
        # header dispatch (cohort-aligned arrivals — all B channels
        # closing an event in one quantum, the farm-ARQ worst case —
        # were 6.8 ms/quantum of per-event Python at B=4096 with the
        # frame-per-event form; the array form collects them in ~0.1 ms,
        # examples/blind_host_cost.py).  _Frame objects materialize at
        # dispatch, where the per-channel FIFO needs them.
        self._fed = 0                 # quanta fully fed
        self._pend_detect: deque = deque()   # (qidx, emit device arrays)
        # qidx -> ordered [(chs i64[n], poss i32[n])] detected chunks
        self._events: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] \
            = defaultdict(list)
        self._pend_hdr: deque = deque()      # (feed, q0, frames, outs)
        # (q0, ln) -> [(frames, chs i64[n], b_rels i32[n])] chunks
        self._body_groups: Dict[Tuple[int, int], List[tuple]] \
            = defaultdict(list)
        self._pend_body: deque = deque()     # (feed, ln, frames, dev)
        # per-channel FIFO of unresolved/undelivered frames, plus the
        # channels whose FIFO head may have resolved since the last
        # emit pass (so delivery never walks all B channels per quantum)
        self._fifo: List[deque] = [deque() for _ in range(batch)]
        self._dirty: set = set()

        # observability
        self.events_detected = 0
        self.frames_decoded = 0
        self.frames_erased = 0        # valid header, body CRC failed
        self.headers_failed = 0       # event with no validating header
        self.dropped_ring = 0         # span outlived the soft ring

    # -- static geometry ----------------------------------------------------

    def _K_b(self, ln: int) -> int:
        """Quanta a body window must span for payload length ``ln``
        (anchored at the header window's q0; worst-case start)."""
        ds = self._params.ds_samples_per_bit
        body_bits = soft_fsk._body_coded_bits(ln, self._rs, self._body)
        reach = (2 * self._n_ds + ds // 4 + 1
                 + (soft_fsk.HEADER_CODED_BITS + body_bits) * ds)
        return -(-reach // self._n_ds)

    # -- device programs ----------------------------------------------------

    def _build_detector(self):
        params = self._params
        n_ds = self._n_ds
        W = params.sync_window
        ds = params.ds_samples_per_bit
        thr = jnp.float32(params.config.sync_threshold)
        margin = jnp.int32(self._margin)
        refr_span = jnp.int32(self._refract_span)
        chan = self._chan
        neg = jnp.float32(-jnp.inf)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def step(rx: _RxState, samples, tick0, woff):
            key = rx.key
            if chan is not None:
                key, sub = jax.random.split(key)
                samples = chan(samples, sub)
            (fr, dsc, iacc, qacc, bits, _amps, softs,
             rsum) = fsk_demod._sequential_stage(
                params, 0, rx.demod, samples, with_rsum=True)
            agc_gain, pre, phi, iq_i, iq_q = fr
            last_phase, post = dsc
            ratios = fsk_demod._sync_ratios_from_r(
                params, rx.demod.r_tail, rsum)            # [n_ds, B]
            r_tail = (rsum[-(W - ds):] if n_ds >= W - ds else
                      jnp.concatenate([rx.demod.r_tail, rsum],
                                      0)[-(W - ds):])
            bit_tail = (bits[-W:] if n_ds >= W else
                        jnp.concatenate([rx.demod.bit_tail, bits],
                                        0)[-W:])
            demod = rx.demod._replace(
                agc_gain=agc_gain, pre=pre, phi=phi, iq_i=iq_i,
                iq_q=iq_q, ds_iacc=iacc, ds_qacc=qacc,
                last_phase=last_phase, post=post,
                bit_tail=bit_tail, r_tail=r_tail,
                bit_fill=jnp.minimum(rx.demod.bit_fill + n_ds,
                                     jnp.int32(2 ** 30)))
            ring = jax.lax.dynamic_update_slice(
                rx.ring, softs.astype(rx.ring.dtype),
                (woff, jnp.int32(0)))

            # --- event tracker (vector ops over [n_ds, B]) ----------
            pos = tick0 + jnp.arange(n_ds, dtype=jnp.int32)  # [n_ds]
            # phase 1: every carried-open event closes this quantum —
            # extend its plateau search into the first `margin` ticks
            in_ext = rx.ev_open[None, :] & \
                (pos[:, None] <= rx.ev_pos[None, :] + margin)
            ev = jnp.where(in_ext, ratios, neg)
            ext_max = jnp.max(ev, 0)
            ext_arg = jnp.argmax(ev, 0).astype(jnp.int32)
            improved = rx.ev_open & (ext_max > rx.ev_best)
            best1 = jnp.where(improved, ext_max, rx.ev_best)
            pos1 = jnp.where(improved, tick0 + ext_arg, rx.ev_pos)
            emit_a = rx.ev_open
            refract = jnp.where(emit_a, pos1 + refr_span, rx.refract)
            # phase 2: first new crossing past the refractory point;
            # its peak is the plateau argmax within `margin` ticks —
            # if the plateau window runs off the quantum the event
            # stays open and closes in phase 1 of the next feed
            above = (ratios > thr) & (pos[:, None] >= refract[None, :])
            has = jnp.any(above, 0)
            t0 = jnp.argmax(above, 0).astype(jnp.int32)  # first True
            rel = jnp.arange(n_ds, dtype=jnp.int32)
            in_new = (rel[:, None] >= t0[None, :]) & \
                (rel[:, None] <= t0[None, :] + margin)
            nv = jnp.where(in_new & has[None, :], ratios, neg)
            nmax = jnp.max(nv, 0)
            narg = jnp.argmax(nv, 0).astype(jnp.int32)
            closes = has & (t0 + margin < n_ds)
            opens = has & ~closes
            emit_b = closes
            pos_b = tick0 + narg
            refract = jnp.where(emit_b, pos_b + refr_span, refract)

            rx2 = _RxState(
                demod=demod, ring=ring,
                ev_best=jnp.where(opens, nmax, neg),
                ev_pos=jnp.where(opens, pos_b, 0),
                ev_open=opens, refract=refract, key=key)
            return rx2, (emit_a, pos1, emit_b, pos_b)

        return step

    def _build_header_prog(self):
        params = self._params
        B, n_ds, n_slots = self.batch, self._n_ds, self._n_slots
        K_h, top_k, max_pl = self._K_h, self._top_k, self._max_payload

        @jax.jit
        def prog(ring, slot0, t_peak_rel, active):
            parts = [jax.lax.dynamic_slice(
                ring, (((slot0 + i) % n_slots) * n_ds, 0), (n_ds, B))
                for i in range(K_h)]
            win = jnp.concatenate(parts, 0)
            csum = soft_fsk._csum0(win)
            starts, headers, valid = soft_fsk._candidate_headers(
                params, csum, t_peak_rel, active, 0, top_k)
            return soft_fsk._select_candidate(
                headers, starts, valid, max_len=max_pl)

        return prog

    def _get_body_prog(self, ln: int):
        fn = self._body_progs.get(ln)
        if fn is None:
            params = self._params
            B, n_ds, n_slots = self.batch, self._n_ds, self._n_slots
            K_b, rs, body = self._K_b(ln), self._rs, self._body

            @jax.jit
            def prog(ring, slot0, b_start_rel, active):
                parts = [jax.lax.dynamic_slice(
                    ring, (((slot0 + i) % n_slots) * n_ds, 0),
                    (n_ds, B)) for i in range(K_b)]
                win = jnp.concatenate(parts, 0)
                csum = soft_fsk._csum0(win)
                b_starts = jnp.where(active, b_start_rel, 0)
                bodies = soft_fsk._batch_body_stage(
                    params, csum, b_starts, ln, rs, body)
                return soft_fsk._pack_bodies(bodies, ln, active)

            fn = self._body_progs[ln] = prog
        return fn

    # -- host pipeline --------------------------------------------------------

    def feed(self, samples) -> List[Tuple[int, bytes]]:
        """Ingest one [B, quantum] chunk; return completed decodes."""
        j = self._fed
        out: List[Tuple[int, bytes]] = []
        # 1. events from already-fetched detector quanta (<= j-1)
        with metrics.timer("blind_rx.collect_events"):
            self._collect_events()
        # 2. detector for quantum j (ring gains quantum j)
        samples = jnp.asarray(samples, jnp.float32)
        if samples.shape != (self.batch, self.quantum):
            raise ValueError(f"feed expects [{self.batch}, "
                             f"{self.quantum}], got {samples.shape}")
        tick0 = np.int32(j * self._n_ds)
        woff = np.int32((j % self._n_slots) * self._n_ds)
        with metrics.timer("blind_rx.detect_dispatch"):
            self._rx, emits = self._detect(self._rx, samples, tick0,
                                           woff)
            for e in emits:
                try:
                    e.copy_to_host_async()
                except (AttributeError, NotImplementedError):
                    pass
        self._pend_detect.append((j, emits))
        self._fed = j + 1
        # 3. finalize header/body results dispatched on earlier feeds
        with metrics.timer("blind_rx.finalize"):
            self._finalize_headers()
            self._finalize_bodies()
        # 4. dispatch due header groups (events complete at q <= j-2,
        # window quanta q-1..q+K_h-2 all written since K_h-2 <= j)
        with metrics.timer("blind_rx.dispatch_headers"):
            self._dispatch_headers()
        # 5. dispatch due body groups
        with metrics.timer("blind_rx.dispatch_bodies"):
            self._dispatch_bodies()
        # 6. deliver resolved frames in per-channel temporal order
        with metrics.timer("blind_rx.emit_ready"):
            out.extend(self._emit_ready())
        return out

    # -- pipeline stages ------------------------------------------------------

    def _collect_events(self) -> None:
        n_ds = self._n_ds
        while self._pend_detect and self._pend_detect[0][0] < self._fed:
            _, (emit_a, pos_a, emit_b, pos_b) = \
                self._pend_detect.popleft()
            # phase-1 closes carry earlier peaks than phase-2 closes
            # of the same quantum: keeping chunk a before chunk b (and
            # dispatch scanning chunks in order) keeps every channel
            # FIFO temporal
            for ok, pos in ((np.asarray(emit_a), np.asarray(pos_a)),
                            (np.asarray(emit_b), np.asarray(pos_b))):
                chs = np.nonzero(ok)[0]
                if chs.size == 0:
                    continue
                poss = pos[chs]
                self.events_detected += int(chs.size)
                qidx = poss // n_ds
                lo = int(qidx.min())
                if int(qidx.max()) == lo:        # common: one quantum
                    self._events[lo].append((chs, poss))
                else:                            # straddles a boundary
                    for q in np.unique(qidx).tolist():
                        m = qidx == q
                        self._events[q].append((chs[m], poss[m]))

    def _dispatch_headers(self) -> None:
        j = self._fed - 1   # newest written quantum = current feed idx
        # a group is complete once detector q+1's emits are collected
        # (during feed q+2): a peak in quantum q can close in phase 1
        # of quantum q+1
        due = [q for q in self._events
               if q <= j - 2 and q + self._K_h - 2 <= j]
        for q in sorted(due):
            chunks = self._events.pop(q)
            q0 = max(q - 1, 0)
            if q0 <= j - self._n_slots:   # window slot already recycled
                # never materialized: a dropped event emits nothing, so
                # skipping the FIFO cannot reorder later frames
                self.dropped_ring += sum(int(c.size) for c, _ in chunks)
                continue
            if len(chunks) == 1:
                chs, poss = chunks[0]
            else:
                chs = np.concatenate([c for c, _ in chunks])
                poss = np.concatenate([p for _, p in chunks])
            # occurrence index per channel (stable): occ==w -> wave w.
            # One wave per duplicate channel (rare: a false crossing
            # and a true peak landing in the same quantum); chunk order
            # is temporal, so stable occurrence numbering keeps each
            # channel's FIFO temporal.
            order = np.argsort(chs, kind="stable")
            sorted_chs = chs[order]
            run_start = np.empty(chs.size, bool)
            run_start[0] = True
            np.not_equal(sorted_chs[1:], sorted_chs[:-1],
                         out=run_start[1:])
            starts = np.nonzero(run_start)[0]
            occ_sorted = np.arange(chs.size, dtype=np.int64) \
                - np.repeat(starts, np.diff(
                    np.append(starts, chs.size)))
            occ = np.empty(chs.size, np.int64)
            occ[order] = occ_sorted
            n_waves = int(occ.max()) + 1 if chs.size else 0
            rel_all = (poss - q0 * self._n_ds).astype(np.int32)
            for w in range(n_waves):
                if n_waves == 1:
                    wchs, wrel, wposs = chs, rel_all, poss
                else:
                    m = occ == w
                    wchs, wrel, wposs = chs[m], rel_all[m], poss[m]
                frames = list(map(_Frame, wchs.tolist(),
                                  wposs.tolist()))
                fifo = self._fifo
                for c, f in zip(wchs.tolist(), frames):
                    fifo[c].append(f)
                t_rel = np.zeros((self.batch,), np.int32)
                act = np.zeros((self.batch,), bool)
                t_rel[wchs] = wrel
                act[wchs] = True
                outs = self._header_prog(self._rx.ring, np.int32(q0),
                                         jnp.asarray(t_rel),
                                         jnp.asarray(act))
                for o in outs:
                    try:
                        o.copy_to_host_async()
                    except (AttributeError, NotImplementedError):
                        pass
                self._pend_hdr.append((self._fed, q0, frames, wchs,
                                       outs))

    def _finalize_headers(self) -> None:
        h_span = soft_fsk.HEADER_CODED_BITS \
            * self._params.ds_samples_per_bit
        while self._pend_hdr and self._pend_hdr[0][0] < self._fed:
            _, q0, frames, chs, (found, ln, st) = \
                self._pend_hdr.popleft()
            found = np.asarray(found)
            ln = np.asarray(ln)
            st = np.asarray(st)
            okm = found[chs]
            n_bad = int(len(frames) - okm.sum())
            if n_bad:
                self.headers_failed += n_bad
                dirty = self._dirty
                for f, o in zip(frames, okm.tolist()):
                    if not o:
                        f.done = True
                        dirty.add(f.ch)
                ok_idx = np.nonzero(okm)[0]
                frames = [frames[i] for i in ok_idx.tolist()]
                chs = chs[ok_idx]
            if not frames:
                continue
            lns_g = ln[chs]
            b_rels = (st[chs] + h_span).astype(np.int32)
            uniq = np.unique(lns_g)
            for L in uniq.tolist():
                if uniq.size == 1:
                    g_frames, g_chs, g_b = frames, chs, b_rels
                else:
                    m = lns_g == L
                    idx = np.nonzero(m)[0]
                    g_frames = [frames[i] for i in idx.tolist()]
                    g_chs, g_b = chs[m], b_rels[m]
                self._body_groups[(q0, int(L))].append(
                    (g_frames, g_chs, g_b))

    def _dispatch_bodies(self) -> None:
        j = self._fed - 1
        for (q0, ln) in sorted(self._body_groups):
            if q0 + self._K_b(ln) - 1 > j:
                continue              # span still streaming in
            chunks = self._body_groups.pop((q0, ln))
            if q0 <= j - self._n_slots:
                dirty = self._dirty
                for frames, _, _ in chunks:
                    self.dropped_ring += len(frames)
                    for f in frames:
                        f.done = True
                        dirty.add(f.ch)
                continue
            b_rel = np.zeros((self.batch,), np.int32)
            act = np.zeros((self.batch,), bool)
            all_frames: List[_Frame] = []
            for frames, chs, b in chunks:
                b_rel[chs] = b
                act[chs] = True
                all_frames.extend(frames)
            all_chs = (chunks[0][1] if len(chunks) == 1 else
                       np.concatenate([c for _, c, _ in chunks]))
            packed = self._get_body_prog(ln)(
                self._rx.ring, np.int32(q0), jnp.asarray(b_rel),
                jnp.asarray(act))
            try:
                packed.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass
            self._pend_body.append(
                (self._fed, ln, all_frames, all_chs, packed))

    def _finalize_bodies(self) -> None:
        while self._pend_body and self._pend_body[0][0] < self._fed:
            _, ln, frames, chs, packed = self._pend_body.popleft()
            packed = np.asarray(packed)
            rows = packed[chs]                        # [n, ln+1] gather
            okb = rows[:, ln] != 0
            n_ok = int(okb.sum())
            self.frames_decoded += n_ok
            self.frames_erased += len(frames) - n_ok
            buf = rows[:, :ln].tobytes()              # one copy-out
            dirty = self._dirty
            dirty.update(chs.tolist())
            for i, (f, ok) in enumerate(zip(frames, okb.tolist())):
                f.done = True
                if ok:
                    f.payload = buf[i * ln:(i + 1) * ln]

    def _emit_ready(self) -> List[Tuple[int, bytes]]:
        out: List[Tuple[int, bytes]] = []
        for ch in sorted(self._dirty):
            q = self._fifo[ch]
            while q and q[0].done:
                f = q.popleft()
                if f.payload is not None:
                    out.append((ch, f.payload))
        self._dirty.clear()
        return out

    # -- draining -------------------------------------------------------------

    def has_work(self) -> bool:
        """Host-visible in-flight decode work, WITHOUT a device sync
        (an event still open on device is not counted — it closes
        within two feeds, which any pump's idle grace covers)."""
        return bool(self._events or self._pend_hdr or self._body_groups
                    or self._pend_body or any(self._fifo))

    def _pending(self) -> bool:
        """In-flight work check for ``flush`` — call ``_collect_events``
        first so the newest detector emits are accounted (the detect
        queue itself always holds the latest feed's entry)."""
        return bool(self._events or self._pend_hdr
                    or self._body_groups or self._pend_body
                    or any(self._fifo)
                    or bool(np.asarray(self._rx.ev_open).any()))

    def flush(self, max_quanta: Optional[int] = None) \
            -> List[Tuple[int, bytes]]:
        """Feed silence until every in-flight decode resolves and
        return the completed events.  Bodies whose span never arrives
        (stream cut mid-frame) resolve as erasures once the ring
        recycles past them."""
        if max_quanta is None:
            max_quanta = self._n_slots + self._K_b(self._max_payload) + 8
        out: List[Tuple[int, bytes]] = []
        zeros = np.zeros((self.batch, self.quantum), np.float32)
        for _ in range(max_quanta):
            self._collect_events()
            if not self._pending():
                break
            out.extend(self.feed(zeros))
        return out

    def get_status(self) -> dict:
        return {
            "fed_quanta": self._fed,
            "events_detected": self.events_detected,
            "frames_decoded": self.frames_decoded,
            "frames_erased": self.frames_erased,
            "headers_failed": self.headers_failed,
            "dropped_ring": self.dropped_ring,
            "ring_quanta": self._n_slots,
            "pending": {
                "detect": len(self._pend_detect),
                "event_groups": len(self._events),
                "header": len(self._pend_hdr),
                "body_groups": len(self._body_groups),
                "body": len(self._pend_body),
            },
        }
