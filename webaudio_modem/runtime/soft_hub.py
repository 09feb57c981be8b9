"""SoftFarmHub — farm-scale transport over the soft-decision FEC
physical layer, with the wire living in device HBM.

This is the FEC memo's receive pipeline
(/root/reference/advanced-error-correction.md: samples -> soft
demodulator -> FEC decoder -> framer) run at the BASELINE north-star
topology — thousands of concurrent ARQ sessions over one hub
(reference analog: one transport per modem node, src/core.ts:297-305
x demo/demo.js:233-250).  Every ``modulate()`` payload becomes ONE
coded frame (sync pattern + conv header + conv/RS/LDPC/turbo body,
``ops/soft_fsk.encode_frames_batch``) and the receive side is the
fused batched decoder (``soft_fsk._decode_frames_fused``), so the
whole farm's RX is a handful of large device programs instead of
per-channel streaming state machines.

Architecture (contrast with ``DeviceFarmHub``, the hard-UART hub):

  * The wire is the same HBM ring pair (``RingHubBase``): cohort
    TX synthesis on device, masked ring writes, playout bookkeeping in
    pure host arithmetic.
  * There is NO per-quantum demodulation pump.  The hub schedules a
    WINDOW DECODE for each written playout region [w, w+Lpad): when
    the window has fully played out, one fused device program slices
    it from the ring, applies the on-device channel function (AWGN),
    soft-demodulates, Viterbi-decodes header + body and CRC-gates —
    the host receives a single [B, payload+1] byte plane.  Idle quanta
    cost no device work at all.
  * Decoded frame payloads ARE wire bytes: they drain through the
    batched C++ deframer into the same FarmDataChannel frame/byte
    queues, so ``XModemTransport`` runs unchanged on top — ARQ over
    soft FEC at farm scale (models/soft_modem.SoftModemCore is the
    single-channel analog).

Loopback honesty: the hub knows each transmission's playout window
(it schedules the writes — the same knowledge the hard hubs' playout
bookkeeping uses), but payload recovery inside the window is fully
blind: the fused decoder finds the sync correlation peak, searches
the header-start grid, and CRC-gates header and body exactly as the
streaming ``SoftFrameDecoder`` does on a continuous signal.  A frame
that fails its CRC is a clean erasure — nothing is delivered and the
ARQ layer retransmits (failure-recovery parity: xmodem.ts timeout /
NAK flow).
"""

from __future__ import annotations

import functools
from collections import defaultdict, deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from webaudio_modem.models.config import FSKParams
from webaudio_modem.runtime.device_hub import RingHubBase
from webaudio_modem.utils.trace import metrics


def _soft_synth(params, datas, rs_parity, body_code) -> "jax.Array":
    """Cohort synthesis for the soft wire.  The conv-default coding
    frames + synthesizes ON DEVICE from a [B, pl] payload-byte upload
    (~190 KB at B=4096 vs ~17 MB of host-framed phase tables —
    soft_fsk.frames_synth_device_fn); RS/block bodies and
    non-integer configs fall back to the host framing path."""
    from webaudio_modem.ops import soft_fsk

    if rs_parity == 0 and body_code is None and datas:
        fn = soft_fsk.frames_synth_device_fn(params, len(datas[0]))
        if fn is not None:
            pay = np.frombuffer(b"".join(datas), np.uint8) \
                .reshape(len(datas), len(datas[0]))
            return fn(jnp.asarray(pay))
    return soft_fsk.encode_frames_batch(
        params, datas, rs_parity=rs_parity, body_code=body_code)


class _DecodeGroup:
    """One scheduled window decode: the cohort rows whose frames play
    out in [w, w+Lpad), decoded together when the window completes."""

    __slots__ = ("w", "Lpad", "payload_len", "rows", "active", "slot_of")

    def __init__(self, w: int, Lpad: int, payload_len: int, rows):
        self.w = w
        self.Lpad = Lpad
        self.payload_len = payload_len
        self.rows = list(rows)
        self.active = np.ones(len(self.rows), bool)
        self.slot_of = {i: s for s, i in enumerate(self.rows)}


class _DecOut:
    """DemodOut-shaped shim feeding FarmHubBase._drain."""

    __slots__ = ("byte_count", "bytes_out")

    def __init__(self, byte_count, bytes_out):
        self.byte_count = byte_count
        self.bytes_out = bytes_out


class SoftFarmHub(RingHubBase):
    """B full-duplex FEC-coded wires in device HBM; scheduled window
    decodes through the fused soft decoder; host traffic bytes-only.

    ``rs_parity`` / ``body_code`` select the body coding exactly as on
    the ``ops/soft_fsk`` surface (conv default, concatenated RS outer,
    or an LDPC/turbo block code) — both endpoints of every wire use
    the same coding.

    ``device_channel_fn``: optional jittable ``fn(frame, key) ->
    frame`` (see sim.make_device_awgn) applied to each decode window
    INSIDE the fused decode program.  Each wire row is decoded from
    exactly one window per transmission, so per-window noise is
    statistically identical to per-quantum noise on that row's signal.

    ``ring_quanta`` must hold the longest frame signal (a 133-byte
    XModem packet at 1200 baud is ~20 quanta of 4800) plus one quantum
    of slack; undersized rings raise at write time.
    """

    def __init__(self, config, batch: int, quantum: int = 4800,
                 ring_quanta: int = 24,
                 device_channel_fn: Optional[Callable] = None,
                 rs_parity: int = 0, body_code=None, seed: int = 0,
                 mesh=None):
        super().__init__(config, batch, quantum, ring_quanta, mesh=mesh)
        self._params = FSKParams.from_config(self.config)
        if quantum % self._params.downsample_ratio != 0:
            raise ValueError(
                f"quantum ({quantum}) must be a multiple of the "
                f"downsample ratio ({self._params.downsample_ratio})")
        self._chan = device_channel_fn
        self._rs = rs_parity
        self._body = body_code
        self._keys = {"a": jax.random.PRNGKey(seed),
                      "b": jax.random.PRNGKey(seed + 1)}
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(mesh, P())
            self._keys = {s: jax.device_put(k, rep)
                          for s, k in self._keys.items()}
        # tx_side -> step index -> [_DecodeGroup] due for dispatch
        self._due: Dict[str, Dict[int, list]] = {
            "a": defaultdict(list), "b": defaultdict(list)}
        # (tx_side, row) -> (group, slot) while the group awaits
        # dispatch (abort marking)
        self._sched: Dict[Tuple[str, int], Tuple[_DecodeGroup, int]] = {}
        # rx_side -> deque[(group, packed_dev, dispatched_at_step)]
        self._pending_dec: Dict[str, deque] = {"a": deque(),
                                               "b": deque()}
        self._decoders: Dict[Tuple[int, int], Callable] = {}
        self.frames_decoded = 0
        self.frames_erased = 0

    # -- TX: FEC frame synthesis --------------------------------------------

    def _synth_full(self, side: str, datas) -> "jax.Array":
        return _soft_synth(self._params, datas, self._rs, self._body)

    def _on_group_written(self, side: str, w: int, Lpad: int, T: int,
                          rows, entries, length: int) -> None:
        group = _DecodeGroup(w, Lpad, length, rows)
        # the full padded window [w, w+Lpad) has played after step
        # (w+Lpad)/quantum - 1; dispatch the decode at the next step
        self._due[side][(w + Lpad) // self.quantum].append(group)
        for slot, i in enumerate(group.rows):
            self._sched[(side, i)] = (group, slot)

    def _stop_playing(self, side: str, index: int, entry) -> None:
        super()._stop_playing(side, index, entry)
        hit = self._sched.pop((side, index), None)
        if hit is not None:
            group, slot = hit
            group.active[slot] = False

    # -- RX: scheduled window decodes ---------------------------------------

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def _win(self, ring, woff, Lpad):
        return jax.lax.dynamic_slice(ring, (0, woff),
                                     (self.batch, Lpad))

    @functools.partial(jax.jit, static_argnums=(0, 2, 3))
    def _win_wrap(self, ring, n1, Lpad):
        a = jax.lax.slice(ring, (0, self.ring_len - n1),
                          (self.batch, self.ring_len))
        b = jax.lax.slice(ring, (0, 0), (self.batch, Lpad - n1))
        return jnp.concatenate([a, b], axis=1)

    def _get_decoder(self, Lpad: int, payload_len: int) -> Callable:
        key = (Lpad, payload_len)
        fn = self._decoders.get(key)
        if fn is None:
            from webaudio_modem.ops import soft_fsk

            chan = self._chan
            rs, body, params = self._rs, self._body, self._params

            def decode(window, k):
                if chan is not None:
                    k, sub = jax.random.split(k)
                    window = chan(window, sub)
                packed = soft_fsk._decode_frames_fused(
                    params, window, payload_len, rs, body)
                return packed, k

            fn = self._decoders[key] = jax.jit(decode)
        return fn

    def _dispatch_group(self, tx_side: str, rx_side: str,
                        group: _DecodeGroup) -> None:
        # snapshot: aborts only mutate `active` before dispatch (playout
        # resolution precedes the due step)
        for i in group.rows:
            hit = self._sched.get((tx_side, i))
            if hit is not None and hit[0] is group:
                del self._sched[(tx_side, i)]
        if not group.active.any():
            return
        ring = self._rings[tx_side]
        woff = group.w % self.ring_len
        if woff + group.Lpad <= self.ring_len:
            window = self._win(ring, np.int32(woff), group.Lpad)
        else:
            window = self._win_wrap(ring, self.ring_len - woff,
                                    group.Lpad)
        packed, self._keys[rx_side] = self._get_decoder(
            group.Lpad, group.payload_len)(window, self._keys[rx_side])
        self._pending_dec[rx_side].append((group, packed, self.steps))

    def _finalize(self, rx_side: str, group: _DecodeGroup,
                  packed_dev) -> None:
        pl = group.payload_len
        packed = np.asarray(packed_dev)          # [B, pl+1] uint8
        counts = np.zeros((self.batch,), np.int64)
        rows = np.asarray(group.rows)[group.active]
        hits = rows[packed[rows, pl] != 0]
        counts[hits] = pl
        self.frames_decoded += len(hits)
        self.frames_erased += len(rows) - len(hits)
        if len(hits):
            self._drain(rx_side, _DecOut(
                counts, np.ascontiguousarray(packed[:, :pl])))

    def _finalize_ready(self, rx_side: str, all_pending: bool = False) \
            -> None:
        q = self._pending_dec[rx_side]
        while q and (all_pending or q[0][2] < self.steps):
            group, packed, _ = q.popleft()
            # fetch wait (device compute + transfer, blocking) timed
            # APART from host parse: conflating them once read as a
            # 1.2 s/cohort "drain" at B=4096 when the true host cost
            # is ~22 ms.
            # soft_finalize, NOT host_drain: _finalize calls _drain,
            # whose own host_drain timer would nest inside this one
            # and double-count the drain in the totals (r5 finding)
            with metrics.timer("farm_hub.fetch_wait"):
                packed = np.asarray(packed)
            with metrics.timer("farm_hub.soft_finalize"):
                self._finalize(rx_side, group, packed)

    # -- the pump ------------------------------------------------------------

    def step(self) -> None:
        """One audio quantum for both directions: dispatch the window
        decodes that completed playout and launch new TX writes for
        BOTH directions before finalizing either — the first
        finalize's blocking device fetch would otherwise serialize
        ahead of the second direction's dispatches (VERDICT r4 task 1:
        overlap the two directions' device work).  Finalized decodes
        were dispatched on PREVIOUS steps, so the host parse overlaps
        this step's device work.  Quanta with no due window cost no
        device work."""
        for tx_side, rx_side in (("a", "b"), ("b", "a")):
            with metrics.timer("farm_hub.chunk"):
                for group in self._due[tx_side].pop(self.steps, ()):
                    self._dispatch_group(tx_side, rx_side, group)
            with metrics.timer("farm_hub.host_tx"):
                self._launch(tx_side)
        for rx_side in ("b", "a"):
            self._finalize_ready(rx_side)
        self.steps += 1
        self._resolve_playouts()

    def flush(self) -> None:
        for side in ("a", "b"):
            self._finalize_ready(side, all_pending=True)

    def _tx_active(self) -> bool:
        return (any(self._due[s] or self._pending_dec[s]
                    for s in ("a", "b"))
                or super()._tx_active())

    # -- observability --------------------------------------------------------

    def get_status(self) -> dict:
        return {
            "steps": self.steps,
            "native_deframer": self._deframers["a"].is_native,
            "ring_len": self.ring_len,
            "frames_decoded": self.frames_decoded,
            "frames_erased": self.frames_erased,
            "rs_parity": self._rs,
            "body_code": (type(self._body).__name__
                          if self._body is not None else None),
            "pending_decodes": {s: len(self._pending_dec[s])
                                for s in ("a", "b")},
        }


class BlindSoftFarmHub(RingHubBase):
    """Farm-scale ARQ over the soft-FEC wire with a fully BLIND
    receive path: RX never sees the hub's playout bookkeeping.

    ``SoftFarmHub`` above schedules one window decode per transmission
    from its own TX records (recovery inside the window is blind, but
    a real receiver would not know the window).  This hub instead runs
    ``ops/soft_blind.BlindSoftBatchReceiver`` per direction: every
    quantum the wire plays is CONSUMED from the ring (sliced + zeroed,
    exactly the hard hub's pump contract) and fed to the streaming
    receiver, which discovers sync peaks, reads payload lengths from
    the decoded headers, and delivers payload bytes in per-channel
    temporal order — the reference's acquisition model
    (/root/reference/src/modems/fsk.ts:297-315) at farm scale.

    Versus the scheduled hub this pays a per-quantum detector program
    (~ the hard-path pump cost) plus header/body programs per frame
    cohort; in exchange TX timing may jitter arbitrarily and no
    schedule is needed.  Channel noise is applied INSIDE the detector
    (on the wire, upstream of acquisition and decode alike) via
    ``device_channel_fn``.
    """

    def __init__(self, config, batch: int, quantum: int = 4800,
                 ring_quanta: int = 24,
                 device_channel_fn: Optional[Callable] = None,
                 rs_parity: int = 0, body_code=None,
                 max_payload: int = 160,
                 rx_ring_quanta: Optional[int] = None, seed: int = 0,
                 mesh=None):
        super().__init__(config, batch, quantum, ring_quanta, mesh=mesh)
        from webaudio_modem.ops.soft_blind import \
            BlindSoftBatchReceiver

        self._params = FSKParams.from_config(self.config)
        if quantum % self._params.downsample_ratio != 0:
            raise ValueError(
                f"quantum ({quantum}) must be a multiple of the "
                f"downsample ratio ({self._params.downsample_ratio})")
        self._rs = rs_parity
        self._body = body_code
        self._rx = {
            side: BlindSoftBatchReceiver(
                self._params, batch, quantum,
                ring_quanta=rx_ring_quanta, rs_parity=rs_parity,
                body_code=body_code, channel_fn=device_channel_fn,
                max_payload=max_payload, seed=seed + k, mesh=mesh)
            for k, side in enumerate(("a", "b"))}
        B, q = batch, quantum

        @functools.partial(jax.jit, donate_argnums=(0,))
        def _consume(ring, roff):
            frame = jax.lax.dynamic_slice(ring, (0, roff), (B, q))
            ring = jax.lax.dynamic_update_slice(
                ring, jnp.zeros((B, q), jnp.float32), (0, roff))
            return ring, frame

        self._consume = _consume

    # -- TX: FEC frame synthesis (same wire as SoftFarmHub) ------------------

    def _synth_full(self, side: str, datas) -> "jax.Array":
        return _soft_synth(self._params, datas, self._rs, self._body)

    # -- the pump -------------------------------------------------------------

    def step(self) -> None:
        """One audio quantum per direction: launch TX writes, consume
        the playing quantum from the wire, feed the blind receiver
        (its own pipeline overlaps detector/header/body dispatches
        with fetches from previous quanta), deliver what completed."""
        roff = np.int32((self.steps * self.quantum) % self.ring_len)
        got = []
        for tx_side, rx_side in (("a", "b"), ("b", "a")):
            with metrics.timer("farm_hub.host_tx"):
                self._launch(tx_side)
            with metrics.timer("farm_hub.chunk"):
                ring, frame = self._consume(self._rings[tx_side], roff)
                self._rings[tx_side] = ring
                events = self._rx[rx_side].feed(frame)
            got.append((rx_side, events))
        # deliver AFTER both directions' device work is in flight —
        # the drain's host loops would otherwise serialize ahead of
        # the second direction's dispatches
        for rx_side, events in got:
            self._deliver(rx_side, events)
        self.steps += 1
        self._resolve_playouts()

    def _deliver(self, rx_side: str, events) -> None:
        """Decoded payloads ARE wire bytes: plane them and drain
        through the batched deframer.  Multiple payloads for one
        channel in one step (rare) drain as ordered waves."""
        while events:
            seen = set()
            wave, rest = [], []
            for ch, pl in events:
                (rest if ch in seen else wave).append((ch, pl))
                seen.add(ch)
            counts = np.zeros((self.batch,), np.int64)
            width = max(len(p) for _, p in wave)
            plane = np.zeros((self.batch, max(width, 1)), np.uint8)
            for ch, p in wave:
                counts[ch] = len(p)
                plane[ch, :len(p)] = np.frombuffer(p, np.uint8)
            self._drain(rx_side, _DecOut(counts, plane))
            events = rest

    def flush(self) -> None:
        for side in ("a", "b"):
            self._deliver(side, self._rx[side].flush())

    def _tx_active(self) -> bool:
        return (any(self._rx[s].has_work() for s in ("a", "b"))
                or super()._tx_active())

    # -- observability ----------------------------------------------------------

    def get_status(self) -> dict:
        return {
            "steps": self.steps,
            "native_deframer": self._deframers["a"].is_native,
            "ring_len": self.ring_len,
            "rs_parity": self._rs,
            "body_code": (type(self._body).__name__
                          if self._body is not None else None),
            "rx": {s: self._rx[s].get_status() for s in ("a", "b")},
        }
