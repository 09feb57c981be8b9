"""Device-resident farm hubs — the WIRE lives in device HBM.

The host-playout hub (runtime/farm_channel.FarmLoopbackHub) builds a
[B, T] numpy frame per quantum and uploads it every quantum.
The hubs here remove audio from the host path entirely (VERDICT r2
missing #3 / next-step #2):

  * Each side owns a device-resident TX ring ``[B, ring_len]`` —
    the wire.  Transmissions are synthesized ON DEVICE (cohort-batched
    synthesis, one dispatch per message length per quantum) and
    written into the ring at quantum-aligned offsets.  The signal
    matrix never visits the host.
  * ``DeviceFarmHub`` (hard UART path): each ``step()`` runs ONE fused
    jitted pump per direction — slice the next quantum out of the
    ring, zero the consumed region, apply the on-device channel
    function (e.g. sim.make_device_awgn), and feed the batched
    demodulator with donated state.
  * The ONLY per-quantum device->host traffic is the decoded-byte
    aggregates ([B] counts + [B, maxb] bytes, a few tens of KB at
    B=4096), drained through the batched C++ deframer.
  * ``runtime/soft_hub.SoftFarmHub`` shares the ring machinery
    (``RingHubBase``) but decodes FEC frames in scheduled windows.

Playout bookkeeping is pure host arithmetic (write offsets and signal
lengths are data-independent), so ``modulate()`` futures resolve when
the read pointer passes the end of the written signal — the
modulate-resolves-on-playout contract (fsk-processor.ts:89-111) —
without ever inspecting device data.

The reference analog of this layout is the WebAudio render graph
moving samples between nodes off the main thread
(src/webaudio/processors/fsk-processor.ts:152-167, demo.js:403-413).
"""

from __future__ import annotations

import functools
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from webaudio_modem.models.farm import _resolve_family
from webaudio_modem.runtime.farm_channel import FarmHubBase, _TxEntry
from webaudio_modem.utils.trace import metrics


class RingHubBase(FarmHubBase):
    """Ring-wire machinery shared by the device-resident hubs: HBM
    TX rings, cohort-batched synthesis writes at quantum-aligned
    offsets, abort clearing, and playout-resolution bookkeeping.

    Subclasses provide ``_synth_full(side, datas) -> [B, T]`` (a
    device-resident full-batch synthesis of B equal-length messages)
    and may override ``_on_group_written`` to schedule receive-side
    work for the written playout window.
    """

    def __init__(self, config, batch: int, quantum: int,
                 ring_quanta: int, mesh=None):
        super().__init__(config, batch, quantum)
        if mesh is not None:
            from webaudio_modem.parallel.sharding import \
                check_mesh_batch

            check_mesh_batch(batch, mesh, type(self).__name__)
        self.mesh = mesh
        self.ring_len = ring_quanta * quantum
        self._rings = {
            "a": jnp.zeros((batch, self.ring_len), jnp.float32),
            "b": jnp.zeros((batch, self.ring_len), jnp.float32)}
        if mesh is not None:
            # the wire itself shards over the channel mesh: rings are
            # batch-FIRST [B, ring_len] (unlike the time-major demod
            # state), so the spec is explicit rather than the
            # shard_state rank rule.  Every ring op (write/clear/pump
            # slice) is per-row math — XLA propagates the sharding
            # with zero collectives.
            from jax.sharding import NamedSharding, PartitionSpec as P
            ring_sh = NamedSharding(mesh, P("channels", None))
            self._rings = {s: jax.device_put(r, ring_sh)
                           for s, r in self._rings.items()}
        # host playout bookkeeping, absolute sample clock
        self._busy_until = {"a": [0] * batch, "b": [0] * batch}
        # step index -> [(channel, entry)] resolved when that step's
        # quantum has been consumed
        self._resolve_at: Dict[str, Dict[int, list]] = {
            "a": defaultdict(list), "b": defaultdict(list)}
        B = batch

        @functools.partial(jax.jit, donate_argnums=(0,))
        def _ring_write(ring, sig, mask, woff):
            """Overwrite columns [woff, woff+L) of the masked rows with
            sig (select, not add): rows outside the cohort keep their
            concurrent signals untouched, rows inside drop whatever
            stale audio a previous ring revolution left there."""
            win = jax.lax.dynamic_slice(ring, (0, woff), sig.shape)
            win = win * (1.0 - mask[:, None]) + sig * mask[:, None]
            return jax.lax.dynamic_update_slice(ring, win, (0, woff))

        @functools.partial(jax.jit, donate_argnums=(0,))
        def _ring_write_row(ring, row, mask, woff):
            """Uniform-cohort write: every masked row carries the SAME
            [L] signal, broadcast inside the program.  Control traffic
            (ACK/NAK/EOT floods) re-uses one cached synthesized row, so
            the launch uploads nothing but the [B] mask — the full-B
            synthesis was ~17 MB of phase tables per cohort at
            B=4096."""
            win = jax.lax.dynamic_slice(
                ring, (0, woff), (ring.shape[0], row.shape[0]))
            win = win * (1.0 - mask[:, None]) \
                + row[None, :] * mask[:, None]
            return jax.lax.dynamic_update_slice(ring, win, (0, woff))

        @functools.partial(jax.jit, static_argnums=(3,),
                           donate_argnums=(0,))
        def _ring_clear(ring, keep, coff, width):
            """Zero columns [coff, coff+width) of the rows where keep
            is 0 (abort: stop feeding the wire)."""
            win = jax.lax.dynamic_slice(ring, (0, coff), (B, width))
            win = win * keep[:, None]
            return jax.lax.dynamic_update_slice(ring, win, (0, coff))

        self._ring_write = _ring_write
        self._ring_write_row = _ring_write_row
        self._ring_clear = _ring_clear
        # data -> (padded [Lpad] device row, true signal length T) for
        # uniform cohorts; bounded (control bytes dominate: 3 entries)
        self._uniform_rows: Dict[bytes, tuple] = {}

    # -- TX: device-resident playout ----------------------------------------

    def _quanta(self, n: int) -> int:
        return -(-n // self.quantum) * self.quantum

    def _synth_full(self, side: str, datas) -> "jax.Array":
        """Full-batch synthesis of B equal-length messages -> device
        [B, T].  Subclass hook (UART framing vs FEC frames)."""
        raise NotImplementedError

    def _on_group_written(self, side: str, w: int, Lpad: int, T: int,
                          rows, entries, length: int) -> None:
        """Called after a cohort's signal entered the ring at absolute
        sample offset ``w`` (playout window [w, w+Lpad)).  Base: no-op;
        the soft hub schedules the window decode here."""

    def _launch(self, side: str) -> None:
        t_read = self.steps * self.quantum  # quantum consumed THIS step
        for length, (rows, datas, entries) in \
                self._collect_launchable(side).items():
            # sub-group by write offset (stop-and-wait traffic is idle
            # when it sends, so almost always one group at t_read)
            by_w = defaultdict(lambda: ([], [], []))
            for i, d, e in zip(rows, datas, entries):
                w = self._quanta(max(t_read, self._busy_until[side][i]))
                g = by_w[w]
                g[0].append(i)
                g[1].append(d)
                g[2].append(e)
            for w, (rws, ds, es) in by_w.items():
                self._write_group(side, w, t_read, rws, ds, es, length)

    def _defer(self, side: str, rows, entries) -> None:
        """Ring too full: push the entries back and retry next step."""
        for i, e in zip(rows, entries):
            e.state = _TxEntry.QUEUED
            self._playing[side][i] = None
            self._pending_tx[side][i].appendleft(e)
            self._ready_tx[side].add(i)

    def _uniform_row(self, side: str, data: bytes):
        """Cached padded [Lpad] device row for a uniform cohort (every
        launchable message identical — control floods).  Synthesized at
        B=1 once per distinct message; later launches upload only the
        [B] mask."""
        hit = self._uniform_rows.get(data)
        if hit is None:
            sig = self._synth_full(side, [data])          # [1, T]
            T = int(sig.shape[1])
            Lpad = self._quanta(T)
            row = sig[0]
            if Lpad != T:
                row = jnp.pad(row, (0, Lpad - T))
            if len(self._uniform_rows) >= 16:
                self._uniform_rows.clear()
            hit = self._uniform_rows[data] = (row, T)
        return hit

    def _write_group(self, side: str, w: int, t_read: int,
                     rows, datas, entries, length: int) -> None:
        # uniform cohorts (control floods: every message identical)
        # reuse one cached synthesized row and upload only the mask
        uniform = all(d == datas[0] for d in datas)
        if uniform:
            row, T = self._uniform_row(side, datas[0])
            sig = None
        else:
            # full-B synthesis with a row mask: in the farm-flood case
            # every row transmits anyway, and the masked form needs no
            # scatter
            msgs_full = [datas[0]] * self.batch
            for i, d in zip(rows, datas):
                msgs_full[i] = d
            sig = self._synth_full(side, msgs_full)       # device
            T = int(sig.shape[1])
        Lpad = self._quanta(T)
        if w + Lpad - t_read > self.ring_len:
            if Lpad + self.quantum > self.ring_len:
                raise ValueError(
                    f"signal of {T} samples ({Lpad // self.quantum} "
                    f"quanta) cannot fit the ring "
                    f"({self.ring_len // self.quantum} quanta) — raise "
                    f"ring_quanta")
            self._defer(side, rows, entries)
            return
        mask = np.zeros((self.batch,), np.float32)
        mask[rows] = 1.0
        mask = jnp.asarray(mask)
        woff = w % self.ring_len
        ring = self._rings[side]
        if uniform:
            if woff + Lpad <= self.ring_len:
                ring = self._ring_write_row(ring, row, mask,
                                            np.int32(woff))
            else:
                n1 = self.ring_len - woff
                ring = self._ring_write_row(ring, row[:n1], mask,
                                            np.int32(woff))
                ring = self._ring_write_row(ring, row[n1:], mask,
                                            np.int32(0))
        else:
            if Lpad != T:
                sig = jnp.pad(sig, ((0, 0), (0, Lpad - T)))
            if woff + Lpad <= self.ring_len:
                ring = self._ring_write(ring, sig, mask, np.int32(woff))
            else:
                n1 = self.ring_len - woff
                ring = self._ring_write(ring, sig[:, :n1], mask,
                                        np.int32(woff))
                ring = self._ring_write(ring, sig[:, n1:], mask,
                                        np.int32(0))
        self._rings[side] = ring
        s_end = (w + T - 1) // self.quantum
        for i, e in zip(rows, entries):
            self._busy_until[side][i] = w + T
            e.cohort = (w, Lpad)  # device hub: playout region record
            self._resolve_at[side][s_end].append((i, e))
        self._on_group_written(side, w, Lpad, T, rows, entries, length)

    def _stop_playing(self, side: str, index: int,
                      entry: _TxEntry) -> None:
        """Abort: zero this channel's remaining unread ring region so
        the wire stops carrying the transmission."""
        if entry.cohort is None:
            return
        w, Lpad = entry.cohort
        t_next = self.steps * self.quantum
        lo = max(w, t_next)
        hi = w + Lpad
        if hi <= lo:
            return
        keep = np.ones((self.batch,), np.float32)
        keep[index] = 0.0
        keep = jnp.asarray(keep)
        ring = self._rings[side]
        coff = lo % self.ring_len
        width = hi - lo
        if coff + width <= self.ring_len:
            ring = self._ring_clear(ring, keep, np.int32(coff), width)
        else:
            n1 = self.ring_len - coff
            ring = self._ring_clear(ring, keep, np.int32(coff), n1)
            ring = self._ring_clear(ring, keep, np.int32(0), width - n1)
        self._rings[side] = ring
        self._busy_until[side][index] = t_next

    def _resolve_playouts(self) -> None:
        done_step = self.steps - 1
        for side in ("a", "b"):
            for i, e in self._resolve_at[side].pop(done_step, ()):
                if e.state != _TxEntry.PLAYING:
                    continue  # cancelled / reset
                e.state = _TxEntry.DONE
                if self._playing[side][i] is e:
                    self._playing[side][i] = None
                if e.fut is not None and not e.fut.done():
                    e.fut.set_result(None)
                if self._pending_tx[side][i]:
                    self._ready_tx[side].add(i)


class DeviceFarmHub(RingHubBase):
    """B full-duplex wires held in device HBM; host traffic bytes-only.

    Same channel surface as FarmLoopbackHub (``channel(side, i)`` ->
    FarmDataChannel with modulate / demodulate / next_frame), same
    cohort TX submission model, same batched native drain.

    ``device_channel_fn``: optional jittable ``fn(frame, key) -> frame``
    applied inside the pump (see sim.make_device_awgn).  ``ring_quanta``
    sizes the wire: it must hold the longest signal (rounded up to
    whole quanta) plus one quantum of slack.
    """

    def __init__(self, config, batch: int, quantum: int = 4800,
                 ring_quanta: int = 16,
                 device_channel_fn: Optional[Callable] = None,
                 seed: int = 0, mesh=None):
        super().__init__(config, batch, quantum, ring_quanta, mesh=mesh)
        self._ops, self._params = _resolve_family(config)
        if quantum % self._params.downsample_ratio != 0:
            raise ValueError(
                f"quantum ({quantum}) must be a multiple of the "
                f"downsample ratio ({self._params.downsample_ratio})")
        self._states = {"a": self._ops.init_state(self._params, batch),
                        "b": self._ops.init_state(self._params, batch)}
        self._keys = {"a": jax.random.PRNGKey(seed),
                      "b": jax.random.PRNGKey(seed + 1)}
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from webaudio_modem.parallel.sharding import shard_state
            self._states = {s: shard_state(st, mesh)
                            for s, st in self._states.items()}
            rep = NamedSharding(mesh, P())
            self._keys = {s: jax.device_put(k, rep)
                          for s, k in self._keys.items()}
        self._pending_out: Dict[str, Optional[object]] = {
            "a": None, "b": None}

        inner = self._ops.make_demod_chunk(self._params, 0, donate=False,
                                           mesh=mesh)
        chan = device_channel_fn
        B, q = batch, quantum

        @functools.partial(jax.jit, donate_argnums=(0, 1, 3))
        def _pump(ring, state, roff, key):
            frame = jax.lax.dynamic_slice(ring, (0, roff), (B, q))
            ring = jax.lax.dynamic_update_slice(
                ring, jnp.zeros((B, q), jnp.float32), (0, roff))
            if chan is not None:
                key, sub = jax.random.split(key)
                frame = chan(frame, sub)
            state, out = inner(state, frame)
            return ring, state, out, key

        self._pump = _pump

    def _synth_full(self, side: str, datas) -> "jax.Array":
        return self._ops.modulate_batch(self._params, datas)

    # -- the pump ----------------------------------------------------------

    def step(self) -> None:
        """One audio quantum for both directions: launch TX writes into
        the device rings, run the fused pump (ring slice -> clear ->
        channel -> demod), then drain the PREVIOUS quantum's bytes while
        the device computes this one."""
        roff = np.int32((self.steps * self.quantum) % self.ring_len)
        for tx_side, rx_side in (("a", "b"), ("b", "a")):
            with metrics.timer("farm_hub.host_tx"):
                self._launch(tx_side)
            with metrics.timer("farm_hub.chunk"):
                ring, state, out, key = self._pump(
                    self._rings[tx_side], self._states[rx_side], roff,
                    self._keys[rx_side])
                self._rings[tx_side] = ring
                self._states[rx_side] = state
                self._keys[rx_side] = key
                prev, self._pending_out[rx_side] = \
                    self._pending_out[rx_side], out
                if prev is not None:
                    self._drain(rx_side, prev)
        self.steps += 1
        self._resolve_playouts()

    def flush(self) -> None:
        for side in ("a", "b"):
            out, self._pending_out[side] = self._pending_out[side], None
            if out is not None:
                self._drain(side, out)

    # -- observability ------------------------------------------------------

    def get_status(self) -> dict:
        occupied = {
            side: max((bu for bu in self._busy_until[side]), default=0)
            - self.steps * self.quantum
            for side in ("a", "b")}
        return {
            "steps": self.steps,
            "native_deframer": self._deframers["a"].is_native,
            "ring_len": self.ring_len,
            "ring_occupancy_samples": {s: max(v, 0)
                                       for s, v in occupied.items()},
            "sync_detections": {
                s: np.asarray(self._states[s].sync_count)
                for s in ("a", "b")},
        }
