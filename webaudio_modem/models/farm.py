"""ModemFarm — thousands of independent streaming FSK channels per chip.

The scale-out model BASELINE.json's north star asks for: B concurrent
48 kHz FSK streams demodulated with carried filter/NCO state, batched
through the same kernels as the single-channel FSKCore (models/fsk.py),
optionally sharded over a device mesh (parallel/sharding.py).

The reference achieves N channels by instantiating N AudioWorkletNodes
(demo/demo.js:233-237) — one JS thread each; here N is a tensor
dimension.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

import jax

from webaudio_modem.models.config import FSKConfig, FSKParams
from webaudio_modem.ops import fsk_demod, fsk_mod


class _FskOps:
    # bound lazily in _resolve_family: binding at class-body time would
    # read attributes off a partially initialized fsk_demod module when
    # ops.fsk_demod is the FIRST framework import (it pulls
    # models.config, whose package __init__ imports this module)
    init_state = None
    make_demod_chunk = None
    modulate_batch = None


class _PskOps:
    # staticmethods bound lazily on first PSK resolve (keeps the psk
    # module import off the FSK-only path)
    init_state = None
    make_demod_chunk = None
    modulate_batch = None


def _resolve_family(config):
    """Map a config object to its (ops singleton, derived params).
    The ops objects are module-level singletons so they are stable
    cache keys for _make_group_runner."""
    from webaudio_modem.models.psk import PSKConfig

    if isinstance(config, PSKConfig):
        from webaudio_modem.ops import psk as psk_ops

        if _PskOps.init_state is None:
            _PskOps.init_state = staticmethod(psk_ops.init_state)
            _PskOps.make_demod_chunk = staticmethod(
                psk_ops.make_demod_chunk)
            _PskOps.modulate_batch = staticmethod(psk_ops.modulate_batch)

        params = psk_ops.psk_params(
            carrier_frequency=config.carrier_frequency,
            baud_rate=config.baud_rate,
            sample_rate=config.sample_rate,
            preamble_pattern=tuple(config.preamble_pattern),
            sfd_pattern=tuple(config.sfd_pattern),
            start_bits=config.start_bits,
            stop_bits=config.stop_bits,
            parity=config.parity,
            sync_threshold=config.sync_threshold,
            agc_enabled=config.agc_enabled,
            pre_filter_bandwidth=config.pre_filter_bandwidth)
        return _PskOps, params

    if _FskOps.init_state is None:
        _FskOps.init_state = staticmethod(fsk_demod.init_state)
        _FskOps.make_demod_chunk = staticmethod(fsk_demod.make_demod_chunk)
        _FskOps.modulate_batch = staticmethod(fsk_mod.modulate_batch)
    return _FskOps, FSKParams.from_config(config)


import functools


@functools.lru_cache(maxsize=64)
def _make_group_runner(ops, params, ds_phase: int, chunk_size: int,
                       donate: bool, mesh=None):
    """Jitted scan over a [group, B, chunk] stack of frames with the
    carried state donated (when the farm donates) — the per-chunk
    computation is exactly demodulate_chunk's (the inner jitted step
    inlines into the trace).  Requires chunk_size % downsample_ratio
    == 0 so ds_phase is loop-invariant."""
    step = ops.make_demod_chunk(params, ds_phase, donate=False, mesh=mesh)

    @functools.partial(jax.jit,
                       donate_argnums=(0,) if donate else ())
    def run(state, xs):
        def body(st, x):
            st, out = step(st, x)
            return st, (out.byte_count, out.bytes_out)
        return jax.lax.scan(body, state, xs)

    return run


class ModemFarm:
    def __init__(self, config, batch: int,
                 mesh: Optional["jax.sharding.Mesh"] = None,
                 donate: bool = True):
        """``config`` selects the model family: an FSKConfig runs the
        FSK pipeline; a models.psk.PSKConfig runs DBPSK on the same
        shared stages."""
        self.config = config
        self._ops, self.params = _resolve_family(config)
        self.batch = batch
        self.mesh = mesh
        self._donate = donate
        if fsk_demod.AUTO_WARM_QUALITY:
            from webaudio_modem.models.psk import PSKConfig

            fsk_demod.warm_quality_calibration(
                self.params,
                family="psk" if isinstance(config, PSKConfig) else "fsk")
        self.state = self._ops.init_state(self.params, batch)
        if mesh is not None:
            from webaudio_modem.parallel.sharding import shard_state

            self.state = shard_state(self.state, mesh)
        self._ds_phase = 0

    # -- modulation ---------------------------------------------------------

    def modulate(self, messages: Sequence[bytes]):
        """[B] equal-length messages -> [B, T] signal batch."""
        if len(messages) != self.batch:
            raise ValueError(f"expected {self.batch} messages")
        sig = self._ops.modulate_batch(self.params, messages)
        if self.mesh is not None:
            from webaudio_modem.parallel.sharding import channel_sharding

            sig = jax.device_put(sig, channel_sharding(self.mesh))
        return sig

    # -- streaming demodulation --------------------------------------------

    def demodulate_chunk(self, samples) -> fsk_demod.DemodOut:
        """Feed one [B, T] frame; returns the raw DemodOut (device
        arrays).  Use ``collect_bytes`` to decode host-side."""
        step = self._ops.make_demod_chunk(self.params, self._ds_phase,
                                          donate=self._donate,
                                          mesh=self.mesh)
        self.state, out = step(self.state, samples)
        self._ds_phase = (self._ds_phase + samples.shape[-1]) \
            % self.params.downsample_ratio
        return out

    @staticmethod
    def collect_bytes(out: fsk_demod.DemodOut) -> List[bytes]:
        counts = np.asarray(out.byte_count)
        vals = np.asarray(out.bytes_out)
        return [bytes(vals[b, :counts[b]]) for b in range(len(counts))]

    def demodulate(self, samples, chunk_size: Optional[int] = None
                   ) -> List[bytes]:
        """Demodulate a full [B, T] batch (optionally in chunks),
        returning per-channel decoded bytes."""
        from webaudio_modem.utils.trace import metrics

        samples = np.asarray(samples, dtype=np.float32)
        B, T = samples.shape
        if B != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {B}")
        chunk = chunk_size or T
        collected = [bytearray() for _ in range(B)]
        for start in range(0, T, chunk):
            with metrics.timer("farm.chunk"):
                out = self.demodulate_chunk(samples[:, start:start + chunk])
                pieces = self.collect_bytes(out)
            for b, piece in enumerate(pieces):
                collected[b] += piece
        total = sum(len(c) for c in collected)
        if total:
            metrics.incr("farm.bytes_decoded", total)
        return [bytes(c) for c in collected]

    def demodulate_stream(self, samples, chunk_size: int,
                          group: int = 8) -> List[bytes]:
        """Throughput-mode streaming demodulation.

        Identical per-chunk computation to ``demodulate`` (fixed quanta,
        carried state — byte-for-byte the same decode), but ``group``
        consecutive chunks are scanned inside ONE jitted dispatch with
        the state donated across groups, so the host pays one dispatch
        and one transfer per group instead of per chunk — how a
        production farm should run whenever it can afford ``group``
        chunks of output latency.  Falls back to the per-chunk loop for a
        trailing partial group or when ``chunk_size`` is not aligned to
        the downsample ratio.
        """
        import jax.numpy as jnp

        from webaudio_modem.utils.trace import metrics

        samples = np.asarray(samples, dtype=np.float32)
        B, T = samples.shape
        if B != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {B}")
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        collected = [bytearray() for _ in range(B)]

        aligned = chunk_size % self.params.downsample_ratio == 0
        n_grouped = (T // (chunk_size * group)) * group \
            if aligned and group > 1 else 0
        if n_grouped:
            run = _make_group_runner(self._ops, self.params,
                                     self._ds_phase, chunk_size,
                                     self._donate, self.mesh)
            for g0 in range(0, n_grouped, group):
                lo = g0 * chunk_size
                hi = (g0 + group) * chunk_size
                xs = jnp.asarray(samples[:, lo:hi].reshape(
                    B, group, chunk_size).swapaxes(0, 1))
                with metrics.timer("farm.chunk"):
                    self.state, (counts, vals) = run(self.state, xs)
                    counts = np.asarray(counts)     # [group, B]
                    vals = np.asarray(vals)         # [group, B, maxb]
                # visit only (k, b) pairs that decoded bytes — counts is
                # almost always zero, and the dense double loop cost
                # ~100k numpy scalar reads per dispatch at farm B
                for k, b in zip(*np.nonzero(counts)):
                    collected[b] += bytes(vals[k, b, :counts[k, b]])
        # trailing chunks (or the whole signal when grouping is off)
        for start in range(n_grouped * chunk_size, T, chunk_size):
            with metrics.timer("farm.chunk"):
                out = self.demodulate_chunk(samples[:, start:start +
                                                    chunk_size])
                pieces = self.collect_bytes(out)
            for b, piece in enumerate(pieces):
                collected[b] += piece
        total = sum(len(c) for c in collected)
        if total:
            metrics.incr("farm.bytes_decoded", total)
        return [bytes(c) for c in collected]

    def reset(self) -> None:
        self.state = self._ops.init_state(self.params, self.batch)
        if self.mesh is not None:
            from webaudio_modem.parallel.sharding import shard_state

            self.state = shard_state(self.state, self.mesh)
        self._ds_phase = 0

    # -- checkpoint / resume (SURVEY.md §5) ---------------------------------

    def save(self, path) -> None:
        """Snapshot the full streaming state mid-stream."""
        from webaudio_modem.models import checkpoint

        checkpoint.save_state(path, self.state, self.config,
                              self._ds_phase)

    @classmethod
    def restore(cls, path, mesh=None, donate: bool = True) -> "ModemFarm":
        """Resume a farm from a checkpoint; decoding continues
        bit-identically from where the snapshot was taken."""
        from webaudio_modem.models import checkpoint

        state, config, ds_phase = checkpoint.load_state(path, mesh=mesh)
        farm = cls.__new__(cls)
        farm.config = config
        farm._ops, farm.params = _resolve_family(config)
        farm.batch = int(state.agc_gain.shape[0])
        farm.mesh = mesh
        farm._donate = donate
        farm.state = state
        farm._ds_phase = ds_phase
        return farm

    # -- observability ------------------------------------------------------

    def get_status(self) -> dict:
        return {
            "batch": self.batch,
            "sync_detections": np.asarray(self.state.sync_count),
            "eod_events": np.asarray(self.state.eod_count),
            "frames_started": np.asarray(self.state.started),
        }

    def get_signal_quality(self):
        """Per-channel SignalQuality estimates — all five fields
        computed for real (the reference declares this surface but
        stubs it to zeros — fsk.ts:471-479): snr/eye from the carried
        amplitude windows, ber from the sync-correlation mismatch,
        frequency offset / phase jitter from the per-class
        discriminator accumulators."""
        from webaudio_modem.core import SignalQuality
        from webaudio_modem.models.psk import PSKConfig

        is_psk = isinstance(self.config, PSKConfig)
        ber, freq, jitter, eye = fsk_demod.quality_from_state(
            self.params, self.state,
            delay_ds=self.params.ds_samples_per_bit if is_psk else 1,
            family="psk" if is_psk else "fsk")

        amps = np.asarray(self.state.amp_tail)          # [A, B]
        thr = np.asarray(self.state.threshold)          # [B]
        active = amps > thr[None, :]
        cnt = active.sum(0)
        asum = np.where(active, amps, 0.0).sum(0)
        mean = asum / np.maximum(cnt, 1)
        var = np.maximum((np.where(active, amps * amps, 0.0).sum(0)
                          / np.maximum(cnt, 1)) - mean * mean, 0.0)
        have = cnt >= 8
        with np.errstate(divide="ignore", invalid="ignore"):
            snr = np.where(have,
                           10 * np.log10((mean ** 2 + 1e-30)
                                         / (var + 1e-12)), 0.0)
        return [SignalQuality(snr=float(snr[b]), ber=float(ber[b]),
                              eye_opening=float(eye[b]),
                              phase_jitter=float(jitter[b]),
                              frequency_offset=float(freq[b]))
                for b in range(self.batch)]
