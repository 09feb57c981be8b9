"""Golden scalar FSK model — the bit-exact comparator.

A deliberately *scalar, per-sample* re-implementation of the reference
FSKCore semantics (src/modems/fsk.ts), kept separate from the batched
implementation.  Two jobs:

  1. Differential-test oracle: the batched JAX/Pallas demodulator must
     produce identical decoded bytes on identical input.
  2. BER-parity comparator: BASELINE.md requires BER parity "measured
     against the reference algorithm's BER curve, obtained by running
     the bit-exact re-implementation" — this class is that comparator.

Faithfulness notes (quirks intentionally preserved):
  * The sync pattern-match loop indexes ``preambleSfdBits[patternBits - j]``
    (fsk.ts:307), which for j == 0 reads past the end of the array; in JS
    that yields ``undefined`` so the newest bit-block NEVER matches, yet
    still counts toward ``total``.  Max achievable match ratio is
    (n-1)/n.  Replicated here via the ``None`` pattern entry.
  * ``resetState`` (fsk.ts:175-188) resets the NCO, I/Q + post filters
    and downsample accumulators but NOT the pre-filter, AGC gain, sync
    ring buffers, or the adaptive silence threshold.
  * ``reset`` (fsk.ts:464-469) additionally clears the sync *bit* buffer
    and byte buffer but not the amplitude buffer.
  * The silence threshold persists across ``configure`` calls on the
    same instance (field initialised once, fsk.ts:128).
  * float32 quantization happens exactly where the reference stores into
    Float32Arrays: the modulated signal, AGC in-place output, and the
    pre-filter output buffer.  All other arithmetic is float64 (JS
    numbers).

The only deviation is the optional ``polarity`` slicer correction
(bit = 1 iff polarity*filteredPhaseDiff > 0): with mark < space —
every configuration the reference's tests exercise — polarity is +1 and
this is exactly the reference's ``phaseDiff > 0`` slicer (fsk.ts:264).
It additionally makes mark > space (Bell-103 answer-channel style)
configurations decode instead of inverting every bit.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from webaudio_modem.models.config import FSKConfig, FSKParams


class _Biquad:
    """Tight scalar biquad (DF-I), float64 state."""

    __slots__ = ("b0", "b1", "b2", "a1", "a2", "x1", "x2", "y1", "y2")

    def __init__(self, coeffs):
        self.b0, self.b1, self.b2, self.a1, self.a2 = coeffs
        self.reset()

    def reset(self):
        self.x1 = self.x2 = self.y1 = self.y2 = 0.0

    def process(self, x: float) -> float:
        y = (self.b0 * x + self.b1 * self.x1 + self.b2 * self.x2
             - self.a1 * self.y1 - self.a2 * self.y2)
        self.x2 = self.x1
        self.x1 = x
        self.y2 = self.y1
        self.y1 = y
        return y


class _Ring:
    """Scalar ring buffer with overwrite-oldest (reference RingBuffer)."""

    __slots__ = ("buf", "cap", "start", "n")

    def __init__(self, cap: int):
        self.cap = int(cap)
        self.buf = [0.0] * self.cap
        self.start = 0
        self.n = 0

    def put(self, v):
        idx = (self.start + self.n) % self.cap
        if self.n < self.cap:
            self.buf[idx] = v
            self.n += 1
        else:
            self.buf[self.start] = v
            self.start = (self.start + 1) % self.cap

    def get(self, i):
        return self.buf[(self.start + i) % self.cap]

    def clear(self):
        self.start = 0
        self.n = 0

    def __len__(self):
        return self.n


class GoldenFSK:
    """Scalar reference-semantics FSK modem (single channel)."""

    def __init__(self, config: Optional[FSKConfig] = None):
        self._silence_threshold = 0.01  # persists across configure()
        self.ready = False
        self.eod_events = 0
        self.sync_detections = 0
        self.demodulation_calls = 0
        self.total_samples = 0
        if config is not None:
            self.configure(config)

    # -- configuration ----------------------------------------------------

    def configure(self, config: FSKConfig) -> None:
        self.config = config
        self.params = p = FSKParams.from_config(config)
        self.pattern: List[Optional[int]] = list(p.pattern_bits)
        # fsk.ts:307 indexes pattern[len - j]; j==0 -> undefined.
        self._pattern_oob = None

        self._agc_enabled = config.agc_enabled
        self._agc_gain = 1.0
        self.pre = _Biquad(p.pre_filter)
        self.iq_i = _Biquad(p.iq_filter)
        self.iq_q = _Biquad(p.iq_filter)
        self.post = _Biquad(p.post_filter)

        self.samples_for_eod = p.samples_for_eod
        self.sync_bits = _Ring(int(p.max_sync_bits * p.ds_samples_per_bit
                                   * 1.1))
        self.sync_amps = _Ring(p.amp_window)
        self.byte_buffer: List[int] = []
        self._reset_state()
        self.ready = True

    def _reset_state(self) -> None:
        # reference resetState fsk.ts:175-188
        self.phase = 0.0
        self.last_phase = 0.0
        self.global_sample_counter = 0
        self.bit_sample_counter = 0
        self.bit_accumulator = 0
        self.bit_accum_count = 0
        self.next_bit_sample_index = 0
        self.byte_current = 0
        self.bit_position = 0
        self.frame_started = False
        self.silence_count = 0
        self.iq_i.reset()
        self.iq_q.reset()
        self.post.reset()
        self.ds_counter = 0
        self.ds_iacc = 0.0
        self.ds_qacc = 0.0

    def reset(self) -> None:
        # reference reset fsk.ts:464-469
        self._reset_state()
        self.sync_bits.clear()
        self.byte_buffer = []
        self.eod_events = 0
        self.sync_detections = 0
        self.demodulation_calls = 0
        self.total_samples = 0

    # -- modulation (fsk.ts:377-424) --------------------------------------

    def modulate(self, data: bytes) -> np.ndarray:
        p = self.params
        cfg = self.config
        data = bytes(data)
        frames = [*cfg.preamble_pattern, *cfg.sfd_pattern, *data]
        total_bytes = len(frames)
        padding = p.samples_per_bit * 2 if total_bytes > 0 else 0
        silence = p.bits_per_byte * p.samples_per_bit
        total = total_bytes * p.bits_per_byte * p.samples_per_bit \
            + padding + silence
        out = np.zeros(total, dtype=np.float32)

        idx = padding
        phase = 0.0
        two_pi = 2.0 * math.pi
        for byte in frames:
            bits = ([0] * cfg.start_bits
                    + [(byte >> i) & 1 for i in range(7, -1, -1)])
            if cfg.parity != "none":
                par = 0
                for i in range(8):
                    par ^= (byte >> i) & 1
                bits.append(par if cfg.parity == "even" else 1 - par)
            bits += [1] * cfg.stop_bits
            for bit in bits:
                freq = p.mark_freq if bit == 1 else p.space_freq
                dphi = two_pi * freq / p.sample_rate
                for _ in range(p.samples_per_bit):
                    if idx >= total:
                        break
                    out[idx] = math.sin(phase)
                    idx += 1
                    phase += dphi
        return out

    # -- demodulation (fsk.ts:190-375) -------------------------------------

    def demodulate(self, samples: np.ndarray) -> bytes:
        if not self.ready:
            raise RuntimeError("FSK demodulator not configured")
        self.demodulation_calls += 1
        self.total_samples += len(samples)

        samples = np.asarray(samples, dtype=np.float32)
        if self._agc_enabled:
            samples = self._agc(samples)
        # pre-filter buffer pass, float32-quantized per sample
        pre = self.pre
        filtered = np.empty(len(samples), dtype=np.float32)
        for i in range(len(samples)):
            filtered[i] = pre.process(float(samples[i]))

        p = self.params
        omega = 2.0 * math.pi * p.center_freq / p.sample_rate
        two_pi = 2.0 * math.pi
        for i in range(len(filtered)):
            s = float(filtered[i])
            si = s * math.cos(self.phase)
            sq = s * math.sin(self.phase)
            self.phase = (self.phase + omega) % two_pi
            si = self.iq_i.process(si)
            sq = self.iq_q.process(sq)
            self.ds_iacc += si
            self.ds_qacc += sq
            self.ds_counter += 1
            if self.ds_counter >= p.downsample_ratio:
                avg_i = self.ds_iacc / p.downsample_ratio
                avg_q = self.ds_qacc / p.downsample_ratio
                cur_phase = math.atan2(avg_q, avg_i)
                amplitude = math.sqrt(avg_i * avg_i + avg_q * avg_q)
                diff = cur_phase - self.last_phase
                if diff > math.pi:
                    diff -= two_pi
                elif diff < -math.pi:
                    diff += two_pi
                self.last_phase = cur_phase
                filtered_diff = self.post.process(diff)
                bit = 1 if p.polarity * filtered_diff > 0 else 0
                self.ds_iacc = 0.0
                self.ds_qacc = 0.0
                self.ds_counter = 0
                self._process_downsampled_bit(bit, amplitude)

        result = bytes(self.byte_buffer)
        self.byte_buffer = []
        return result

    def _agc(self, samples: np.ndarray) -> np.ndarray:
        # reference AGCProcessor.process fsk.ts:52-76 (in-place f32)
        p = self.params
        gain = self._agc_gain
        target = p.agc_target
        attack = p.agc_attack
        release = p.agc_release
        out = np.empty(len(samples), dtype=np.float32)
        for i in range(len(samples)):
            y = np.float32(float(samples[i]) * gain)
            out[i] = y
            level = abs(float(y))
            if level > target:
                gain += (target / level - gain) * attack
            elif level > 0:
                gain += (target / level - gain) * release
            gain = max(0.1, min(10.0, gain))
        self._agc_gain = gain
        return out

    def _process_downsampled_bit(self, bit: int, amplitude: float) -> None:
        p = self.params
        self.sync_bits.put(bit)
        self.sync_amps.put(amplitude)

        self.global_sample_counter += 1
        if amplitude < self._silence_threshold:
            self.silence_count += 1
            if self.silence_count >= self.samples_for_eod:
                self.eod_events += 1
                self._reset_state()
                return
        else:
            self.silence_count = 0

        if not self.frame_started:
            n_pat = len(self.pattern)
            window = n_pat * p.ds_samples_per_bit
            if (len(self.sync_bits) >= window
                    and self.global_sample_counter % p.quarter_bit == 0):
                matched = 0
                total = 0
                blen = len(self.sync_bits)
                for j in range(n_pat):
                    # fsk.ts:307 — pattern[n_pat - j]; j==0 is OOB.
                    pat = self.pattern[n_pat - j] if j != 0 else None
                    for k in range(p.ds_samples_per_bit):
                        idx = blen - (j * p.ds_samples_per_bit + k) - 1
                        if pat is not None and self.sync_bits.get(idx) == pat:
                            matched += 1
                        total += 1
                ratio = matched / total if total > 0 else 0.0
                if ratio > self.config.sync_threshold:
                    self.frame_started = True
                    self.byte_current = 0
                    self.bit_position = 0
                    self.bit_accumulator = 0
                    self.bit_accum_count = 0
                    self.bit_sample_counter = 0
                    self.next_bit_sample_index = 0
                    self.sync_detections += 1
                    amps = self.sync_amps
                    if len(amps):
                        mean = sum(amps.get(i) for i in range(len(amps))) \
                            / len(amps)
                        self._silence_threshold = mean * 0.1
        else:
            self.bit_accumulator += bit
            self.bit_accum_count += 1
            self.bit_sample_counter += 1
            if self.bit_sample_counter >= self.next_bit_sample_index:
                decided = 1 if self.bit_accumulator > \
                    (self.bit_accum_count / 2) else 0
                self.bit_accumulator = 0
                self.bit_accum_count = 0
                self.next_bit_sample_index += p.ds_samples_per_bit
                self._process_byte(decided)

    def _process_byte(self, bit: int) -> None:
        # reference processByte fsk.ts:346-375
        pos = self.bit_position
        stop_pos = self.params.stop_bit_position
        if pos == 0:
            if bit != 0:
                self._reset_state()
                return
        elif 1 <= pos <= 8:
            self.byte_current |= bit << (8 - pos)
        elif self.config.parity != "none" and pos == 9:
            pass  # parity bit ignored (fsk.ts:359-360)
        elif pos == stop_pos:
            if bit != 1:
                self.frame_started = False
                return
            self.byte_buffer.append(self.byte_current)
            self.byte_current = 0
            self.bit_position = -1
        else:
            self.frame_started = False
            return
        self.bit_position += 1

    # -- status (fsk.ts:481-493) ------------------------------------------

    def get_status(self) -> dict:
        return {
            "ready": self.ready,
            "frame_started": self.frame_started,
            "global_sample_counter": self.global_sample_counter,
            "received_bits_length": len(self.sync_bits),
            "byte_buffer_length": len(self.byte_buffer),
            "demodulation_calls": self.demodulation_calls,
            "sync_detections": self.sync_detections,
            "silence_threshold": self._silence_threshold,
            "total_samples_processed": self.total_samples,
        }
