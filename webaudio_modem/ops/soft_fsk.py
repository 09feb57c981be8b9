"""Soft-decision FSK + FEC physical path — the reference FEC memo's
full receive flow, implemented.

The memo (/root/reference/advanced-error-correction.md) prescribes a
receive pipeline that REPLACES hard UART byte framing:

    process(samples) -> SoftDecisionDemodulator -> FECDecoder
                     -> DataFrameFramer -> frames

with preamble correlation for synchronization (its 相関法, using soft
values for robustness) and explicit valid-length management in the
frame header.  Here:

  TX  ``encode_frame_signal``: payload -> [LEN+CRC | payload+CRC]
      convolutionally coded (rate 1/2 K=7, ops/fec.py) -> raw coded
      bits appended after the standard preamble+SFD pattern -> phase-
      continuous FSK (no start/stop bits — the FEC grid replaces UART).
  RX  ``decode_frame_signal``: the SAME sequential demod front end
      (ops/fsk_demod soft stream), pattern correlation on the sliced
      bits (the block-sum correlator) anchored at its PEAK, then the
      payload bit grid is KNOWN: per-bit LLRs are windowed sums of the
      analog discriminator — fully parallel, no state machine — fed to
      the soft Viterbi, header first (fixed length), then the body.

Because decisions integrate the analog soft values across each bit and
the Viterbi exploits them across the whole frame, this path decodes at
SNRs where the hard UART modem has already collapsed (see
tests/transports/test_fec.py::TestSoftPhysicalLayer).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax.numpy as jnp

import jax

from webaudio_modem.models.config import FSKParams
from webaudio_modem.ops import fec, fsk_demod, fsk_mod
from webaudio_modem.utils.crc16 import CRC16

# jitted sync correlation for the streaming decoder: compiled once per
# (params, padded length) bucket instead of eager op-by-op dispatch
_sync_ratios_jit = jax.jit(fsk_demod._sync_ratios, static_argnums=0)

HEADER_PLAIN = fec.FRAME_HEADER_PLAIN  # LEN(2) + CRC16(LEN)
HEADER_CODED_BITS = 2 * (8 * HEADER_PLAIN + fec.K - 1)


def _body_coded_bits(payload_len: int, rs_parity: int = 0,
                     body_code=None) -> int:
    if body_code is not None:
        n_cw = -(-8 * (payload_len + 2) // body_code.k)
        return n_cw * body_code.n
    return 2 * (8 * (payload_len + 2 + rs_parity) + fec.K - 1)


def _check_rs(payload_len: int, rs_parity: int,
              body_code=None) -> None:
    if body_code is not None and rs_parity:
        raise ValueError("rs_parity is the concatenated mode of the "
                         "convolutional body code; it cannot combine "
                         "with an alternate body_code")
    if rs_parity == 0:
        return
    if rs_parity % 2 or rs_parity < 2:
        raise ValueError(f"rs_parity must be even >= 2, got {rs_parity}")
    if payload_len + 2 + rs_parity > 255:
        raise ValueError(
            f"RS codeword {payload_len + 2 + rs_parity} bytes exceeds "
            "255; shorten the payload or the parity")


def _block_encode_bodies(body_bits: np.ndarray, body_code) -> np.ndarray:
    """[B, 8*(pl+2)] body bits -> [B, n_cw * n] wire bits: each body is
    zero-padded to a whole number of (k-bit) codewords of the shared
    deterministic block code (LDPCCode or TurboCode) and encoded in
    ONE batch.  The memo's 'required information' — code/data lengths
    and block boundaries — reduces to (payload_len, body_code params)
    known at both ends."""
    B, bits8 = body_bits.shape
    k = body_code.k
    n_cw = -(-bits8 // k)
    padded = np.zeros((B, n_cw * k), body_bits.dtype)
    padded[:, :bits8] = body_bits
    cw = np.asarray(body_code.encode_batch(
        padded.reshape(B * n_cw, k)))
    return cw.reshape(B, n_cw * body_code.n).astype(np.int8)


def _block_decode_bits(body_code, llrs):
    """Uniform decode over the two block families: LDPC's decoder
    returns (bits, ok), turbo's returns bits (no intrinsic syndrome —
    the frame CRC16 is its gate, per the FEC doc's layering)."""
    out = body_code.decode_batch(llrs, iters=body_code.DEFAULT_ITERS)
    return out[0] if isinstance(out, tuple) else out


def _rs_encode_bodies(body_bytes: np.ndarray,
                      rs_parity: int) -> np.ndarray:
    """[B, k] frame bodies -> [B, k + rs_parity] RS codewords (the
    concatenated mode's outer code) — the ONE place both encoders get
    their wire format from."""
    from webaudio_modem.ops import rs

    k = body_bytes.shape[1]
    return np.asarray(rs.rs_encode_batch(
        body_bytes, k + rs_parity, k)).astype(np.uint8)


def encode_frame_signal(params: FSKParams, payload: bytes,
                        rs_parity: int = 0,
                        body_code=None) -> np.ndarray:
    """payload -> FSK signal carrying a coded frame (float32 [T]).
    ``rs_parity`` > 0 selects the concatenated RS-outer mode (see
    ``encode_frames_batch``); ``body_code`` (an ``ldpc.LDPCCode`` or
    ``turbo.TurboCode``) swaps the BODY's code from convolutional to
    concatenated block codewords — the header stays conv-coded so
    boundary detection is identical across body codes."""
    payload = bytes(payload)
    _check_rs(len(payload), rs_parity, body_code)
    body = fec.build_frame_body(payload)
    if rs_parity:
        body = _rs_encode_bodies(
            np.frombuffer(body, np.uint8)[None, :], rs_parity)[0] \
            .tobytes()
    if body_code is not None:
        body_coded = _block_encode_bodies(
            fec.bytes_to_bits(body)[None], body_code)[0]
    else:
        body_coded = fec.conv_encode_bits(fec.bytes_to_bits(body))
    coded = np.concatenate([
        fec.conv_encode_bits(fec.bytes_to_bits(
            fec.build_frame_header(len(payload)))),
        body_coded])
    bits = np.concatenate([np.asarray(params.pattern_bits, np.int8),
                           coded.astype(np.int8)])
    return fsk_mod.modulate_bits(params, bits)


def encode_frames_batch(params: FSKParams, payloads,
                        rs_parity: int = 0,
                        body_code=None) -> "jax.Array":
    """Equal-length payloads -> FSK signals [B, T], ONE device
    synthesis dispatch.

    Same frame layout as ``encode_frame_signal`` (sync pattern +
    coded header + coded body, shared lead/trail padding), but the
    whole batch is framed on the host (vectorized conv encode) and
    synthesized by a single jitted call — the per-message path costs
    B eager dispatches.
    The result stays device-resident (feed it straight to
    ``decode_frames_batch`` or a device channel model).  Phase tables
    follow ``fsk_mod.modulate_batch`` (exact-integer form for integer
    configs), so samples agree with ``encode_frame_signal`` to float32
    rounding; decoded bytes are identical.

    ``rs_parity`` > 0 switches the body to CONCATENATED coding (the
    memo's block-code branch as the outer code): body bytes =
    RS-systematic(payload + CRC16) with ``rs_parity`` parity symbols
    (ops/rs.py), then the rate-1/2 convolutional inner code as usual.
    The Viterbi inner decoder turns channel bursts into short byte
    errors, which the RS outer code corrects — up to rs_parity/2
    corrupted body bytes per frame.

    ``body_code`` (an ``ldpc.LDPCCode`` or ``turbo.TurboCode``)
    swaps the body's code to block codewords as in
    ``encode_frame_signal`` — one batched encode over all B x n_cw
    codewords."""
    payloads = [bytes(p) for p in payloads]
    if not payloads:
        raise ValueError("encode_frames_batch requires >= 1 payload")
    if len({len(p) for p in payloads}) != 1:
        raise ValueError("encode_frames_batch requires equal-length "
                         "payloads")
    _check_rs(len(payloads[0]), rs_parity, body_code)
    B = len(payloads)
    # the header depends only on the (shared) length: encode it once
    hdr_coded = fec.conv_encode_bits(fec.bytes_to_bits(
        fec.build_frame_header(len(payloads[0])))).astype(np.int8)
    # vectorized body framing: payload matrix + batched CRC16 column,
    # one unpackbits — the per-message build_frame_body loop cost
    # ~100 ms of host time per write group at B=1024 (the soft hub's
    # TX bottleneck; same O(B*n)-interpreter-steps class as the hard
    # path's pre-round-2 framing loop)
    pl = len(payloads[0])
    pay = np.frombuffer(b"".join(payloads), np.uint8).reshape(B, pl)
    crcs = CRC16.calculate_rows(pay)
    body_bytes = np.concatenate(
        [pay, (crcs >> 8).astype(np.uint8)[:, None],
         (crcs & 0xFF).astype(np.uint8)[:, None]], axis=1)
    body_bits = np.unpackbits(body_bytes, axis=1)
    if rs_parity:
        coded = _rs_encode_bodies(np.packbits(body_bits, axis=1),
                                  rs_parity)
        body_bits = np.unpackbits(coded, axis=1)
    if body_code is not None:
        body_coded = _block_encode_bodies(body_bits, body_code)
    else:
        body_coded = fec.conv_encode_bits_batch(body_bits) \
            .astype(np.int8)
    pattern = np.asarray(params.pattern_bits, np.int8)
    bits = np.concatenate([
        np.broadcast_to(pattern, (B, pattern.shape[0])),
        np.broadcast_to(hdr_coded, (B, hdr_coded.shape[0])),
        body_coded], axis=1)
    lead = params.samples_per_bit * 2
    trail = params.bits_per_byte * params.samples_per_bit
    if fsk_mod._int_config(params):
        acc = fsk_mod._phase_acc_int(params, bits)
        return fsk_mod._synth_int(acc, bits, int(params.sample_rate),
                                  float(params.mark_freq),
                                  float(params.space_freq),
                                  params.samples_per_bit, (lead, trail))
    offsets, omega = fsk_mod._phase_tables(params, bits)
    return fsk_mod._synth(offsets, omega, params.samples_per_bit,
                          (lead, trail))


@functools.lru_cache(maxsize=None)
def frames_synth_device_fn(params: FSKParams, payload_len: int):
    """Jitted ``[B, payload_len] uint8 payload plane -> [B, T] f32``
    frame synthesis ENTIRELY on device (conv body, no RS/block code).

    ``encode_frames_batch`` frames on the host and uploads int32 phase
    prefixes + int8 bits — ~17 MB per cohort at B=4096.  This variant uploads ONLY the raw
    payload bytes (~190 KB at B=4096) and runs framing + synthesis as
    one program:

      * CRC16 per row: the batched device bit-scan
        (``_crc16_bits_device``) over the payload bits.
      * rate-1/2 K=7 conv encode: the same shifted-column XOR form as
        ``fec.conv_encode_bits_batch``, in jnp.
      * exact integer phase prefix: within the coded-body region the
        per-bit advance takes only two values, so the exclusive
        prefix is ``head_total + space_step*i + (mark-space) *
        ones_before_i`` — the ones-count prefix is a triangular 0/1
        matmul (counts < 2^24, exact on every matmul route: 0/1
        operands are exact even in TF32 and bf16, and the sums
        accumulate in f32).
      * shared sin expansion + lead/trail pad as ``fsk_mod._synth_int``.

    Signals are bit-identical in sample values to
    ``encode_frames_batch`` (same int32 accumulators, same f32 ops —
    held by tests/transports/test_soft_batch_internals.py
    TestDeviceFrameSynthesis).
    Returns None when the config has non-integer frequencies (callers
    fall back to the host framing path)."""
    if not fsk_mod._int_config(params):
        return None
    K = fec.K
    pattern = np.asarray(params.pattern_bits, np.int64)
    hdr = fec.conv_encode_bits(fec.bytes_to_bits(
        fec.build_frame_header(payload_len))).astype(np.int64)
    head_bits = np.concatenate([pattern, hdr])            # [P+H]
    spb = params.samples_per_bit
    fs = int(params.sample_rate)
    mark_step = int(params.mark_freq) * spb % fs
    space_step = int(params.space_freq) * spb % fs
    # exclusive integer phase prefix over the shared head bits (host,
    # once per (params, payload_len))
    head_steps = np.where(head_bits == 1, mark_step, space_step)
    head_acc = (np.cumsum(head_steps) - head_steps) % fs
    head_total = int(head_steps.sum())
    nb = 2 * (8 * (payload_len + 2) + K - 1)   # coded body bits
    # ones_before_i = coded @ M, M[j, i] = 1 for j < i (strict upper)
    M = np.triu(np.ones((nb, nb), np.float32), 1)
    lead = spb * 2
    trail = params.bits_per_byte * spb
    two_pi = 2.0 * np.pi
    head_bits_j = jnp.asarray(head_bits, jnp.int32)
    head_acc_j = jnp.asarray(head_acc, jnp.int32)
    M_j = jnp.asarray(M)

    @jax.jit
    def synth(pay):                            # [B, payload_len] uint8
        B = pay.shape[0]
        pay = pay.astype(jnp.int32)
        shifts = jnp.arange(7, -1, -1, dtype=jnp.int32)
        pbits = ((pay[:, :, None] >> shifts[None, None, :]) & 1) \
            .reshape(B, -1)                    # [B, 8*pl] MSB-first
        crc = _crc16_bits_device(pbits)        # [B] int32
        crc_bits = (crc[:, None]
                    >> jnp.arange(15, -1, -1, dtype=jnp.int32)) & 1
        body_bits = jnp.concatenate([pbits, crc_bits], axis=1)
        n = body_bits.shape[1]                 # 8*(pl+2)
        padded = jnp.concatenate(
            [jnp.zeros((B, K - 1), jnp.int32), body_bits,
             jnp.zeros((B, K - 1), jnp.int32)], axis=1)
        streams = []
        for g in (fec.G0, fec.G1):
            acc = jnp.zeros((B, n + K - 1), jnp.int32)
            for j in range(K):
                if (g >> (K - 1 - j)) & 1:
                    acc = acc ^ jax.lax.slice_in_dim(
                        padded, j, j + n + K - 1, axis=1)
            streams.append(acc)
        coded = jnp.stack(streams, axis=2).reshape(B, nb)
        # 0/1 operands are exact in any input precision (TF32 and bf16
        # included) and the counts accumulate exactly in f32
        ones_before = jnp.round(
            coded.astype(jnp.float32) @ M_j).astype(jnp.int32)
        body_acc = (jnp.int32(head_total)
                    + jnp.int32(space_step)
                    * jnp.arange(nb, dtype=jnp.int32)[None, :]
                    + jnp.int32(mark_step - space_step) * ones_before) \
            % jnp.int32(fs)
        acc = jnp.concatenate(
            [jnp.broadcast_to(head_acc_j[None, :],
                              (B, head_acc_j.shape[0])), body_acc],
            axis=1)
        bits = jnp.concatenate(
            [jnp.broadcast_to(head_bits_j[None, :],
                              (B, head_bits_j.shape[0])), coded],
            axis=1)
        # shared sin expansion (fsk_mod._synth_int semantics)
        offsets = acc.astype(jnp.float32) * jnp.float32(two_pi / fs)
        omega = jnp.where(
            bits == 1, jnp.float32(two_pi * params.mark_freq / fs),
            jnp.float32(two_pi * params.space_freq / fs))
        k = jnp.arange(spb, dtype=jnp.float32)
        sig = jnp.sin(offsets[..., None] + omega[..., None] * k)
        sig = sig.reshape(B, -1)
        return jnp.pad(sig, ((0, 0), (lead, trail)))

    return synth


def frame_signal_length(params: FSKParams, payload_len: int,
                        rs_parity: int = 0, body_code=None) -> int:
    _check_rs(payload_len, rs_parity, body_code)
    n_bits = (len(params.pattern_bits) + HEADER_CODED_BITS
              + _body_coded_bits(payload_len, rs_parity, body_code))
    return (n_bits * params.samples_per_bit
            + 2 * params.samples_per_bit
            + params.bits_per_byte * params.samples_per_bit)


def _bit_llrs(params: FSKParams, softs: np.ndarray, start: int,
              n_bits: int) -> Optional[np.ndarray]:
    """Windowed-sum LLRs for ``n_bits`` raw bits on the ds grid
    starting at soft-stream index ``start``."""
    ds = params.ds_samples_per_bit
    end = start + n_bits * ds
    if start < 0 or end > len(softs):
        return None
    win = softs[start:end].reshape(n_bits, ds)
    # polarity: positive discriminator = mark only for mark < space
    return np.float32(params.polarity) * win.sum(axis=1)


def _payload_from_body_llr(b_llr, ln: int, rs_parity: int,
                           body_code=None) -> Optional[bytes]:
    """Body LLRs -> CRC-checked payload (or None).  Shared by the
    whole-signal and streaming decoders so the concatenated RS-outer
    and LDPC-body modes behave identically in both: inner Viterbi (or
    batched LDPC min-sum), optional batched RS correction (B=1 here),
    then the CRC16 gate."""
    if rs_parity and ln + 2 + rs_parity > 255:
        return None                     # corrupt header length
    if body_code is not None:
        # b_llr is bit-1-positive (Viterbi convention); block-code
        # LLRs are bit-0-positive -> negate.  Pad bits beyond
        # 8*(ln+2) are dropped after decode.
        n_cw = len(b_llr) // body_code.n
        bits_cw = _block_decode_bits(
            body_code,
            -np.asarray(b_llr, np.float32).reshape(n_cw, body_code.n))
        body_bits = np.asarray(bits_cw).reshape(-1)[:8 * (ln + 2)]
    else:
        body_bits = fec.viterbi_decode_soft(
            b_llr, 8 * (ln + 2 + rs_parity))
    body = fec.bits_to_bytes(body_bits)
    if rs_parity:
        from webaudio_modem.ops import rs
        arr = np.frombuffer(body, np.uint8)[None, :]
        corrected, _, _ = rs.rs_decode_batch(
            arr, ln + 2 + rs_parity, ln + 2)
        body = bytes(np.asarray(corrected)[0, :ln + 2]
                     .astype(np.uint8).tolist())
    payload = body[:ln]
    if CRC16.calculate(payload) == ((body[ln] << 8) | body[ln + 1]):
        return payload
    return None


def decode_frame_signal(params: FSKParams, samples,
                        state=None, rs_parity: int = 0,
                        body_code=None) -> Optional[bytes]:
    """Full memo receive flow on one signal: sync -> soft FEC decode of
    the header -> soft FEC decode of the body -> CRC-checked payload.
    Returns None when no valid frame is found.  ``rs_parity`` /
    ``body_code`` must match the encoder's."""
    _check_rs(0, rs_parity, body_code)
    samples = np.asarray(samples, np.float32)
    out = fsk_demod.soft_stream(params, samples)
    bits = out.bits[:, 0]
    softs = out.softs[:, 0].astype(np.float64)

    # 相関法: block-sum pattern correlation over the sliced bits
    ds = params.ds_samples_per_bit
    W = params.sync_window
    ext = jnp.concatenate(
        [jnp.zeros((W, 1), jnp.float32), jnp.asarray(bits)[:, None]], 0)
    ratios = np.asarray(fsk_demod._sync_ratios(params, ext))[:, 0]
    order = np.argsort(ratios)[::-1]
    threshold = params.config.sync_threshold

    for t_peak in order[:8]:            # a few best sync candidates
        if ratios[t_peak] <= threshold:
            break
        # The exact bit-grid origin relative to the correlation peak
        # depends on filter group delay (and the correlator's j==0
        # quirk), so it is searched rather than assumed: decode the
        # fixed-length header at every candidate offset in ONE batched
        # Viterbi call and let the header CRC select the right grid —
        # the memo's boundary-detection robustness, self-calibrating.
        offsets = list(range(int(t_peak) + 1 - ds - ds // 4,
                             int(t_peak) + 1 + ds // 4 + 1))
        cand = [(_bit_llrs(params, softs, off, HEADER_CODED_BITS), off)
                for off in offsets]
        cand = [(llr, off) for llr, off in cand if llr is not None]
        if not cand:
            continue
        stacked = np.stack([llr for llr, _ in cand])
        headers = fec.viterbi_decode_soft(stacked, 8 * HEADER_PLAIN)
        for k, (_, off) in enumerate(cand):
            header = fec.bits_to_bytes(headers[k])
            ln = (header[0] << 8) | header[1]
            crc = (header[2] << 8) | header[3]
            if CRC16.calculate(header[:2]) != crc:
                continue
            b_llr = _bit_llrs(params, softs,
                              off + HEADER_CODED_BITS * ds,
                              _body_coded_bits(ln, rs_parity,
                                               body_code))
            if b_llr is None:
                continue
            payload = _payload_from_body_llr(b_llr, ln, rs_parity,
                                             body_code)
            if payload is not None:
                return payload
    return None


class SoftFrameDecoder:
    """STREAMING receive flow of the FEC memo: feed arbitrary sample
    chunks; frames decode as soon as their span has arrived — including
    frames that span chunk boundaries (the memo's
    ``process(samples) -> SoftDecisionDemodulator -> FECDecoder ->
    Framer`` pipeline driven incrementally, matching the reference's
    chunked-stream contract, src/core.ts:99-102).

    The demod front end carries its state through
    ``fsk_demod.soft_stream`` (chunking is bit-exact), and the decoder
    keeps the un-consumed tail of the sliced-bit / soft-value streams:
    sync candidates whose coded span has not fully arrived stay pending;
    candidates whose span HAS arrived and failed every grid offset are
    cached as dead so junk is never re-Viterbi'd.  Decoded payloads are
    identical to ``decode_frame_signal`` on the whole signal.

    Match ratios are computed INCREMENTALLY: each feed correlates only
    the new positions (W of kept history + the new bits, end-padded to
    a power-of-two bucket so the jit cache stays O(log n) programs) and
    appends to a cached ratio buffer — correlation is backward-looking,
    so end padding cannot change a valid position's ratio, and the
    block sums are exact integers, so the cached values are identical
    to a whole-signal pass.  Without this, every feed would recompile
    the correlator at a new length (an XLA compile per audio chunk).
    """

    # extra ds samples kept behind the scan point: W of correlation
    # history + the LLR grid's look-back before a peak (~1.25 ds)
    def __init__(self, params: FSKParams, max_candidates_per_scan: int = 64,
                 rs_parity: int = 0, body_code=None):
        _check_rs(0, rs_parity, body_code)
        self._params = params
        self._rs_parity = rs_parity
        self._body_code = body_code
        self._state = None
        self._ds_phase = 0
        self._bits = np.zeros((0,), np.float32)
        self._softs = np.zeros((0,), np.float64)
        self._amps = np.zeros((0,), np.float64)
        self._abs0 = 0        # absolute ds index of _bits[0]
        self._scan_from = 0   # absolute ds index: consumed below this
        self._ratio = np.zeros((0,), np.float32)  # cached match ratios
        self._ratio_first = 0  # absolute ds index of _ratio[0]
        self._failed: set = set()  # dead candidate peaks (absolute)
        self._max_cand = max_candidates_per_scan
        self.frames_decoded = 0
        # (peak_ratio, soft_sum, soft_sumsq, count, amp_mean, amp_var)
        # over the sync window of the last DECODED frame — the soft
        # path never runs the chunk step's quality_window_update, so
        # the decoder captures the same statistics itself (see
        # SoftModemCore.get_signal_quality)
        self.last_sync_quality = None

    def reset(self) -> None:
        self.__init__(self._params, self._max_cand,
                      self._rs_parity, self._body_code)

    def feed(self, samples) -> list:
        """Ingest one chunk ([T] float32) and return the list of
        payloads completed by it (possibly empty)."""
        samples = np.asarray(samples, np.float32)
        if samples.ndim != 1:
            raise ValueError("SoftFrameDecoder.feed expects a [T] chunk")
        # split arbitrary chunk lengths into power-of-two pieces so the
        # jit cache stays bounded (~log2(maxT) programs per config) —
        # state carry keeps the result identical (FSKCore does the same)
        offset = 0
        while offset < len(samples):
            remaining = len(samples) - offset
            piece = 1 << (remaining.bit_length() - 1)
            out = fsk_demod.soft_stream(self._params,
                                        samples[offset:offset + piece],
                                        self._state, self._ds_phase)
            self._state, self._ds_phase = out.state, out.ds_phase
            self._bits = np.concatenate([self._bits, out.bits[:, 0]])
            self._softs = np.concatenate(
                [self._softs, out.softs[:, 0].astype(np.float64)])
            self._amps = np.concatenate(
                [self._amps, out.amps[:, 0].astype(np.float64)])
            offset += piece
        self._extend_ratios()
        frames = self._scan()
        self._trim()
        return frames

    # -- internals --------------------------------------------------------

    def _extend_ratios(self) -> None:
        """Correlate the not-yet-correlated tail of the bit stream and
        append to the cached ratio buffer.  The correlator only looks
        BACKWARD from a position (matched(t) reads ext indices
        <= W + t - ds, fsk_demod._sync_ratios_cumsum), so computing
        positions [s, e) needs exactly bits [s - W, e) — missing
        history below the stream start is zero, identical to the
        whole-signal path's zero-prepended ext."""
        W = self._params.sync_window
        s = self._ratio_first + len(self._ratio)
        e = self._abs0 + len(self._bits)
        n = e - s
        if n <= 0:
            return
        bucket = 1 << (n - 1).bit_length()  # next pow2 >= n
        lead = max(0, (self._abs0 - (s - W)))
        assert lead == 0 or self._abs0 == 0, \
            "trim dropped correlation history"
        ext = np.zeros((W + bucket, 1), np.float32)
        ext[lead:W + n, 0] = self._bits[s - W + lead - self._abs0:
                                        e - self._abs0]
        r = np.asarray(_sync_ratios_jit(
            self._params, jnp.asarray(ext)))[:n, 0]
        self._ratio = np.concatenate([self._ratio, r])

    def _scan(self) -> list:
        """Try sync candidates in TEMPORAL order (earliest first).

        Order matters: a decoded frame advances ``_scan_from`` past its
        coded span, consuming everything before it — ratio-descending
        order (the whole-signal decoder's choice) would let a stronger
        LATER frame consume an earlier one when both spans are buffered
        (e.g. a whole two-frame signal fed as one chunk).  Temporal
        order is deadlock-free because coded spans are time-ordered: if
        a candidate is pending (span not fully arrived), every later
        candidate is pending too — so a pending candidate ends the
        pass, and nothing decodable is ever behind it."""
        threshold = self._params.config.sync_threshold
        frames = []
        while True:
            ratios, first = self._ratio, self._ratio_first
            if not len(ratios):
                return frames
            t_abs = np.arange(first, first + len(ratios))
            ok = (t_abs >= self._scan_from) & (ratios > threshold)
            progressed = False
            tried = 0
            for t_peak in t_abs[ok]:
                t_peak = int(t_peak)
                if t_peak in self._failed:
                    continue
                if tried >= self._max_cand:
                    break  # per-feed work bound; resumes next feed
                tried += 1
                result, definitive = self._try_candidate(t_peak)
                if result is not None:
                    frames.append(result)
                    progressed = True
                    break  # rescan: scan_from advanced past this frame
                if definitive:
                    self._failed.add(t_peak)
                else:
                    break  # pending span: all later ones pending too
            if not progressed:
                return frames

    def _try_candidate(self, t_peak: int):
        """Attempt the full grid-offset search at one correlation peak.
        Returns (payload | None, definitive): definitive means every
        offset's span was available and failed — never retry."""
        params = self._params
        ds = params.ds_samples_per_bit
        end_abs = self._abs0 + len(self._softs)
        offsets = list(range(t_peak + 1 - ds - ds // 4,
                             t_peak + 1 + ds // 4 + 1))
        # wait until the whole header grid (every offset) has arrived —
        # keeps the offset search identical to the whole-signal path
        if offsets[-1] + HEADER_CODED_BITS * ds > end_abs:
            return None, False
        cand = []
        for off in offsets:
            llr = self._llrs(off, HEADER_CODED_BITS)
            if llr is not None:
                cand.append((llr, off))
        if not cand:
            return None, True
        stacked = np.stack([llr for llr, _ in cand])
        headers = fec.viterbi_decode_soft(stacked, 8 * HEADER_PLAIN)
        definitive = True
        for k, (_, off) in enumerate(cand):
            header = fec.bits_to_bytes(headers[k])
            ln = (header[0] << 8) | header[1]
            crc = (header[2] << 8) | header[3]
            if CRC16.calculate(header[:2]) != crc:
                continue
            body_bits = _body_coded_bits(ln, self._rs_parity,
                                         self._body_code)
            body_start = off + HEADER_CODED_BITS * ds
            if body_start + body_bits * ds > end_abs:
                definitive = False  # body still arriving — retry later
                continue
            b_llr = self._llrs(body_start, body_bits)
            if b_llr is None:
                continue
            payload = _payload_from_body_llr(b_llr, ln,
                                             self._rs_parity,
                                             self._body_code)
            if payload is not None:
                self.frames_decoded += 1
                # sync-window statistics for get_signal_quality.
                # Candidates are tried in TEMPORAL order, so t_peak is
                # the first threshold CROSSING, not the ratio maximum —
                # re-anchor at the local argmax (±ds) to match the
                # calibration's peak anchoring (quality_window_update /
                # _quality_calibration in fsk_demod.py), then take the
                # W ds-samples ending there (the KNOWN preamble+SFD).
                W = params.sync_window
                r0 = self._ratio_first
                lo_r = max(t_peak - ds, r0)
                hi_r = min(t_peak + ds + 1, r0 + len(self._ratio))
                seg = self._ratio[lo_r - r0:hi_r - r0]
                q_peak = lo_r + int(np.argmax(seg))
                lo = max(q_peak + 1 - W, self._abs0)
                win = self._softs[lo - self._abs0:
                                  q_peak + 1 - self._abs0]
                awin = self._amps[lo - self._abs0:
                                  q_peak + 1 - self._abs0]
                self.last_sync_quality = (
                    float(self._ratio[q_peak - r0]),
                    float(win.sum()), float((win ** 2).sum()),
                    float(len(win)),
                    float(awin.mean()) if len(awin) else 0.0,
                    float(awin.var()) if len(awin) else 0.0)
                self._scan_from = body_start + body_bits * ds
                self._failed = {t for t in self._failed
                                if t >= self._scan_from}
                return payload, True
        return None, definitive

    def _llrs(self, start_abs: int, n_bits: int):
        return _bit_llrs(self._params, self._softs,
                         start_abs - self._abs0, n_bits)

    def _trim(self) -> None:
        """Bound memory: drop everything the scanner can no longer
        reach (W of correlation history + the LLR look-back)."""
        params = self._params
        keep_back = params.sync_window + 2 * params.ds_samples_per_bit
        cut = self._scan_from - keep_back - self._abs0
        if cut > 0:
            self._bits = self._bits[cut:]
            self._softs = self._softs[cut:]
            self._amps = self._amps[cut:]
            self._abs0 += cut
        rcut = self._scan_from - self._ratio_first
        if rcut > 0:
            self._ratio = self._ratio[rcut:]
            self._ratio_first += rcut


def decode_frame_chunks(params: FSKParams, chunks,
                        rs_parity: int = 0, body_code=None) -> list:
    """Convenience: run the streaming decoder over an iterable of
    sample chunks and return every decoded payload (the chunked mode of
    ``decode_frame_signal`` — byte-identical output for any split)."""
    dec = SoftFrameDecoder(params, rs_parity=rs_parity,
                           body_code=body_code)
    frames = []
    for chunk in chunks:
        frames += dec.feed(chunk)
    return frames


def _aligned_rows(plane, base, U: int):
    """Per-channel contiguous row windows WITHOUT a scalar gather.

    plane [T, B], base [B] int32 (caller clips to [0, T - U]) ->
    aligned [U, B] with aligned[m, b] = plane[base[b] + m, b].

    A gather whose index varies per lane becomes a per-element
    gather; a per-channel row shift is a barrel shifter instead: one
    static slice + masked select per bit of the shift, all full-width
    vector ops.

    Shift bits are consumed MSB->LSB so the working plane TRUNCATES as
    it goes: once bit k is applied, every remaining per-lane shift is
    < k, so only the first U + k - 1 rows can still matter.  Pass k
    therefore touches U + 2k - 1 rows instead of T — total traffic
    ~O(U log2(T) + 4T) rows vs ~O(3 T log2(T)) for the ascending
    roll+select form (~4x less at the fused decode's header shapes),
    with bit-identical output: by induction x[j] = plane[s + j] with s
    the partial shift, so row m of the result is plane[base[b] + m]
    exactly (the zero padding below is never read for any base the
    callers produce, base <= T - U)."""
    T = plane.shape[0]
    if T < U:      # short stream: zero-pad so the static slice exists
        plane = jnp.concatenate(
            [plane, jnp.zeros((U - T, plane.shape[1]), plane.dtype)], 0)
        T = U
    max_shift = T - U
    if max_shift <= 0:
        return plane[:U]
    kmax = 1 << (int(max_shift).bit_length() - 1)
    need = U + 2 * kmax - 1       # row budget entering the kmax pass
    x = plane
    if T < need:
        x = jnp.concatenate(
            [x, jnp.zeros((need - T, x.shape[1]), x.dtype)], 0)
    k = kmax
    while k >= 1:
        nxt = U + k - 1           # rows still live after this pass
        shifted = jax.lax.slice(x, (k, 0), (k + nxt, x.shape[1]))
        x = jnp.where((base & k)[None, :] > 0, shifted, x[:nxt])
        k >>= 1
    return x                      # length is exactly U after k == 1


def _aligned_strided(plane, base, n_out: int, ds: int):
    """Per-channel STRIDED rows without a scalar gather:
    out[j, b] = plane[base[b] + j*ds, b] for j < n_out.

    The body stage only reads every ds-th row of its aligned window,
    so aligning the full (n_out-1)*ds+1 rows wastes ~ds x the traffic.
    Decompose base = q*ds + r: reshape the plane to [n_q, ds, B], pick
    phase r with a truncating barrel over the (tiny) ds axis, then
    align the resulting ds-times-smaller [n_q, B] plane by q with
    ``_aligned_rows``.  Exact: out[j] = plane[(q+j)*ds + r] =
    plane[base + j*ds]; the zero padding is only read past the stream
    end (channels the callers already mask)."""
    T, B = plane.shape
    if ds == 1:
        return _aligned_rows(plane, base, n_out)
    q = base // ds
    r = base - q * ds
    n_q = -(-T // ds) + 1          # +1: q+j may step one row past T/ds
    x = jnp.concatenate(
        [plane, jnp.zeros((n_q * ds - T, B), plane.dtype)], 0)
    x = x.reshape(n_q, ds, B)
    kmax = 1 << (int(ds - 1).bit_length() - 1)
    if ds < 2 * kmax:              # room for the first shifted slice
        x = jnp.concatenate(
            [x, jnp.zeros((n_q, 2 * kmax - ds, B), x.dtype)], 1)
    k = kmax
    while k >= 1:
        shifted = jax.lax.slice(x, (0, k, 0), (n_q, 2 * k, B))
        x = jnp.where((r & k)[None, None, :] > 0, shifted, x[:, :k])
        k >>= 1
    return _aligned_rows(x[:, 0], q, n_out)


def _grid_offsets(params: FSKParams) -> np.ndarray:
    """The header-start search grid around the correlation peak (+1):
    consecutive integer offsets spanning one bit period plus a quarter
    bit of slack each side."""
    ds = params.ds_samples_per_bit
    return np.arange(-ds - ds // 4, ds // 4 + 1)


# How many header-grid candidates per channel survive the alignment
# score and reach the (expensive) candidate Viterbi.  The full grid is
# n_off = 1.5 bit periods of consecutive offsets (31 at the default
# config) and the candidate Viterbi over B x n_off lanes measured 65%
# of the whole fused decode.  The aligned offsets maximize the
# windowed-|LLR| coherence score (misaligned windows straddle bit
# transitions and cancel), but near the decode cliff the score
# landscape is flat + noisy while decodability spans a ~15-offset
# contiguous run — empirically (rank probe at sigma=0.45, B=48) the
# best-scoring decodable offset ranks <= 7, so top-8 keeps frame
# success identical to the full grid at ~1/4 the trellis work; top-4
# lost 10/36 frames there.  0 = decode the full grid.
HEADER_TOP_K = 8


def _csum0(softs):
    """Zero-prefixed f32 time cumsum [n_ds + 1, B] of a soft plane.
    Its rounding depends on the backend's add order; every consumer is
    CRC-gated, per the f32 note in _batch_header_stage."""
    B = softs.shape[1]
    return jnp.concatenate(
        [jnp.zeros((1, B), jnp.float32),
         jnp.cumsum(softs.astype(jnp.float32), axis=0)], 0)


def _candidate_headers(params: FSKParams, csum, t_peak, gate,
                       body_bits_n: int, top_k: int):
    """Shared header-candidate machinery: ``_candidate_llrs`` and ONE
    batched Viterbi over the surviving candidates.  Returns (starts,
    headers, valid).  Called under an enclosing jit."""
    starts, h_llr, valid = _candidate_llrs(params, csum, t_peak, gate,
                                           body_bits_n, top_k)
    B, n_sel = starts.shape
    headers = fec._viterbi_core(
        h_llr.reshape(B * n_sel, HEADER_CODED_BITS // 2, 2),
        8 * HEADER_PLAIN).reshape(B, n_sel, 8 * HEADER_PLAIN)
    return starts, headers.astype(jnp.uint8), valid


def _candidate_llrs(params: FSKParams, csum, t_peak, gate,
                    body_bits_n: int, top_k: int):
    """Header candidates: grid starts around ``t_peak`` (stream-relative,
    [B] int32), barrel-aligned candidate LLR windows and optional top-k
    alignment-score pruning.

    ``csum`` is the zero-prefixed [n_ds + 1, B] f32 cumsum of the soft
    stream; ``gate`` [B] bool folds the caller's per-channel validity
    (peak-over-threshold for the window decoder, active-event mask for
    the blind receiver) into the candidate mask.  Returns
    (starts [B, n_sel], h_llr [B, n_sel, HEADER_CODED_BITS], valid)
    with the candidate axis n_sel = min(top_k, n_off) (or n_off when
    top_k == 0), candidates ordered by DESCENDING alignment score when
    pruned.  For every valid candidate h_llr[b, k, j] equals
    wsum[starts[b, k] + j*ds, b] exactly, wsum = polarity *
    (csum[ds:] - csum[:-ds]).
    """
    ds = params.ds_samples_per_bit
    h_bits = HEADER_CODED_BITS
    offsets_np = _grid_offsets(params)
    n_off = len(offsets_np)
    pad_lo = -int(offsets_np[0])         # static: grid reaches this
    n_ds = csum.shape[0] - 1
    B = csum.shape[1]
    offsets = jnp.asarray(offsets_np, jnp.int32)  # far below the peak

    starts = t_peak[:, None] + 1 + offsets[None, :]    # [B, n_off]
    valid = (starts >= 0) & (starts + h_bits * ds <= n_ds) & \
        gate[:, None] & \
        (starts + (h_bits + body_bits_n) * ds <= n_ds)

    # Candidate LLRs via ONE aligned window per channel: offsets are
    # consecutive ints, so every (offset, grid-bit) read lands inside
    # [starts[:,0], starts[:,0] + n_off + h_bits*ds) — barrel-align
    # that window once per channel and the per-candidate reads become
    # static strided slices.  pad_lo zero rows absorb grids whose low
    # offsets reach below the stream start (t_peak + 1 + off_min < 0);
    # the high clip engages only when even the last candidate's header
    # span exceeds the stream, in which case no candidate passes the
    # `valid` mask (it also requires the BODY span in range).
    # For every candidate the host keeps, the values are IDENTICAL to
    # a per-element gather.
    U = n_off + (h_bits - 1) * ds + 1
    len_pad = pad_lo + (n_ds + 1 - ds)                 # padded wsum rows
    base = jnp.clip(t_peak + 1, 0, max(len_pad - U, 0))
    wsum = jnp.float32(params.polarity) * (csum[ds:] - csum[:-ds])
    wsum = jnp.concatenate(
        [jnp.zeros((pad_lo, B), jnp.float32), wsum], 0)
    al = _aligned_rows(wsum, base, U)                  # [U, B]
    h_llr = jnp.stack(
        [jax.lax.slice(al, (o, 0), (o + (h_bits - 1) * ds + 1, B),
                       (ds, 1))
         for o in range(n_off)], axis=0)               # [n_off, h, B]
    h_llr = jnp.moveaxis(h_llr, -1, 0)                 # [B, n_off, h]

    if top_k and top_k < n_off:
        # alignment-coherence score; invalid candidates rank last so
        # pruning can only drop candidates the downstream mask would
        # have discarded anyway
        score = jnp.sum(jnp.abs(h_llr), axis=-1)       # [B, n_off]
        score = jnp.where(valid, score, -jnp.inf)
        iota_off = jnp.arange(n_off)
        sc = score
        ohs = []
        for _ in range(top_k):   # iterative argmax: no per-lane gather
            idx = jnp.argmax(sc, axis=-1)
            oh = iota_off[None, :] == idx[:, None]     # [B, n_off]
            ohs.append(oh)
            sc = jnp.where(oh, -jnp.inf, sc)
        onehot = jnp.stack(ohs, 1)                     # [B, k, n_off]
        # one-hot contraction instead of a per-lane gather (the same
        # no-scalar-gather rule as everywhere in this file).  HIGHEST
        # keeps it a true f32 product on every route: a TF32 matmul on
        # the GPU would round the LLRs to a 10-bit mantissa before the
        # Viterbi, while one 1.0 term per output is exact in f32
        h_llr = jnp.einsum("bko,boh->bkh",
                           onehot.astype(jnp.float32), h_llr,
                           precision=jax.lax.Precision.HIGHEST)
        starts = jnp.sum(onehot * starts[:, None, :], axis=-1) \
            .astype(jnp.int32)                         # [B, k]
        valid = jnp.any(onehot & valid[:, None, :], axis=-1)
    return starts, h_llr, valid


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def _batch_header_stage(params: FSKParams, bits, softs,
                        body_bits_n: int = 0, top_k: int = 0,
                        rsum=None):
    """Device half 1: sync peak + header-candidate selection + ONE
    batched Viterbi over the surviving (channel x offset) candidates.
    Everything stays in HBM; only the outputs (small int planes) cross
    to the host.

    ``body_bits_n`` (static) lets the stage compute each candidate's
    span-validity mask (header AND body inside the stream) so that
    ``top_k`` pruning never ranks an out-of-span candidate above a
    decodable one.  Returns (t_peak, peak_ok, csum, starts, headers,
    valid) with the candidate axis of length ``min(top_k, n_off)``
    (or n_off when top_k == 0), candidates ordered by DESCENDING
    alignment score.

    Pruning rationale: the grid search exists because the bit-grid
    origin relative to the correlation peak is unknown (group delay +
    the correlator's j==0 quirk — see decode_frame_signal).  But the
    alignment QUALITY of each offset is measurable without decoding:
    a bit-aligned LLR window integrates one coded bit coherently
    (|sum| ~ ds x amplitude) while a misaligned window straddles a
    transition and partially cancels (coded header bits are pseudo-
    random, ~50% transitions).  score(o) = sum_j |llr[o, j]| therefore
    peaks at the true grid origin; decoding only the top-k scoring
    offsets cuts the candidate-Viterbi lanes by n_off/k while keeping
    the offsets that could decode at all.  Selection changes WHICH
    passing offset is chosen (best-scoring instead of first-in-grid-
    order); both are CRC-validated headers of the same frame, and the
    payload byte contract is unchanged (differential test:
    tests/transports/test_soft_batch_internals.py::TestHeaderTopK).

    ``bits`` may be ``None`` when ``rsum`` is given — only its shape
    would be read, and softs carries the same one."""
    B = softs.shape[1]
    W = params.sync_window

    if rsum is not None:
        # stage C from the kernel's fused sliding block sums — the
        # hard path's R formulation (bit-identical to _sync_ratios on
        # the zero-prefixed ext, see _sync_ratios_from_r); a zero
        # r_tail IS the all-zeros window prefix of a one-shot decode
        ds = params.ds_samples_per_bit
        ratios = fsk_demod._sync_ratios_from_r(
            params, jnp.zeros((W - ds, B), rsum.dtype), rsum)
    else:
        ext = jnp.concatenate([jnp.zeros((W, B), bits.dtype), bits], 0)
        ratios = fsk_demod._sync_ratios(params, ext)   # [n_ds, B]
    t_peak = jnp.argmax(ratios, axis=0).astype(jnp.int32)
    peak = jnp.take_along_axis(ratios, t_peak[None, :], axis=0)[0]
    peak_ok = peak > jnp.float32(params.config.sync_threshold)

    # float32 cumsum (the per-signal host path uses f64): the LLR
    # window sums are differences of csum ds apart, so the error is
    # bounded by f32 eps x |csum| — softs are zero-mean under noise
    # (random-walk ~sqrt(n_ds)) and <= n_ds/2 in the all-one-tone
    # worst case, keeping window-sum error <= ~0.1% of its magnitude
    # even at maximum frame length.  CRC gates any borderline flip as a
    # clean None.
    csum = _csum0(softs)

    starts, headers, valid = _candidate_headers(
        params, csum, t_peak, peak_ok, body_bits_n, top_k)
    return (t_peak, peak_ok, csum, starts, headers, valid)


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _batch_body_stage(params: FSKParams, csum, b_starts,
                      payload_len: int, rs_parity: int = 0,
                      body_code=None):
    """Device half 2: body LLR windows at each channel's chosen grid +
    ONE batched Viterbi (+ the batched RS outer decode when the frame
    is concatenated-coded) or ONE batched block decode (LDPC min-sum /
    turbo max-log-MAP) over all
    B x n_cw codewords (``body_code`` mode).  Invalid channels decode
    garbage at a clipped start and are masked on the host."""
    ds = params.ds_samples_per_bit
    body_bits = _body_coded_bits(payload_len, rs_parity, body_code)
    n_body_bytes = payload_len + 2 + rs_parity
    n_rows, B = csum.shape
    # Strided phase-decomposed alignment: the body only reads every
    # ds-th row of its window, so align the ds-times-smaller phase
    # plane instead of the full (body_bits-1)*ds+1 rows (~6x less
    # HBM traffic).  b_starts >= 0 always (the host zeroes invalid
    # channels); the high clip engages only for channels whose body
    # span exceeds the stream — already invalid under the host's mask
    # (identical values for every channel it keeps).
    U = (body_bits - 1) * ds + 1
    n_wsum = n_rows - ds
    base = jnp.clip(b_starts, 0, max(n_wsum - U, 0))
    wsum = jnp.float32(params.polarity) * (csum[ds:] - csum[:-ds])
    b_llr = _aligned_strided(wsum, base, body_bits, ds).T   # [B, body]
    if body_code is not None:
        n_cw = body_bits // body_code.n
        bits_cw = _block_decode_bits(
            body_code, -b_llr.reshape(B * n_cw, body_code.n))
        bodies = bits_cw.reshape(
            B, n_cw * body_code.k)[:, :8 * (payload_len + 2)]
        return bodies.astype(jnp.uint8)
    bodies = fec._viterbi_core(
        b_llr.reshape(B, body_bits // 2, 2), 8 * n_body_bytes)
    if rs_parity:
        from webaudio_modem.ops import rs
        weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
        byts = jnp.sum(bodies.astype(jnp.int32)
                       .reshape(B, n_body_bytes, 8) * weights, axis=-1)
        corrected, _, _ = rs.rs_decode_batch(
            byts, n_body_bytes, payload_len + 2)
        # hand back the corrected data bytes as bits so the host path
        # below is identical for both modes (CRC16 stays the gate)
        bits = jnp.right_shift(
            corrected[:, :payload_len + 2, None],
            jnp.arange(7, -1, -1)[None, None, :]) & 1
        return bits.reshape(B, 8 * (payload_len + 2)).astype(jnp.uint8)
    return bodies.astype(jnp.uint8)


def _select_candidate(headers, starts, valid, payload_len=None,
                      max_len=None):
    """LEN/CRC header selection over the candidate axis (device).

    ``headers`` [B, n_sel, 32] uint8 decoded header bits,
    ``starts`` [B, n_sel], ``valid`` [B, n_sel].  Candidates must pass
    their own CRC16; ``payload_len`` (window decoder: all frames share
    one length) or ``max_len`` (blind receiver: length comes FROM the
    header, bounded to keep the per-length decode set finite) further
    gate the LEN field.  Returns (found [B] bool, ln [B] i32 — the
    selected candidate's decoded length, 0 when not found, st [B] i32 —
    its grid start).  argmax-of-bool keeps the first passing candidate
    (grid order unpruned, best-alignment-score order pruned)."""
    n_sel = headers.shape[1]
    hb = headers.astype(jnp.int32)                     # [B, n_sel, 32]
    w16 = (1 << jnp.arange(15, -1, -1)).astype(jnp.int32)
    ln = jnp.sum(hb[..., :16] * w16, -1)
    crc = jnp.sum(hb[..., 16:32] * w16, -1)
    ok = valid & (_crc16_bits_device(hb[..., :16]) == crc)
    if payload_len is not None:
        ok = ok & (ln == payload_len)
    if max_len is not None:
        ok = ok & (ln <= max_len)
    found = jnp.any(ok, axis=1)
    chosen = jnp.argmax(ok, axis=1)                    # first True
    oh = jnp.arange(n_sel)[None, :] == chosen[:, None]
    st = jnp.sum(jnp.where(oh, starts, 0), axis=1)     # starts[chosen]
    ln_sel = jnp.sum(jnp.where(oh & ok, ln, 0), axis=1)
    return found, ln_sel.astype(jnp.int32), st.astype(jnp.int32)


def _pack_bodies(bodies, payload_len: int, found):
    """Body CRC gate + packing (device): decoded body bits
    [B, 8*(payload_len+2)] -> ONE [B, payload_len + 1] uint8 plane
    (payload bytes + ok flag column), ok = ``found`` AND the frame's
    CRC16 over the payload bytes matches its trailing CRC bytes."""
    B = bodies.shape[0]
    bi = bodies.astype(jnp.int32)
    w8 = (1 << jnp.arange(7, -1, -1)).astype(jnp.int32)
    body_bytes = jnp.sum(bi.reshape(B, payload_len + 2, 8) * w8, -1)
    bcrc = (body_bytes[:, payload_len] << 8) | \
        body_bytes[:, payload_len + 1]
    body_ok = found & (_crc16_bits_device(bi[:, :8 * payload_len])
                       == bcrc)
    packed = jnp.concatenate(
        [body_bytes[:, :payload_len],
         body_ok[:, None].astype(jnp.int32)], axis=1)
    return packed.astype(jnp.uint8)


def _crc16_bits_device(bits):
    """CRC-16-CCITT-FALSE over an MSB-first bit stream, on device.

    Bit-serial shift/XOR recurrence (poly 0x1021, init 0xFFFF) — the
    textbook definition the host table implements
    (utils/crc16.py; reference src/utils/crc16.ts:12-38) — because a
    256-entry table lookup is a per-lane gather.  bits [..., n] 0/1 -> crc [...] int32."""
    def step(crc, b):
        msb = (crc >> 15) & 1
        return (((crc << 1) & 0xFFFF) ^ ((msb ^ b) * 0x1021)), None

    bits_t = jnp.moveaxis(bits.astype(jnp.int32), -1, 0)
    crc0 = jnp.full(bits.shape[:-1], 0xFFFF, jnp.int32)
    crc, _ = jax.lax.scan(step, crc0, bits_t)
    return crc


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4, 5))
def _decode_frames_fused(params: FSKParams, samples, payload_len: int,
                         rs_parity: int = 0, body_code=None,
                         top_k: Optional[int] = None):
    """The whole farm decode as ONE device program: seq demod ->
    header stage -> header CRC/LEN selection -> body stage -> body CRC
    gate, with the selection logic (formerly numpy between the two
    stage dispatches) in vector ops on device.  Returns ONE packed
    [B, payload_len + 1] uint8 array (payload bytes + ok flag column)
    so the host pays a single dispatch and a single small transfer
    instead of the staged form's 3 dispatches + 5 transfers.

    Selection is branch-free: the header stage ranks grid offsets by
    alignment-coherence score and keeps the top ``HEADER_TOP_K``
    (65% of this program was Viterbi-decoding all 31 offsets);
    argmax-of-bool then picks the best-scoring validating candidate.
    The payload byte contract matches the full-grid form (differential
    test TestHeaderTopK)."""
    B = samples.shape[0]
    ds = params.ds_samples_per_bit
    h_bits = HEADER_CODED_BITS

    state = fsk_demod.init_state(params, batch=B)
    _, _, _, _, bits, _, softs, rsum = fsk_demod._sequential_stage(
        params, 0, state, samples, with_rsum=True)

    body_bits_n = _body_coded_bits(payload_len, rs_parity, body_code)
    if top_k is None:
        top_k = HEADER_TOP_K
    t_peak, peak_ok, csum, starts, headers, valid = _batch_header_stage(
        params, bits, softs, body_bits_n, top_k, rsum)

    found, _, st = _select_candidate(headers, starts, valid,
                                     payload_len=payload_len)
    b_starts = jnp.where(found, st + h_bits * ds, 0).astype(jnp.int32)

    bodies = _batch_body_stage(params, csum, b_starts, payload_len,
                               rs_parity, body_code)    # [B, 8*(pl+2)]
    return _pack_bodies(bodies, payload_len, found)


def decode_frames_batch(params: FSKParams, samples,
                        payload_len: int, rs_parity: int = 0,
                        body_code=None):
    """Farm-scale soft decode: [B, T] signals -> list of payloads
    (None per channel that failed).

    ``rs_parity`` must match the encoder's: when > 0 the body is
    concatenated-coded (RS outer over payload+CRC, convolutional
    inner) and the batched RS decode runs on device between the body
    Viterbi and the host CRC gate.

    All channels must carry frames with the SAME payload length (the
    batched-modulation convention, fsk_mod.modulate_batch).  The whole
    batch is ONE device program (``_decode_frames_fused``): two
    batched Viterbi calls — every (channel x grid-offset) header
    candidate, then the bodies at each channel's CRC-selected grid —
    with the CRC/LEN selection logic between them in vector ops on
    device.  The soft planes, sync correlation, LLR windows, Viterbi
    and CRC gates all stay DEVICE-resident; the only device->host
    traffic is one [B, payload+1] byte plane (the earlier numpy
    formulation pulled ~200 MB of soft planes per batch to the host;
    the later staged form paid per-stage round trips).

    ``samples`` may be a device-resident jax array (e.g. synthesized
    on device, the DeviceFarmHub pattern) — it is used in place, no
    host round trip.

    ``body_code`` (an ``ldpc.LDPCCode`` or ``turbo.TurboCode``)
    must match the encoder's: the body Viterbi is replaced by one
    batched block decode (min-sum / max-log-MAP) on device.
    """
    return decode_frames_batch_async(
        params, samples, payload_len, rs_parity, body_code)()


def decode_frames_batch_async(params: FSKParams, samples,
                              payload_len: int, rs_parity: int = 0,
                              body_code=None):
    """Pipelined form of ``decode_frames_batch``: dispatches the fused
    device program and returns a zero-argument finalizer that blocks
    on the result and builds the payload list.

    jax dispatch is asynchronous, so a server draining a stream of
    batches overlaps batch t+1's device work with fetching batch t,
    where the blocking form pays a full dispatch round trip per call.
    Usage::

        pending = [decode_frames_batch_async(params, s, n) for s in xs]
        results = [p() for p in pending]
    """
    _check_rs(payload_len, rs_parity, body_code)
    if isinstance(samples, jax.Array):
        samples = samples.astype(jnp.float32)
    else:
        samples = jnp.asarray(np.asarray(samples, np.float32))
    B, T = samples.shape
    # fixed 2x downsample (fsk.ts:427-430): the seq stage at phase 0
    # emits T // 2 downsampled steps
    if T // 2 < HEADER_CODED_BITS * params.ds_samples_per_bit:
        # stream too short to hold even one coded header span — the
        # candidate index windows would run past the soft stream
        return lambda: [None] * B

    packed_dev = _decode_frames_fused(
        params, samples, payload_len, rs_parity, body_code)
    try:
        # start the device->host copy NOW: without it each finalizer's
        # np.asarray pays a full blocking fetch round trip, serialized
        # across batches
        packed_dev.copy_to_host_async()
    except (AttributeError, NotImplementedError):
        pass  # platforms without async host copies fall back to fetch

    def finalize():
        packed = np.asarray(packed_dev)
        results = [None] * B
        for b in np.nonzero(packed[:, payload_len])[0]:
            results[b] = bytes(packed[b, :payload_len])
        return results

    return finalize
