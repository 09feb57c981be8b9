"""Shared fixtures for the transport/FEC suites."""

import numpy as np
import pytest


@pytest.fixture
def soft_grid_search():
    """FSK-audio harness for raw-codeword FEC families (LDPC, turbo).

    Synthesizes [sync pattern | codeword bits] as FSK symbols (no UART,
    no conv framing), adds AWGN, runs the soft demod path, and tries
    ``attempt(llr)`` at every bit-grid offset around the correlation
    peak — the same offset window ``soft_fsk.decode_frame_signal``
    searches.  One copy shared by both audio tests so the grid logic
    cannot drift from only one of them.

    ``attempt`` receives the windowed-sum LLRs (positive = mark = bit
    1) and returns a decoded value or None; the first non-None wins.
    Returns ``(decoded, llr)`` or ``(None, None)``.
    """
    def run(params, cw, sigma, rng, attempt):
        import jax.numpy as jnp

        from webaudio_modem.ops import fsk_demod, fsk_mod
        from webaudio_modem.ops.soft_fsk import _bit_llrs

        bits = np.concatenate([np.asarray(params.pattern_bits, np.int8),
                               np.asarray(cw, np.int8)])[None]
        offsets, omega = fsk_mod._phase_tables(params, bits)
        sig = np.asarray(fsk_mod._synth(
            offsets, omega, params.samples_per_bit,
            (2 * params.samples_per_bit, params.samples_per_bit)))[0]
        sig = (sig + sigma * rng.standard_normal(len(sig))
               ).astype(np.float32)

        out = fsk_demod.soft_stream(params, sig)
        softs = np.asarray(out.softs)[:, 0].astype(np.float64)
        bbits = np.asarray(out.bits)[:, 0]
        ds = params.ds_samples_per_bit
        W = params.sync_window
        ext = jnp.concatenate([jnp.zeros((W, 1), jnp.float32),
                               jnp.asarray(bbits)[:, None]], 0)
        ratios = np.asarray(fsk_demod._sync_ratios(params, ext))[:, 0]
        t_peak = int(ratios.argmax())

        for off in range(t_peak + 1 - ds - ds // 4,
                         t_peak + 1 + ds // 4 + 1):
            llr = _bit_llrs(params, softs, off, len(cw))
            if llr is None:
                continue
            got = attempt(llr)
            if got is not None:
                return got, llr
        return None, None

    return run
