"""Batched modulator tests (reference tests/modems/fsk-modulation.node.test.ts)."""

import numpy as np
import pytest

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
from webaudio_modem.ops import fsk_mod

PARAMS = FSKParams.from_config(DEFAULT_FSK_CONFIG)


def test_signal_length_formula():
    # reference fsk-modulation.node.test.ts:75-109
    for n in (0, 1, 5, 13):
        sig = fsk_mod.modulate(PARAMS, bytes(n))
        assert len(sig) == fsk_mod.signal_length(PARAMS, n)


def test_amplitude_bounds():
    # reference fsk-modulation.node.test.ts:110-121
    sig = fsk_mod.modulate(PARAMS, b"\x55")
    assert sig.max() <= 1.1
    assert sig.min() >= -1.1
    assert sig.max() > 0.8
    assert sig.min() < -0.8


@pytest.mark.parametrize("data", [b"\x3c", b"\x0f", b"\xf0"])
def test_phase_continuity(data):
    # reference fsk-modulation.node.test.ts:126-161
    sig = fsk_mod.modulate(PARAMS, data)
    assert np.abs(np.diff(sig.astype(np.float64))).max() < 0.5


def test_leading_padding_and_trailing_silence():
    sig = fsk_mod.modulate(PARAMS, b"\x42")
    pad = PARAMS.samples_per_bit * 2
    silence = PARAMS.bits_per_byte * PARAMS.samples_per_bit
    assert np.all(sig[:pad] == 0)
    assert np.all(sig[-silence:] == 0)
    assert np.abs(sig[pad:pad + 100]).max() > 0.5


def test_matches_golden_modulator():
    # The batched DDS must produce (near) sample-identical output to the
    # scalar golden modulator: same phase law, different evaluation order.
    from webaudio_modem.golden import GoldenFSK

    g = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = b"Hello, World!"
    ref = g.modulate(data)
    sig = fsk_mod.modulate(PARAMS, data)
    assert sig.shape == ref.shape
    np.testing.assert_allclose(sig, ref, atol=2e-4)


def test_batch_modulation_matches_single():
    msgs = [b"abc", b"xyz"]
    batch = np.asarray(fsk_mod.modulate_batch(PARAMS, msgs))
    for i, m in enumerate(msgs):
        np.testing.assert_array_equal(batch[i], fsk_mod.modulate(PARAMS, m))


def test_different_patterns_differ_but_same_length():
    # reference fsk-modulation.node.test.ts:137-161
    s1 = fsk_mod.modulate(PARAMS, b"\x0f")
    s2 = fsk_mod.modulate(PARAMS, b"\xf0")
    assert len(s1) == len(s2)
    diff_frac = np.mean(np.abs(s1 - s2) > 0.1)
    assert diff_frac > 0.10


def test_framed_table_matches_direct():
    # the 256-entry framing table must equal per-byte _framed_bits for
    # every byte, including parity configs
    from webaudio_modem.models.config import FSKConfig, _framed_bits
    from webaudio_modem.ops.fsk_mod import _framed_table

    for parity in ("none", "even", "odd"):
        cfg = FSKConfig(parity=parity)
        table = _framed_table(cfg)
        for v in (0, 1, 0x55, 0x7E, 0xAA, 0xFF, 137):
            assert tuple(table[v]) == _framed_bits(v, cfg), (parity, v)


def test_int_phase_tables_match_float64():
    # the integer-arithmetic phase tables must match the float64 path
    # to float32 rounding (same phases mod 2*pi), and synthesize
    # near-identical signals
    from webaudio_modem.models.config import FSKConfig, FSKParams
    from webaudio_modem.ops import fsk_mod

    for baud, mark, space in ((1200, 1650, 1850), (300, 1270, 1070)):
        params = FSKParams.from_config(FSKConfig(
            baud_rate=baud, mark_frequency=mark, space_frequency=space))
        msgs = [b"Ab\x00\xff", b"\x55\x7e\x7e\x55"]
        bits = fsk_mod.frame_bits_batch(params, msgs)
        off64, om64 = fsk_mod._phase_tables(params, bits)
        off32, om32 = fsk_mod._phase_tables_int(params, bits)
        # circular comparison: an exact-integer zero and a float64
        # value infinitesimally below 2*pi are the same phase
        d = np.abs(off32 - off64)
        d = np.minimum(d, 2 * np.pi - d)
        assert d.max() < 2e-4
        np.testing.assert_allclose(om32, om64, rtol=1e-6)
        lead = params.samples_per_bit * 2
        trail = params.bits_per_byte * params.samples_per_bit
        ref = fsk_mod._synth(off64, om64, params.samples_per_bit,
                             (lead, trail))
        fast = fsk_mod._synth(off32, om32, params.samples_per_bit,
                              (lead, trail))
        np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                                   atol=5e-4)
        # the production path (_phase_acc_int host prefix + device-side
        # scale/omega in _synth_int) synthesizes the same signal
        acc = fsk_mod._phase_acc_int(params, bits)
        prod = fsk_mod._synth_int(acc, bits, int(params.sample_rate),
                                  float(params.mark_freq),
                                  float(params.space_freq),
                                  params.samples_per_bit, (lead, trail))
        np.testing.assert_allclose(np.asarray(prod), np.asarray(ref),
                                   atol=5e-4)
        np.testing.assert_allclose(np.asarray(prod), np.asarray(fast),
                                   atol=1e-5)


class TestFrameBitsBatchValidation:
    """frame_bits_batch is a public batch API (CLAUDE.md) and must
    validate its own inputs rather than rely on callers."""

    def test_empty_message_list_rejected(self):
        from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                      FSKParams)

        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        with pytest.raises(ValueError, match="at least one"):
            fsk_mod.frame_bits_batch(params, [])

    def test_unequal_lengths_rejected(self):
        from webaudio_modem.models.config import (DEFAULT_FSK_CONFIG,
                                                      FSKParams)

        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        # total byte count divisible by B — would silently mis-reshape
        with pytest.raises(ValueError, match="equal-length"):
            fsk_mod.frame_bits_batch(params, [b"abc", b"a"])
