"""Sync-threshold and reconfiguration behavior
(reference tests/modems/fsk-simplesync.node.test.ts)."""

import numpy as np
import pytest

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKConfig
from webaudio_modem.models.fsk import FSKCore

SYNC300 = FSKConfig(baud_rate=300, mark_frequency=1650,
                    space_frequency=1850, sync_threshold=0.85)


class TestSimpleSync:
    def test_detects_pattern_in_clean_signal_300baud(self):
        # fsk-simplesync.node.test.ts:25-40
        core = FSKCore(SYNC300)
        data = b"\x48"
        assert core.demodulate_data(core.modulate_data(data)) == data
        assert core.get_status()["sync_detections"] == 1

    @pytest.mark.parametrize("threshold", [0.7, 0.75, 0.8, 0.85, 0.9])
    def test_threshold_sweep(self, threshold):
        # fsk-simplesync.node.test.ts:84-102 — if anything decodes it
        # must be correct; 0.9 legitimately fails to sync (the j==0
        # quirk caps the reachable ratio; the golden comparator agrees)
        core = FSKCore(SYNC300.replace(sync_threshold=threshold))
        data = b"\x48"
        out = core.demodulate_data(core.modulate_data(data))
        if out:
            assert out[0:1] == data
        if threshold <= 0.85:
            assert out == data  # reference default region must decode

    def test_preamble_like_data_bytes(self):
        # data full of 0x55 must not confuse sync (:105-125)
        core = FSKCore(SYNC300)
        data = bytes([0x55, 0x55, 0x48])
        assert core.demodulate_data(core.modulate_data(data)) == data
        assert core.get_status()["sync_detections"] == 1

    def test_structure_300baud(self):
        # 160 samples/bit at 300 baud / 48 kHz (:153-173)
        core = FSKCore(SYNC300)
        assert core.params.samples_per_bit == 160
        assert core.params.ds_samples_per_bit == 80
        assert core.params.quarter_bit == 20

    def test_impossible_threshold_never_syncs(self):
        # max achievable ratio is (n-1)/n due to the reference's j==0
        # out-of-bounds block (fsk.ts:306-307); a threshold of 0.99 is
        # unreachable
        core = FSKCore(SYNC300.replace(sync_threshold=0.99))
        out = core.demodulate_data(core.modulate_data(b"\x42"))
        assert out == b""
        assert core.get_status()["sync_detections"] == 0


class TestReconfiguration:
    def test_reset_then_reconfigure(self):
        # fsk-demodulation.node.test.ts:280-297
        core = FSKCore(DEFAULT_FSK_CONFIG)
        data = b"\x48"
        core.demodulate_data(core.modulate_data(data))
        core.reset()
        core.configure(DEFAULT_FSK_CONFIG)
        assert core.demodulate_data(core.modulate_data(data)) == data

    def test_reconfigure_changes_rate(self):
        core = FSKCore(DEFAULT_FSK_CONFIG)
        sig1200 = core.modulate_data(b"\x42")
        core.configure(FSKConfig(baud_rate=300))
        sig300 = core.modulate_data(b"\x42")
        assert len(sig300) == 4 * len(sig1200)  # 4x slower baud
        assert core.demodulate_data(sig300) == b"\x42"

    def test_unconfigured_raises(self):
        core = FSKCore()
        with pytest.raises(RuntimeError):
            core.modulate_data(b"\x00")
        with pytest.raises(RuntimeError):
            core.demodulate_data(np.zeros(128, np.float32))

    def test_get_config_returns_config(self):
        core = FSKCore(DEFAULT_FSK_CONFIG)
        assert core.get_config() == DEFAULT_FSK_CONFIG

    def test_configure_from_reference_style_dict(self):
        core = FSKCore()
        core.configure({"sampleRate": 48000, "baudRate": 1200,
                        "markFrequency": 1650, "spaceFrequency": 1850})
        assert core.is_ready()
        data = b"\x31"
        assert core.demodulate_data(core.modulate_data(data)) == data
