"""Dual-instance concurrency (reference
fsk-demodulation.node.test.ts:792-852): two independent cores
modulating/demodulating interleaved must not share state."""


from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKConfig
from webaudio_modem.models.fsk import FSKCore


def test_two_instances_interleaved():
    a = FSKCore(DEFAULT_FSK_CONFIG)
    b = FSKCore(DEFAULT_FSK_CONFIG)
    data_a, data_b = b"\xaa\x01", b"\x55\x02"
    sig_a = a.modulate_data(data_a)
    sig_b = b.modulate_data(data_b)

    # interleave chunked demodulation across the two instances
    out_a, out_b = b"", b""
    n = max(len(sig_a), len(sig_b))
    for i in range(0, n, 256):
        if i < len(sig_a):
            out_a += a.demodulate_data(sig_a[i:i + 256])
        if i < len(sig_b):
            out_b += b.demodulate_data(sig_b[i:i + 256])
    assert out_a == data_a
    assert out_b == data_b
    assert a.get_status()["sync_detections"] == 1
    assert b.get_status()["sync_detections"] == 1


def test_instances_with_different_configs():
    a = FSKCore(DEFAULT_FSK_CONFIG)
    b = FSKCore(FSKConfig(baud_rate=300))
    data = b"\x42"
    sig_a, sig_b = a.modulate_data(data), b.modulate_data(data)
    assert len(sig_b) == 4 * len(sig_a)
    assert a.demodulate_data(sig_a) == data
    assert b.demodulate_data(sig_b) == data


def test_cross_feeding_wrong_config_decodes_nothing():
    a = FSKCore(DEFAULT_FSK_CONFIG)  # 1650/1850 @ 1200 baud
    b = FSKCore(FSKConfig(mark_frequency=2125, space_frequency=2295))
    sig_b = b.modulate_data(b"\x42")
    # off-band for a's pre-filter and wrong baud alignment
    out = a.demodulate_data(sig_b)
    assert out in (b"", None) or len(out) <= 1
