"""WAV I/O: round-trips, format coverage, and modem-over-wav E2E
(the reference's real-audio-endpoint analog, demo/demo.js:403-425)."""

import numpy as np

from webaudio_modem.utils.audio_io import read_wav, write_wav


class TestWavRoundTrip:
    def test_float32_lossless(self, tmp_path):
        rng = np.random.RandomState(0)
        x = (rng.uniform(-1, 1, 4801)).astype(np.float32)
        p = tmp_path / "f.wav"
        write_wav(p, x, 48000, fmt="float32")
        y, rate = read_wav(p)
        assert rate == 48000
        np.testing.assert_array_equal(y, x)

    def test_pcm16_quantization(self, tmp_path):
        x = np.linspace(-1, 1, 1000).astype(np.float32)
        p = tmp_path / "p.wav"
        write_wav(p, x, 44100, fmt="pcm16")
        y, rate = read_wav(p)
        assert rate == 44100
        assert np.abs(y - x).max() < 1.0 / 16000

    def test_stdlib_wave_reads_our_pcm16(self, tmp_path):
        # playability check: a standard reader accepts the PCM file
        import wave

        p = tmp_path / "std.wav"
        write_wav(p, np.zeros(100, np.float32), 48000, fmt="pcm16")
        with wave.open(str(p), "rb") as w:
            assert w.getnchannels() == 1
            assert w.getsampwidth() == 2
            assert w.getframerate() == 48000
            assert w.getnframes() == 100

    def test_reads_stdlib_written_stereo(self, tmp_path):
        import wave

        p = tmp_path / "st.wav"
        pcm = np.zeros((50, 2), dtype="<i2")
        pcm[:, 0] = 1000
        pcm[:, 1] = 3000
        with wave.open(str(p), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(pcm.tobytes())
        y, rate = read_wav(p)
        assert rate == 8000
        assert len(y) == 50
        np.testing.assert_allclose(y, 2000.0 / 32768.0, atol=1e-6)


class TestModemOverWav:
    def test_modulate_wav_demodulate(self, tmp_path):
        # full loop through a 16-bit PCM file: the quantization of a
        # real sound-card path must not cost a single byte
        from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
        from webaudio_modem.models.fsk import FSKCore

        data = b"WAV loop \x00\xff\x7e\x55"
        core = FSKCore(DEFAULT_FSK_CONFIG)
        sig = np.asarray(core.modulate_data(data))
        p = tmp_path / "m.wav"
        write_wav(p, sig, DEFAULT_FSK_CONFIG.sample_rate, fmt="pcm16")
        samples, rate = read_wav(p)
        assert rate == DEFAULT_FSK_CONFIG.sample_rate
        core.configure(DEFAULT_FSK_CONFIG)
        assert core.demodulate_data(samples) == data


class TestRiffEdgeCases:
    def test_odd_data_chunk_before_fmt(self, tmp_path):
        # data chunk first, odd byte length: the word-alignment pad
        # after it must be skipped or the fmt parse reads garbage
        import struct

        samples = bytes([128, 200, 55])            # 3 x 8-bit PCM
        data_chunk = b"data" + struct.pack("<I", 3) + samples + b"\x00"
        fmt_chunk = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 8000,
                                          8000, 1, 8)
        body = data_chunk + fmt_chunk
        blob = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body
        p = tmp_path / "odd.wav"
        p.write_bytes(blob)
        x, rate = read_wav(p)
        assert rate == 8000
        assert len(x) == 3
        np.testing.assert_allclose(x[0], 0.0, atol=1e-6)
