"""CRC-16 tests (reference tests/utils/crc16.node.test.ts)."""

import time

from webaudio_modem.utils import CRC16


class TestStandardVectors:
    # reference crc16.node.test.ts:12-61
    def test_empty(self):
        assert CRC16.calculate(b"") == 0xFFFF

    def test_single_a(self):
        assert CRC16.calculate(b"A") == 0xB915

    def test_123456789(self):
        assert CRC16.calculate(b"123456789") == 0x29B1

    def test_zero_byte(self):
        assert CRC16.calculate(bytes([0x00])) == 0xE1F0

    def test_ff_byte(self):
        assert CRC16.calculate(bytes([0xFF])) == 0xFF00

    def test_hello_world_consistency(self):
        data = b"Hello, World!"
        assert CRC16.calculate(data) == CRC16.calculate(data)

    def test_different_data_different_crc(self):
        assert CRC16.calculate(b"abc") != CRC16.calculate(b"abd")


class TestVerify:
    def test_verify_good(self):
        data = b"test data"
        assert CRC16.verify(data, CRC16.calculate(data))

    def test_verify_bad(self):
        assert not CRC16.verify(b"test data", 0x1234)

    def test_verify_corrupted(self):
        data = bytearray(b"test data")
        crc = CRC16.calculate(bytes(data))
        data[0] ^= 0x01
        assert not CRC16.verify(bytes(data), crc)


class TestPerformance:
    def test_1kb_under_10ms(self):
        # reference crc16.node.test.ts:102-118
        data = bytes(range(256)) * 4
        assert len(data) == 1024
        start = time.perf_counter()
        CRC16.calculate(data)
        elapsed_ms = (time.perf_counter() - start) * 1000
        assert elapsed_ms < 10

    def test_properties(self):
        # reference crc16.node.test.ts:121-135
        assert CRC16.POLYNOMIAL == 0x1021
        assert CRC16.INITIAL_VALUE == 0xFFFF
        assert CRC16.FINAL_XOR == 0x0000
        # single-bit difference changes the CRC
        assert CRC16.calculate(bytes([0x00])) != CRC16.calculate(bytes([0x01]))


class TestBatchRows:
    def test_rows_match_scalar(self):
        import numpy as np

        rng = np.random.RandomState(3)
        rows = rng.randint(0, 256, (37, 19), dtype=np.uint8)
        got = CRC16.calculate_rows(rows)
        assert got.dtype == np.uint16
        for r, g in zip(rows, got):
            assert int(g) == CRC16.calculate(bytes(r))

    def test_reference_vectors_and_empty(self):
        import numpy as np

        rows = np.frombuffer(b"123456789", np.uint8)[None, :]
        assert int(CRC16.calculate_rows(rows)[0]) == 0x29B1
        empty = np.zeros((3, 0), np.uint8)
        assert (CRC16.calculate_rows(empty) == 0xFFFF).all()

    def test_rejects_non_matrix(self):
        import numpy as np
        import pytest

        with pytest.raises(ValueError):
            CRC16.calculate_rows(np.zeros(4, np.uint8))
