"""RingBuffer tests (reference tests/utils.test.ts)."""

import numpy as np
import pytest

from webaudio_modem.utils import RingBuffer


def test_basic_put_get():
    rb = RingBuffer(np.float32, 4)
    rb.put(1.0, 2.0, 3.0)
    assert len(rb) == 3
    assert rb.get(0) == 1.0
    assert rb.get(2) == 3.0


def test_negative_indexing():
    # reference utils.ts:28-36
    rb = RingBuffer(np.float32, 4)
    rb.put(1.0, 2.0, 3.0)
    assert rb.get(-1) == 3.0
    assert rb.get(-3) == 1.0


def test_index_out_of_bounds():
    rb = RingBuffer(np.float32, 4)
    rb.put(1.0)
    with pytest.raises(IndexError):
        rb.get(1)
    with pytest.raises(IndexError):
        rb.get(-2)


def test_overflow_overwrites_oldest():
    # reference utils.ts:38-48
    rb = RingBuffer(np.int32, 3)
    rb.put(1, 2, 3, 4, 5)
    assert len(rb) == 3
    assert rb.get(0) == 3
    assert rb.get(2) == 5


def test_remove_fifo():
    rb = RingBuffer(np.int32, 4)
    rb.put(10, 20, 30)
    assert rb.remove() == 10
    assert rb.remove() == 20
    assert len(rb) == 1


def test_remove_empty_raises():
    rb = RingBuffer(np.int32, 4)
    with pytest.raises(IndexError):
        rb.remove()


def test_read_zero_on_empty():
    # reference utils.ts:60-62
    rb = RingBuffer(np.float32, 4)
    assert rb.read() == 0.0


def test_read_array_zero_fill():
    # reference utils.ts:74-78
    rb = RingBuffer(np.float32, 8)
    rb.put(1.0, 2.0)
    out = np.full(4, -1.0, dtype=np.float32)
    rb.read_array(out)
    assert list(out) == [1.0, 2.0, 0.0, 0.0]


def test_write_array_bulk():
    rb = RingBuffer(np.float32, 8)
    rb.write_array(np.array([1, 2, 3], dtype=np.float32))
    assert len(rb) == 3
    assert rb.get(1) == 2.0


def test_available_and_has_space():
    rb = RingBuffer(np.float32, 4)
    assert rb.available_write() == 4
    rb.put(1.0)
    assert rb.available_read() == 1
    assert rb.available_write() == 3
    assert rb.has_space(2)
    assert not rb.has_space(3)


def test_clear():
    rb = RingBuffer(np.float32, 4)
    rb.put(1.0, 2.0)
    rb.clear()
    assert len(rb) == 0
    assert rb.read() == 0.0


def test_to_array():
    rb = RingBuffer(np.int32, 4)
    rb.put(7, 8, 9)
    assert list(rb.to_array()) == [7, 8, 9]


def test_fractional_size_truncates():
    # JS ToIndex truncation (sizes like maxSyncBits*ds*1.1 in fsk.ts:149)
    rb = RingBuffer(np.uint8, 10.9)
    assert rb.capacity == 10


def test_wraparound_ordering():
    rb = RingBuffer(np.int32, 3)
    rb.put(1, 2, 3)
    rb.remove()
    rb.put(4)
    assert list(rb.to_array()) == [2, 3, 4]


def test_bulk_write_wraparound_matches_scalar():
    import numpy as np

    from webaudio_modem.utils import RingBuffer

    a = RingBuffer(np.uint8, 16)
    b = RingBuffer(np.uint8, 16)
    rng = np.random.RandomState(0)
    for _ in range(20):
        chunk = rng.randint(0, 256, rng.randint(1, 9), dtype=np.uint8)
        a.write_array(chunk)
        for v in chunk:
            b.put(v)
        assert a.to_array().tolist() == b.to_array().tolist()
        if len(a) > 4:
            n = rng.randint(1, 4)
            got_a = a.remove_array(n)
            got_b = [int(b.remove()) for _ in range(n)]
            assert got_a.tolist() == got_b


def test_bulk_write_larger_than_capacity_keeps_newest():
    import numpy as np

    from webaudio_modem.utils import RingBuffer

    rb = RingBuffer(np.uint8, 8)
    rb.put(1, 2, 3)
    rb.write_array(np.arange(20, dtype=np.uint8))
    assert rb.to_array().tolist() == list(range(12, 20))


def test_bulk_read_zero_fills_underflow():
    import numpy as np

    from webaudio_modem.utils import RingBuffer

    rb = RingBuffer(np.float32, 8)
    rb.write_array(np.asarray([1.0, 2.0], np.float32))
    out = np.full(5, -1.0, np.float32)
    rb.read_array(out)
    assert out.tolist() == [1.0, 2.0, 0.0, 0.0, 0.0]
    assert len(rb) == 0
