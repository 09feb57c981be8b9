"""Property-based FEC invariants (hypothesis), mirroring the wire
fuzz suite's approach for the algorithm layer: the fixed-vector tests
pin known points; these assert the families' CONTRACTS over random
codes, data, and corruption patterns.

Invariants:
  * RS corrects ANY <= t-symbol corruption exactly, for random
    shortened (n, k) geometries — and re-syndromed `ok` is set.
  * LDPC/turbo decode exactly at generous LLR confidence regardless of
    data content; LDPC's syndrome `ok` agrees.
  * The interleaver is a pure permutation (roundtrip identity) for
    any (rows, depth).
"""

import numpy as np
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from webaudio_modem.ops import rs

# modest example counts: every fresh RS geometry is a new XLA:CPU
# compile, and a single pytest process must stay well under the
# compile-count crash ceiling (CLAUDE.md "Suite stability")
_SETTINGS = dict(max_examples=20, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow])


@st.composite
def rs_geometry(draw):
    parity = draw(st.integers(2, 16).map(lambda v: 2 * v))  # 4..32
    k = draw(st.integers(1, 64))
    return k + parity, k


class TestReedSolomonProperties:
    @settings(**_SETTINGS)
    @given(nk=rs_geometry(), seed=st.integers(0, 2**31 - 1))
    def test_corrects_any_up_to_t_errors(self, nk, seed):
        n, k = nk
        t = (n - k) // 2
        rng = np.random.RandomState(seed)
        data = rng.randint(0, 256, size=(2, k))
        cw = np.asarray(rs.rs_encode_batch(data, n, k))
        bad = cw.copy()
        for b in range(2):
            n_err = rng.randint(0, t + 1)
            pos = rng.choice(n, size=n_err, replace=False)
            bad[b, pos] ^= rng.randint(1, 256, size=n_err)
        fixed, ok, n_corr = rs.rs_decode_batch(bad, n, k)
        assert np.asarray(ok).all()
        np.testing.assert_array_equal(np.asarray(fixed), cw)

    @settings(**_SETTINGS)
    @given(rows=st.integers(1, 40), depth=st.integers(1, 12),
           seed=st.integers(0, 2**31 - 1))
    def test_interleaver_roundtrip(self, rows, depth, seed):
        rng = np.random.RandomState(seed)
        block = rng.randint(0, 256, size=(3, rows * depth))
        out = rs.block_deinterleave(
            rs.block_interleave(block, depth), depth)
        np.testing.assert_array_equal(np.asarray(out), block)


class TestBlockCodeProperties:
    @settings(max_examples=10, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(0, 2**31 - 1))
    def test_ldpc_confident_llrs_roundtrip(self, seed):
        from webaudio_modem.ops.ldpc import default_code

        code = default_code(n=120, wc=3, wr=6)
        rng = np.random.RandomState(seed)
        data = rng.randint(0, 2, size=(4, code.k))
        cw = np.asarray(code.encode_batch(data))
        llr = ((1.0 - 2.0 * cw) * 12.0).astype(np.float32)
        out, ok = code.decode_batch(llr)
        assert np.asarray(ok).all()
        np.testing.assert_array_equal(np.asarray(out), data)

    @settings(max_examples=10, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(0, 2**31 - 1))
    def test_turbo_confident_llrs_roundtrip(self, seed):
        from webaudio_modem.ops.turbo import default_code

        code = default_code(K=128)
        rng = np.random.RandomState(seed)
        data = rng.randint(0, 2, size=(4, code.K))
        cw = code.encode_batch(data)
        llr = ((1.0 - 2.0 * cw) * 12.0).astype(np.float32)
        out = np.asarray(code.decode_batch(llr))
        np.testing.assert_array_equal(out, data)
