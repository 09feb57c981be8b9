"""The stage-D Triton kernel (ops/pallas/fsk_framing.py), run in the
Pallas interpreter, against the lax scan and masked-sum compaction on
realistic demod intermediate streams; its wrapper's padding, gate and
route rules; and its lowering for CUDA at the farm's widths."""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
from webaudio_modem.ops import fsk_demod, fsk_mod
from webaudio_modem.ops.pallas import fsk_framing


def _intermediates(params, B, T):
    """Run the real front half of the pipeline on an FSK signal so the
    stage-D inputs are realistic (sync events actually fire)."""
    sig = np.asarray(fsk_mod.modulate(params, b"Hi"))[:T]
    if len(sig) < T:
        sig = np.pad(sig, (0, T - len(sig)))
    x = jnp.asarray(np.tile(sig, (B, 1)))
    state = fsk_demod.init_state(params, B)
    _, _, _, _, bits, amps, _ = fsk_demod._sequential_stage(
        params, 0, state, x)
    ext_bits = jnp.concatenate([state.bit_tail, bits], 0)
    ext_amps = jnp.concatenate([state.amp_tail, amps], 0)
    ratios = fsk_demod._sync_ratios(params, ext_bits)
    return state, bits, amps, ratios, ext_amps


def _lax_compact(params, state, bits, amps, ratios, ext_amps, maxb):
    # on the CPU framing_stage takes the lax scan + masked sums
    assert not fsk_framing.available(maxb)
    return fsk_demod.framing_stage(params, state, bits, amps, ratios,
                                   ext_amps, maxb)


def _kernel_compact(params, state, bits, amps, ratios, ext_amps, maxb,
                    **kw):
    carry, (byts, count, eod, sync, fire_t) = fsk_framing.stage_d_compact(
        params, state, bits, amps, ratios, ext_amps, maxb, interpret=True,
        **kw)
    return carry, byts.astype(jnp.uint8), count, eod, sync, fire_t


def _assert_same(got, ref):
    names = ["carry", "bytes", "count", "eod", "sync", "fire_t"]
    for name, a, b in zip(names, got, ref):
        for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                          err_msg=name)


@pytest.mark.parametrize("T", [2048, 4096])
def test_framing_kernel_matches_scan(T):
    # a batch that is not a block multiple: padded channels must not
    # leak into the real ones
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    state, bits, amps, ratios, ext_amps = _intermediates(params, 40, T)
    maxb = fsk_demod.max_bytes(params, bits.shape[0])
    ref = _lax_compact(params, state, bits, amps, ratios, ext_amps, maxb)
    got = _kernel_compact(params, state, bits, amps, ratios, ext_amps,
                          maxb)
    _assert_same(got, ref)
    assert int(np.asarray(ref[4]).sum()) > 0       # syncs really fired


def test_framing_kernel_streaming_carry():
    # two halves with the carry restored as demod_chunk does must give
    # the whole stream's byte sequence and counters
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    state, bits, amps, ratios, ext_amps = _intermediates(params, 32, 4096)
    n = bits.shape[0]
    half = n // 2
    A = params.amp_window
    maxb = fsk_demod.max_bytes(params, n)
    whole = _kernel_compact(params, state, bits, amps, ratios, ext_amps,
                            maxb)
    c1 = _kernel_compact(params, state, bits[:half], amps[:half],
                         ratios[:half], ext_amps, maxb)
    carry1 = c1[0]
    state2 = state._replace(
        started=carry1[0] > 0, counter=carry1[1], sil=carry1[2],
        threshold=carry1[3], accum=carry1[4], count=carry1[5],
        bsc=carry1[6], next_idx=carry1[7], byte_cur=carry1[8],
        pos=carry1[9], amp_tail=ext_amps[half:half + A],
        amp_fill=state.amp_fill + half,
        bit_fill=state.bit_fill + half)
    c2 = _kernel_compact(params, state2, bits[half:], amps[half:],
                         ratios[half:], ext_amps[half:], maxb)
    for k in (2, 3, 4):                             # counters add up
        np.testing.assert_array_equal(
            np.asarray(c1[k]) + np.asarray(c2[k]), np.asarray(whole[k]))
    for b in range(bits.shape[1]):
        joined = (bytes(np.asarray(c1[1])[b, :int(c1[2][b])])
                  + bytes(np.asarray(c2[1])[b, :int(c2[2][b])]))
        assert joined == bytes(np.asarray(whole[1])[b, :int(whole[2][b])])


@pytest.mark.parametrize("T", [2048, 4096])
def test_compact_kernel_matches_lax_compaction(T):
    """stage_d_compact (in-kernel byte compaction + event counters)
    must reproduce the lax path's compacted outputs exactly."""
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    state, bits, amps, ratios, ext_amps = _intermediates(params, 64, T)
    maxb = fsk_demod.max_bytes(params, bits.shape[0])
    ref = _lax_compact(params, state, bits, amps, ratios, ext_amps, maxb)
    got = _kernel_compact(params, state, bits, amps, ratios, ext_amps,
                          maxb)
    _assert_same(got, ref)


def _np_pairwise(x):
    n = x.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    x = np.concatenate([x, np.zeros((size - n,) + x.shape[1:], x.dtype)])
    while len(x) > 1:
        x = x[:len(x) // 2] + x[len(x) // 2:]
    return x[0]


@pytest.mark.parametrize("n", [1, 5, 640, 1000])
def test_window_sum_is_a_fixed_order_tree(n):
    # both stage-D routes start the rolling amplitude sum from this sum:
    # its order is the program's, bit for bit the float32 pairwise tree
    # (so no compiler can reorder it apart), within ceil(log2 n) ulps of
    # the float64 sum of the positive amplitudes
    x = np.abs(np.random.RandomState(n).randn(n, 48)).astype(np.float32)
    got = np.asarray(jax.jit(fsk_demod._pairwise_sum)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, _np_pairwise(x))
    want = x.astype(np.float64).sum(0)
    levels = max(1, int(np.ceil(np.log2(n))))
    assert (np.abs(got - want)
            <= levels * np.finfo(np.float32).eps * want).all()


@pytest.mark.parametrize("block,ahead", [(16, 1), (64, 8)])
def test_block_and_prefetch_depth(block, ahead):
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    state, bits, amps, ratios, ext_amps = _intermediates(params, 64, 2048)
    maxb = fsk_demod.max_bytes(params, bits.shape[0])
    ref = _lax_compact(params, state, bits, amps, ratios, ext_amps, maxb)
    got = _kernel_compact(params, state, bits, amps, ratios, ext_amps,
                          maxb, block=block, ahead=ahead)
    _assert_same(got, ref)


def test_compact_fallback_logs_once_and_counts(monkeypatch, caplog):
    """A GPU chunk too long for the byte-slot registers falls back to
    the lax scan: logged once per bound and counted."""
    from webaudio_modem.utils.trace import metrics

    monkeypatch.setattr(fsk_framing, "on_gpu", lambda: True)
    monkeypatch.setattr(fsk_framing, "_fallback_logged", set())
    metrics.reset()
    big = fsk_framing.MAX_SLOTS + 10
    with caplog.at_level(logging.WARNING,
                         logger="webaudio_modem.fsk_framing"):
        assert not fsk_framing.available(big)
        assert not fsk_framing.available(big)      # same bound
    assert len([r for r in caplog.records
                if "falling back" in r.message]) == 1
    assert metrics.snapshot()["counters"]["pallas.compact_fallback"] == 1
    assert fsk_framing.available(4) is True


def test_off_gpu_rules():
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    state, bits, amps, ratios, ext_amps = _intermediates(params, 4, 512)
    with pytest.raises(RuntimeError, match="compiles only for the GPU"):
        fsk_framing.stage_d_compact(params, state, bits, amps, ratios,
                                    ext_amps, 4)
    with pytest.raises(ValueError, match="MAX_SLOTS"):
        fsk_framing.stage_d_compact(params, state, bits, amps, ratios,
                                    ext_amps, fsk_framing.MAX_SLOTS + 1,
                                    interpret=True)
    assert not fsk_framing.available(4)


def test_lowers_for_cuda_at_farm_width():
    from webaudio_modem.models.config import FSKConfig

    params = FSKParams.from_config(FSKConfig(
        baud_rate=300, mark_frequency=1270, space_frequency=1070))
    B, n_ds = 4096, 2400
    maxb = fsk_demod.max_bytes(params, n_ds)
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)  # noqa: E731
    fn = jax.jit(lambda *a: fsk_framing._compact_call(
        params, maxb, fsk_framing.BLOCK, fsk_framing.AHEAD, False, *a))
    low = fn.trace(i32(fsk_framing.N_I32, B), f32(fsk_framing.N_F32, B),
                   jax.ShapeDtypeStruct((n_ds, B), jnp.bfloat16),
                   f32(n_ds, B), f32(n_ds, B),
                   f32(n_ds + params.amp_window, B), i32(B)
                   ).lower(lowering_platforms=("cuda",))
    assert "fsk_framing" in low.as_text()
