"""The stage-A Triton kernel (ops/pallas/fsk_seq.py), run in the Pallas
interpreter on the CPU, against the lax.scan path it replaces; its
wrapper's padding, gate and route rules; and its lowering for CUDA at
the farm's widths, which the CPU can do with no card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
from webaudio_modem.ops import fsk_demod, pallas
from webaudio_modem.ops.pallas import fsk_seq


def _carry(state):
    fr = (state.agc_gain, state.pre, state.phi, state.iq_i, state.iq_q)
    return fr, (state.last_phase, state.post)


def _compare(params, x, block=fsk_seq.BLOCK):
    """Kernel (interpreted) vs lax scan over the aligned body of x."""
    B, T = x.shape
    Tm = (T // params.downsample_ratio) * params.downsample_ratio
    state = fsk_demod.init_state(params, B)
    (fr_ref, dsc_ref, _, _, bits_ref, amps_ref,
     softs_ref) = fsk_demod._sequential_stage(
        params, 0, state, jnp.asarray(x[:, :Tm]))
    fr, dsc = _carry(state)
    fr_p, dsc_p, bits_p, amps_p, softs_p = fsk_seq.seq_main(
        params, fr, dsc, jnp.asarray(x[:, :Tm]).T, block=block,
        interpret=True)
    assert bits_p.shape == bits_ref.shape and bits_p.dtype == jnp.bfloat16
    # On random-noise input the filtered phase diff sits arbitrarily
    # close to the slicer threshold, so a vanishing fraction of bit
    # decisions may flip between float evaluation orders; real FSK
    # signals have wide margins (covered by the decode tests).
    mism = np.mean(np.asarray(bits_p) != np.asarray(bits_ref))
    assert mism <= 1e-4, f"bit mismatch fraction {mism}"
    np.testing.assert_allclose(np.asarray(amps_p), np.asarray(amps_ref),
                               rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(np.asarray(softs_p), np.asarray(softs_ref),
                               rtol=1e-4, atol=5e-5)
    for a, b in zip(jax.tree.leaves((fr_p, dsc_p)),
                    jax.tree.leaves((fr_ref, dsc_ref))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("T", [256, 1000, 2048])
def test_pallas_matches_scan(T):
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    x = np.random.RandomState(0).uniform(-1, 1, (64, T)).astype(np.float32)
    _compare(params, x)


@pytest.mark.parametrize("B", [1, 33, 70])
def test_channel_padding(B):
    # B not a multiple of the block: the wrapper pads and slices back
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    x = np.random.RandomState(B).uniform(-1, 1, (B, 200)).astype(
        np.float32)
    _compare(params, x)


@pytest.mark.parametrize("block", [16, 32, 64])
def test_block_widths(block):
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    x = np.random.RandomState(block).uniform(-1, 1, (64, 300)).astype(
        np.float32)
    _compare(params, x, block=block)


def test_pallas_streaming_state_carry():
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    B = 64
    x = np.random.RandomState(1).uniform(-1, 1, (B, 512)).astype(
        np.float32)
    fr, dsc = _carry(fsk_demod.init_state(params, B))
    fr_w, dsc_w, bits_w, _, _ = fsk_seq.seq_main(
        params, fr, dsc, jnp.asarray(x).T, interpret=True)
    fr_c, dsc_c, b1, _, _ = fsk_seq.seq_main(
        params, fr, dsc, jnp.asarray(x[:, :256]).T, interpret=True)
    fr_c, dsc_c, b2, _, _ = fsk_seq.seq_main(
        params, fr_c, dsc_c, jnp.asarray(x[:, 256:]).T, interpret=True)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(b1), np.asarray(b2)], 0),
        np.asarray(bits_w))
    for a, b in zip(jax.tree.leaves((fr_c, dsc_c)),
                    jax.tree.leaves((fr_w, dsc_w))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("backend,want", [("gpu", True), ("cpu", False)])
def test_available_follows_backend(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert fsk_seq.available() is want


def test_default_device_overrides_backend(monkeypatch):
    # the quality calibration pins the CPU inside a GPU process: the
    # kernels must step aside for that trace
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert pallas.target_platform() == "cpu"
        assert not fsk_seq.available()
    assert fsk_seq.available()


def test_raises_off_gpu_without_interpret():
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    fr, dsc = _carry(fsk_demod.init_state(params, 4))
    with pytest.raises(RuntimeError, match="compiles only for the GPU"):
        fsk_seq.seq_main(params, fr, dsc, jnp.zeros((16, 4)))


def test_lowers_for_cuda_at_farm_width():
    # B=4096 channels, one 4800-sample chunk at 300 baud: the Triton
    # lowering checks every load/store shape (powers of two) here
    from webaudio_modem.models.config import FSKConfig

    params = FSKParams.from_config(FSKConfig(
        baud_rate=300, mark_frequency=1270, space_frequency=1070))
    fn = jax.jit(lambda s, x: fsk_seq._seq_call(
        params, fsk_seq.BLOCK, fsk_seq.AHEAD, False, s, x))
    low = fn.trace(jax.ShapeDtypeStruct((fsk_seq.N_STATE, 4096),
                                        jnp.float32),
                   jax.ShapeDtypeStruct((4800, 4096), jnp.float32)
                   ).lower(lowering_platforms=("cuda",))
    assert "fsk_seq" in low.as_text()


def test_sliding_bit_sums_match_numpy():
    # R(i) over (carried tail ++ new bits), the input of stage C
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    ds = params.ds_samples_per_bit
    rng = np.random.RandomState(7)
    tail = rng.randint(0, 2, (params.sync_window, 16))
    bits = rng.randint(0, 2, (300, 16))
    got = fsk_demod.sliding_bit_sums(
        params, jnp.asarray(tail, jnp.bfloat16),
        jnp.asarray(bits, jnp.bfloat16))
    ext = np.concatenate([tail[-ds:], bits], 0)
    want = np.stack([ext[i + 1:i + 1 + ds].sum(0) for i in range(300)])
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)


@pytest.mark.gpu
def test_kernel_matches_scan_on_gpu(gpu_only):
    # the compiled kernel on the card, at the farm width
    from webaudio_modem.models.config import FSKConfig

    params = FSKParams.from_config(FSKConfig(
        baud_rate=300, mark_frequency=1270, space_frequency=1070))
    B = 4096
    x = np.random.RandomState(3).uniform(-1, 1, (B, 4800)).astype(
        np.float32)
    state = fsk_demod.init_state(params, B)
    fr, dsc = _carry(state)
    _, _, bits_p, amps_p, _ = fsk_seq.seq_main(params, fr, dsc,
                                               jnp.asarray(x).T)
    prev = fsk_demod.FORCE_LAX_SEQ
    fsk_demod.FORCE_LAX_SEQ = True
    try:
        ref = jax.jit(lambda s, v: fsk_demod._sequential_stage(
            params, 0, s, v))(state, jnp.asarray(x))
    finally:
        fsk_demod.FORCE_LAX_SEQ = prev
    assert np.mean(np.asarray(bits_p) != np.asarray(ref[4])) <= 1e-4
    np.testing.assert_allclose(np.asarray(amps_p), np.asarray(ref[5]),
                               rtol=1e-4, atol=5e-5)
