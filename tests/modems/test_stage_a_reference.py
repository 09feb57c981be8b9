"""The lax sequential stage (stage A) of both families against a float64
numpy reference written from the receiver's definition: AGC, band-pass
pre-filter, quadrature NCO mix, I/Q low-pass biquads, downsample average,
then the FSK discriminator (atan2 phase difference, post low-pass,
polarity slicer) or the DBPSK one-bit-delay product."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
from webaudio_modem.ops import fsk_demod, fsk_mod, psk


def _biquad(c, x, st):
    b0, b1, b2, a1, a2 = c
    x1, x2, y1, y2 = st
    y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
    return y, (x, x1, y, y1)


def _reference(params, x, family):
    """float64 [B, T] -> bits, amps, softs [T // ratio, B]."""
    B, T = x.shape
    ratio = params.downsample_ratio
    w = 2 * np.pi * params.center_freq / params.sample_rate
    z = lambda: np.zeros(B)  # noqa: E731
    g, nc, ns = np.ones(B), np.ones(B), z()
    pre, iqi, iqq, post = [(z(), z(), z(), z()) for _ in range(4)]
    last = z()
    D = params.ds_samples_per_bit
    ring_i, ring_q, idx = np.zeros((D, B)), np.zeros((D, B)), 0
    out = []
    for grp in range(T // ratio):
        ai = aq = 0.0
        for t in range(grp * ratio, (grp + 1) * ratio):
            y = x[:, t]
            if params.config.agc_enabled:
                y = x[:, t] * g
                lvl = np.abs(y)
                rate = np.where(lvl > params.agc_target, params.agc_attack,
                                params.agc_release)
                tgt = params.agc_target / np.maximum(lvl, 1e-30)
                g = np.where(lvl > 0, np.clip(g + (tgt - g) * rate,
                                              0.1, 10.0), g)
            f, pre = _biquad(params.pre_filter, y, pre)
            i, iqi = _biquad(params.iq_filter, f * nc, iqi)
            q, iqq = _biquad(params.iq_filter, f * ns, iqq)
            nc, ns = nc * np.cos(w) - ns * np.sin(w), \
                ns * np.cos(w) + nc * np.sin(w)
            k = 1.5 - 0.5 * (nc * nc + ns * ns)
            nc, ns = nc * k, ns * k
            ai, aq = ai + i, aq + q
        ai, aq = ai / ratio, aq / ratio
        amp = np.sqrt(ai * ai + aq * aq)
        if family == "fsk":
            cur = np.arctan2(aq, ai)
            d = cur - last
            d = np.where(d > np.pi, d - 2 * np.pi,
                         np.where(d < -np.pi, d + 2 * np.pi, d))
            last = cur
            soft, post = _biquad(params.post_filter, d, post)
            bit = (params.polarity * soft > 0).astype(np.float64)
        else:
            di, dq = ring_i[idx], ring_q[idx]
            re, im = ai * di + aq * dq, aq * di - ai * dq
            ang = np.arctan2(im, re)
            soft = np.where(re > 0, ang, ang - np.sign(ang) * np.pi)
            bit = (re > 0).astype(np.float64)
            ring_i[idx], ring_q[idx] = ai, aq
            idx = (idx + 1) % D
        out.append((bit, amp, soft))
    return [np.stack(v) for v in zip(*out)]


def _signal(params, family, B, T, seed):
    mod = psk.modulate if family == "psk" else fsk_mod.modulate
    sig = np.asarray(mod(params, b"Ok!"))
    sig = np.pad(sig, (0, max(T - len(sig), 0)))[:T]
    rng = np.random.RandomState(seed)
    shifts = rng.randint(0, len(sig) // 4, B)
    x = np.stack([np.roll(sig, s) for s in shifts])
    return (x + 0.02 * rng.randn(B, T)).astype(np.float32)


def _params(family):
    return psk.psk_params() if family == "psk" else \
        FSKParams.from_config(DEFAULT_FSK_CONFIG)


@pytest.mark.parametrize("family", ["fsk", "psk"])
@pytest.mark.parametrize("T", [256, 1000, 2048])
def test_stage_a_matches_float64_reference(family, T):
    params = _params(family)
    x = _signal(params, family, 16, T, seed=T)
    ops = psk if family == "psk" else fsk_demod
    out = ops._sequential_stage(params, 0, ops.init_state(params, 16),
                                jnp.asarray(x))
    bits, amps, softs = (np.asarray(a, np.float64) for a in out[4:7])
    r_bits, r_amps, r_softs = _reference(params, x.astype(np.float64),
                                         family)
    n = (T // params.downsample_ratio)
    assert bits.shape == (n, 16)
    # bits agree wherever the reference decision is not a near-tie
    clear = np.abs(r_softs) > 1e-3
    np.testing.assert_array_equal(bits[clear], r_bits[clear])
    np.testing.assert_allclose(amps, r_amps, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(softs, r_softs, rtol=1e-3, atol=2e-3)


def test_psk_streaming_state_carry():
    # two chunks with the carried state give the one-call stream
    params = _params("psk")
    x = jnp.asarray(_signal(params, "psk", 8, 1024, seed=3))
    st = psk.init_state(params, 8)
    whole = psk._sequential_stage(params, 0, st, x)
    a = psk._sequential_stage(params, 0, st, x[:, :512])
    st2 = st._replace(agc_gain=a[0][0], pre=a[0][1], phi=a[0][2],
                      iq_i=a[0][3], iq_q=a[0][4], zbuf_i=a[1][0],
                      zbuf_q=a[1][1], zidx=a[1][2])
    b = psk._sequential_stage(params, 0, st2, x[:, 512:])
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(a[4]), np.asarray(b[4])], 0),
        np.asarray(whole[4]))
    for u, v in zip(jax.tree.leaves(b[:2]), jax.tree.leaves(whole[:2])):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)


def test_psk_rsum_is_sliding_bit_sum():
    params = _params("psk")
    ds = params.ds_samples_per_bit
    x = jnp.asarray(_signal(params, "psk", 8, 800, seed=5))
    st = psk.init_state(params, 8)._replace(bit_tail=jnp.asarray(
        np.random.RandomState(5).randint(0, 2, (params.sync_window, 8)),
        jnp.bfloat16))
    out = psk._sequential_stage(params, 0, st, x, with_rsum=True)
    ext = np.concatenate([np.asarray(st.bit_tail[-ds:], np.float32),
                          np.asarray(out[4], np.float32)], 0)
    want = np.stack([ext[i + 1:i + 1 + ds].sum(0)
                     for i in range(out[4].shape[0])])
    np.testing.assert_array_equal(np.asarray(out[7], np.float32), want)
