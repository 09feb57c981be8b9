"""Driver-contract tests: __graft_entry__ dryrun hermeticity.

The round-1 driver dryrun failed because eager work dispatched to the
default backend when that backend was unusable.  These tests pin the
contract: everything the dryrun touches lives on CPU devices, the
numpy synth is dispatch-free, and the mesh path works for both model
families.
"""

import sys

import numpy as np
import pytest

import jax

sys.path.insert(0, "/root/repo")

import __graft_entry__ as graft  # noqa: E402


def test_dryrun_multichip_8_devices(capsys):
    graft.dryrun_multichip(8)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK" in out
    # VERDICT r2 #5: the dryrun artifact itself must exercise the psk
    # family, the grouped-dispatch scan and a checkpoint mesh restore
    assert "psk step" in out
    assert "grouped scan x2" in out
    assert "checkpoint restore->step" in out


def test_dryrun_multichip_2_devices(capsys):
    graft.dryrun_multichip(2)
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_dryrun_rejects_too_many_devices():
    with pytest.raises(RuntimeError, match="CPU devices"):
        graft.dryrun_multichip(len(jax.devices("cpu")) + 1)


def test_numpy_modulate_matches_device_modulate():
    """The dispatch-free synth must produce the same signal the real
    modulator does (same phase tables, same layout)."""
    from webaudio_modem.models.config import FSKConfig, FSKParams
    from webaudio_modem.ops import fsk_mod

    params = FSKParams.from_config(FSKConfig())
    ref = np.asarray(fsk_mod.modulate(params, b"dryrun!"))
    got = graft._numpy_modulate(params, b"dryrun!")
    assert got.shape == ref.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_numpy_modulate_psk_matches_device_modulate():
    """The dispatch-free DBPSK synth must match ops/psk.modulate."""
    from webaudio_modem.ops import psk

    params = psk.psk_params()
    ref = np.asarray(psk.modulate(params, b"dryrun!"))
    got = graft._numpy_modulate_psk(params, b"dryrun!")
    assert got.shape == ref.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    state, out = jax.jit(fn)(*args)
    jax.block_until_ready((state, out))
    assert out.bytes_out.shape[0] == 64
