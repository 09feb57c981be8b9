"""The measurement entry points' device and cache helpers
(utils/platform.py), the kernels' shared helpers (ops/pallas), and the
parts of chip_smoke.py a CPU can reach."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from webaudio_modem.ops import pallas
from webaudio_modem.utils import platform

REPO = Path(__file__).resolve().parents[2]


def test_cache_dir_from_environment(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert platform.init_compile_cache() == "/some/where"
    assert calls == []              # JAX reads the variable itself


def test_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = platform.init_compile_cache()
    assert calls == [("jax_compilation_cache_dir", path)]
    assert Path(path).parent == REPO
    ignored = (REPO / ".gitignore").read_text().split()
    assert Path(path).name + "/" in ignored


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        platform.require_gpu()


def test_device_record_names_the_device(monkeypatch):
    monkeypatch.setattr(platform, "card_name_and_power", lambda: "card")
    rec = platform.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices()), "card": "card"}


def test_card_name_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert platform.card_name_and_power() == "not available"


def test_check_route():
    pallas.check_route(interpret=True)
    with pytest.raises(RuntimeError, match="platform 'cpu'"):
        pallas.check_route(interpret=False)


@pytest.mark.parametrize("B,block", [(1, 32), (32, 32), (33, 32),
                                     (100, 64)])
def test_pad_channels(B, block):
    a = jnp.arange(3 * B, dtype=jnp.float32).reshape(3, B) + 1
    p = np.asarray(pallas.pad_channels(a, block))
    assert p.shape == (3, -(-B // block) * block)
    np.testing.assert_array_equal(p[:, :B], np.asarray(a))
    assert (p[:, B:] == 0).all()


def test_prefetch_loop_visits_rows_in_order():
    # the queue hands step t exactly load(t), for any depth, also when
    # the depth exceeds the loop length
    rows = jnp.arange(10, dtype=jnp.int32) * 3
    for ahead in (1, 4, 16):
        seen = pallas.prefetch_loop(
            10, lambda t: rows[t],
            lambda t, acc, r: acc + r * (t + 1), jnp.int32(0), ahead)
        assert int(seen) == int(jnp.sum(rows * jnp.arange(1, 11)))


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_helpers():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    msgs = chip_smoke.payloads(4096)
    assert len(set(msgs)) == 4096           # distinct per channel
    sig, _ = chip_smoke.farm_signal(4)
    assert sig.shape[1] % chip_smoke.CHUNK == 0
    assert not np.any(sig[:, -chip_smoke.CHUNK:])   # a silent tail
    # the stage-A check tolerates a flipped bit only at a slicer tie
    zeros = np.zeros((3, 2), np.float32)
    ref = ((zeros,), (zeros,), zeros, zeros, np.full((3, 2), 1.0,
                                                     np.float32))
    got = ((zeros,), (zeros,), zeros + np.eye(3, 2, dtype=np.float32),
           zeros, ref[4])
    with pytest.raises(AssertionError, match="bits differ"):
        chip_smoke._check_stage_a(got, ref, "t")
    tie = ref[:4] + (np.zeros((3, 2), np.float32),)
    assert chip_smoke._check_stage_a(got[:4] + (tie[4],), tie, "t") == 2
