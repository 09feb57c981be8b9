"""Checkpoint / resume tests (SURVEY.md §5: carried streaming state is
the checkpointable object)."""

import io

import numpy as np

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKConfig
from webaudio_modem.models import checkpoint
from webaudio_modem.models.farm import ModemFarm


def test_mid_stream_checkpoint_resume_bit_identical(tmp_path):
    B = 4
    msgs = [bytes([i]) * 3 for i in range(B)]
    farm = ModemFarm(DEFAULT_FSK_CONFIG, B, donate=False)
    sig = np.asarray(farm.modulate(msgs))
    T = sig.shape[1]
    cut = (T // 2) | 1  # odd cut: exercises ds_phase carry

    # continuous decode (oracle)
    oracle = ModemFarm(DEFAULT_FSK_CONFIG, B, donate=False)
    expected = oracle.demodulate(sig)

    # decode first half, checkpoint mid-stream, resume in a "new process"
    part1 = farm.demodulate(sig[:, :cut])
    path = tmp_path / "farm.npz"
    farm.save(path)
    del farm

    restored = ModemFarm.restore(path, donate=False)
    assert restored._ds_phase == cut % 2
    part2 = restored.demodulate(sig[:, cut:])
    combined = [a + b for a, b in zip(part1, part2)]
    assert combined == expected == msgs


def test_dumps_loads_roundtrip():
    from webaudio_modem.ops import fsk_demod
    from webaudio_modem.models.config import FSKParams

    config = FSKConfig(baud_rate=300)
    params = FSKParams.from_config(config)
    state = fsk_demod.init_state(params, batch=2)
    blob = checkpoint.dumps_state(state, config, ds_phase=1)
    state2, config2, ds_phase = checkpoint.loads_state(blob)
    assert config2 == config
    assert ds_phase == 1
    import jax

    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(state2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shape_mismatch_rejected():
    from webaudio_modem.ops import fsk_demod
    from webaudio_modem.models.config import FSKParams

    config = FSKConfig(baud_rate=300)
    state = fsk_demod.init_state(FSKParams.from_config(config), batch=2)
    blob = checkpoint.dumps_state(state, config.replace(baud_rate=1200))
    # config says 1200 baud but windows were sized for 300 baud
    try:
        checkpoint.loads_state(blob)
        assert False, "expected shape mismatch"
    except ValueError as e:
        assert "mismatch" in str(e)


def test_psk_mid_stream_checkpoint_resume_bit_identical(tmp_path):
    """Checkpointing is family-generic: a PSK farm snapshots and
    resumes bit-identically (round-1 advisor finding: FSK-only
    serialization crashed on PSK)."""
    from webaudio_modem.models.psk import PSKConfig

    B = 4
    cfg = PSKConfig()
    msgs = [bytes([0x30 + i]) * 3 for i in range(B)]
    farm = ModemFarm(cfg, B, donate=False)
    sig = np.asarray(farm.modulate(msgs))
    T = sig.shape[1]
    cut = (T // 2) | 1  # odd cut: exercises ds_phase carry

    oracle = ModemFarm(cfg, B, donate=False)
    expected = oracle.demodulate(sig)

    part1 = farm.demodulate(sig[:, :cut])
    path = tmp_path / "psk_farm.npz"
    farm.save(path)
    del farm

    restored = ModemFarm.restore(path, donate=False)
    assert isinstance(restored.config, PSKConfig)
    assert restored._ds_phase == cut % 2
    part2 = restored.demodulate(sig[:, cut:])
    combined = [a + b for a, b in zip(part1, part2)]
    assert combined == expected == msgs


def test_psk_dumps_loads_roundtrip():
    from webaudio_modem.models.psk import PSKConfig
    from webaudio_modem.ops import psk as psk_ops

    cfg = PSKConfig(baud_rate=300)
    params = psk_ops.psk_params(carrier_frequency=cfg.carrier_frequency,
                                baud_rate=cfg.baud_rate,
                                sample_rate=cfg.sample_rate)
    state = psk_ops.init_state(params, batch=2)
    blob = checkpoint.dumps_state(state, cfg, ds_phase=1)
    state2, cfg2, ds_phase = checkpoint.loads_state(blob)
    assert cfg2 == cfg
    assert ds_phase == 1
    assert type(state2).__name__ == "PSKDemodState"
    import jax

    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(state2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_unknown_family_rejected():
    import json

    config = FSKConfig(baud_rate=300)
    from webaudio_modem.ops import fsk_demod
    from webaudio_modem.models.config import FSKParams

    state = fsk_demod.init_state(FSKParams.from_config(config), batch=1)
    blob = checkpoint.dumps_state(state, config)
    # tamper the family tag
    with np.load(io.BytesIO(blob)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        meta["family"] = "qam"
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    try:
        checkpoint.loads_state(buf.getvalue())
        assert False, "expected unknown-family error"
    except ValueError as e:
        assert "family" in str(e)


def test_restore_onto_mesh():
    import jax

    if len(jax.devices()) < 8:
        return
    from webaudio_modem.parallel.sharding import make_mesh

    mesh = make_mesh(8)
    B = 8
    farm = ModemFarm(DEFAULT_FSK_CONFIG, B, donate=False)
    msgs = [b"m"] * B
    sig = np.asarray(farm.modulate(msgs))
    farm.demodulate(sig[:, :1000])
    blob = io.BytesIO()
    farm.save(blob)
    blob.seek(0)
    restored = ModemFarm.restore(blob, mesh=mesh, donate=False)
    out = restored.demodulate(sig[:, 1000:])
    assert out == msgs


def test_dtype_migration_cast_on_load():
    """A snapshot saved before a dtype migration (e.g. the f32 -> bf16
    bit planes) must restore with the CURRENT template dtypes — a
    mixed-dtype state would silently retrace the jitted step and double
    the plane's memory (ADVICE r2)."""
    import jax
    import jax.numpy as jnp

    from webaudio_modem.models.config import FSKParams
    from webaudio_modem.ops import fsk_demod

    config = FSKConfig(baud_rate=1200)
    params = FSKParams.from_config(config)
    state = fsk_demod.init_state(params, batch=2)
    # simulate a pre-bf16 snapshot: bit_tail stored as float32
    old = state._replace(
        bit_tail=(state.bit_tail.astype(jnp.float32) + 0))
    blob = checkpoint.dumps_state(old, config)
    restored, _, _ = checkpoint.loads_state(blob)
    assert restored.bit_tail.dtype == state.bit_tail.dtype
    for ref, got in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert ref.dtype == got.dtype


def test_pre_r_tail_checkpoint_migrates(tmp_path):
    # snapshots taken before the carried sliding block-sum plane
    # (r_tail) must still load: the loader derives r_tail from the
    # saved bit_tail and the resumed stream stays bit-identical
    import io
    import json

    import jax
    import jax.numpy as jnp

    from webaudio_modem.models.config import DEFAULT_FSK_CONFIG, FSKParams
    from webaudio_modem.models import checkpoint as cp
    from webaudio_modem.ops import fsk_demod, fsk_mod

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    sig = np.asarray(fsk_mod.modulate(params, b"migrate me"))
    pad = np.zeros(((-len(sig)) % 480) + 480, np.float32)
    sig = np.concatenate([sig, pad])
    chunks = sig.reshape(-1, 480)
    state = fsk_demod.init_state(params, 2)
    mid = len(chunks) // 2
    pre = bytearray()
    for i in range(mid):
        state, o = fsk_demod.demod_chunk(params, 0, state,
                                         jnp.asarray(np.tile(
                                             chunks[i], (2, 1))))
        c = int(np.asarray(o.byte_count)[0])
        pre += bytes(np.asarray(o.bytes_out)[0, :c])

    blob = cp.dumps_state(state, DEFAULT_FSK_CONFIG, ds_phase=0)

    # rewrite the npz WITHOUT the r_tail leaf (the pre-migration
    # layout), renumbering the remaining leaves
    paths = jax.tree_util.tree_flatten_with_path(state)[0]
    names = ["/".join(str(getattr(k, "name", k)) for k in p)
             for p, _ in paths]
    r_idx = names.index("r_tail")
    with np.load(io.BytesIO(blob)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    old_bf16 = set(meta["bf16_leaves"])
    del leaves[r_idx]
    new_bf16 = []
    arrays = {}
    for i, a in enumerate(leaves):
        src = i if i < r_idx else i + 1
        if f"leaf_{src}" in old_bf16:
            new_bf16.append(f"leaf_{i}")
        arrays[f"leaf_{i}"] = a
    meta["n_leaves"] = len(leaves)
    meta["bf16_leaves"] = new_bf16
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)

    restored, config, phase = cp.loads_state(buf.getvalue())
    np.testing.assert_array_equal(
        np.asarray(restored.r_tail), np.asarray(state.r_tail))

    # resumed stream == uninterrupted stream, byte-identical
    def drain(st, start):
        out = bytearray()
        for i in range(start, len(chunks)):
            st, o = fsk_demod.demod_chunk(params, 0, st,
                                          jnp.asarray(np.tile(
                                              chunks[i], (2, 1))))
            c = int(np.asarray(o.byte_count)[0])
            out += bytes(np.asarray(o.bytes_out)[0, :c])
        return bytes(out)

    resumed = drain(restored, mid)
    assert resumed == drain(state, mid)
    assert b"migrate me" in bytes(pre) + resumed


def test_pre_r_tail_checkpoint_migrates_psk():
    # the r_tail migration is family-generic: PSK snapshots predating
    # the plane load with r_tail derived from the saved bit_tail
    import io
    import json

    import jax
    import jax.numpy as jnp

    from webaudio_modem.models.psk import PSKConfig
    from webaudio_modem.models import checkpoint as cp
    from webaudio_modem.ops import psk as psk_ops

    cfg = PSKConfig()
    params = psk_ops.psk_params(carrier_frequency=cfg.carrier_frequency,
                                baud_rate=cfg.baud_rate,
                                sample_rate=cfg.sample_rate)
    rng = np.random.RandomState(5)
    state = psk_ops.init_state(params, 3)._replace(
        bit_tail=jnp.asarray(
            rng.randint(0, 2, (params.sync_window, 3)), jnp.bfloat16))
    blob = cp.dumps_state(state, cfg, ds_phase=0)

    # rewrite the npz WITHOUT the r_tail leaf (pre-migration layout)
    paths = jax.tree_util.tree_flatten_with_path(state)[0]
    names = ["/".join(str(getattr(k, "name", k)) for k in p)
             for p, _ in paths]
    r_idx = names.index("r_tail")
    with np.load(io.BytesIO(blob)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    old_bf16 = set(meta["bf16_leaves"])
    del leaves[r_idx]
    arrays, new_bf16 = {}, []
    for i, a in enumerate(leaves):
        src = i if i < r_idx else i + 1
        if f"leaf_{src}" in old_bf16:
            new_bf16.append(f"leaf_{i}")
        arrays[f"leaf_{i}"] = a
    meta["n_leaves"] = len(leaves)
    meta["bf16_leaves"] = new_bf16
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)

    restored, cfg2, _ = cp.loads_state(buf.getvalue())
    assert type(restored).__name__ == "PSKDemodState"
    ds = params.ds_samples_per_bit
    bt = np.asarray(state.bit_tail, np.float32)
    cs = np.cumsum(bt, axis=0)
    expect = (cs[ds:] - cs[:-ds]).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(restored.r_tail, np.float32), expect)
