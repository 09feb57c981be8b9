"""Sharded channel-farm tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax

from webaudio_modem.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem.models.farm import ModemFarm
from webaudio_modem.parallel.sharding import (channel_sharding,
                                                  make_mesh, shard_state)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def test_mesh_shape(mesh):
    assert mesh.shape == {"channels": 8}


def test_sharded_farm_matches_unsharded(mesh):
    B = 16
    msgs = [bytes([i]) * 2 for i in range(B)]
    farm_plain = ModemFarm(DEFAULT_FSK_CONFIG, B, donate=False)
    farm_shard = ModemFarm(DEFAULT_FSK_CONFIG, B, mesh=mesh, donate=False)

    sig = np.asarray(farm_plain.modulate(msgs))
    out_plain = farm_plain.demodulate(sig)
    out_shard = farm_shard.demodulate(sig)
    assert out_plain == out_shard == msgs


def test_sharded_state_placement(mesh):
    from webaudio_modem.models.config import FSKParams
    from webaudio_modem.ops import fsk_demod

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    state = fsk_demod.init_state(params, batch=16)
    sharded = shard_state(state, mesh)
    assert sharded.agc_gain.sharding == channel_sharding(mesh)
    # time-major windows shard on axis 1: 16 channels / 8 devices = 2
    shard0 = sharded.bit_tail.addressable_shards[0].data
    assert shard0.shape == (params.sync_window, 2)


def test_streaming_chunks_sharded(mesh):
    B = 8
    msgs = [b"x"] * B
    farm = ModemFarm(DEFAULT_FSK_CONFIG, B, mesh=mesh, donate=False)
    sig = np.asarray(farm.modulate(msgs))
    out = farm.demodulate(sig, chunk_size=1024)
    assert out == msgs


def test_demodulate_stream_sharded(mesh):
    """The grouped-dispatch throughput path (jitted scan + donated
    state) must preserve the mesh sharding across groups and decode
    identically to the per-chunk loop."""
    B = 16
    msgs = [bytes([65 + i]) for i in range(B)]
    farm = ModemFarm(DEFAULT_FSK_CONFIG, B, mesh=mesh)
    sig = np.asarray(farm.modulate(msgs))
    sig = np.concatenate([sig, np.zeros((B, 333), np.float32)], axis=1)
    out = farm.demodulate_stream(sig, chunk_size=512, group=4)
    assert out == msgs
    assert farm.state.agc_gain.sharding == channel_sharding(mesh)


def test_psk_farm_on_mesh(mesh):
    """0-d state leaves (PSK delay-line index) must replicate, not
    crash device_put (round-1 advisor finding)."""
    from webaudio_modem.models.psk import PSKConfig

    B = 16
    farm = ModemFarm(PSKConfig(), B, mesh=mesh, donate=False)
    assert farm.state.zidx.ndim == 0
    msgs = [bytes([65 + i]) * 2 for i in range(B)]
    sig = np.asarray(farm.modulate(msgs))
    assert farm.demodulate(sig) == msgs


def test_shard_state_replicates_0d_leaves(mesh):
    from webaudio_modem.models.psk import PSKConfig
    from webaudio_modem.ops import psk as psk_ops

    cfg = PSKConfig()
    params = psk_ops.psk_params(
        carrier_frequency=cfg.carrier_frequency, baud_rate=cfg.baud_rate,
        sample_rate=cfg.sample_rate)
    state = psk_ops.init_state(params, batch=16)
    sharded = shard_state(state, mesh)
    assert sharded.zidx.sharding.is_fully_replicated
    assert sharded.zbuf_i.addressable_shards[0].data.shape[1] == 2


def test_blind_soft_receiver_on_mesh(mesh):
    """Sharded == unsharded for the blind batched soft receiver: the
    detector / header / body programs are pure per-channel math, so
    running them with the receiver state sharded over the channel mesh
    must decode the identical payloads (zero timing hints either way)."""
    from webaudio_modem.models.config import FSKParams
    from webaudio_modem.ops import soft_fsk
    from webaudio_modem.ops.soft_blind import BlindSoftBatchReceiver

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    rng = np.random.RandomState(5)
    B, quantum = 16, 4800
    payloads = [bytes(rng.randint(0, 256, 5, dtype=np.uint8))
                for _ in range(B)]
    sigs = {pl: np.asarray(soft_fsk.encode_frame_signal(params, pl),
                           np.float32) for pl in payloads}
    offs = rng.randint(1000, 8000, size=B)
    end = int(max(offs[b] + len(sigs[payloads[b]]) for b in range(B)))
    T = ((end + quantum - 1) // quantum + 1) * quantum
    stream = np.zeros((B, T), np.float32)
    for b in range(B):
        stream[b, offs[b]:offs[b] + len(sigs[payloads[b]])] = \
            sigs[payloads[b]]

    def run(rx):
        got = [[] for _ in range(B)]
        for off in range(0, T, quantum):
            for ch, pl in rx.feed(stream[:, off:off + quantum]):
                got[ch].append(pl)
        for ch, pl in rx.flush():
            got[ch].append(pl)
        return got

    rx_mesh = BlindSoftBatchReceiver(params, B, quantum, max_payload=8,
                                     mesh=mesh)
    assert rx_mesh._rx.ev_best.sharding == channel_sharding(mesh)
    assert rx_mesh._rx.key.sharding.is_fully_replicated
    got_mesh = run(rx_mesh)
    rx_plain = BlindSoftBatchReceiver(params, B, quantum, max_payload=8)
    got_plain = run(rx_plain)
    assert got_mesh == got_plain == [[pl] for pl in payloads]
    assert rx_mesh.frames_decoded == B
    # the donated detector state must STILL be channel-sharded after
    # the run — a jitted step silently resharding the carry to
    # replicated would decode fine but lose the mesh (advisor r4)
    assert rx_mesh._rx.ev_best.sharding == channel_sharding(mesh)
    assert rx_mesh._rx.key.sharding.is_fully_replicated


def test_graft_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
