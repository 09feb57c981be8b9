"""Device-mesh sharding for the channel batch.

The reference's only parallelism axis is independent modem channels
(one FSKCore per AudioWorkletNode, demo/demo.js:233-237); here that
axis is the leading [B] batch dimension of every kernel, and multi-card
scale-out shards B across a 1-D ``jax.sharding.Mesh``.
Channels never communicate, so the sharding is embarrassingly parallel:
XLA inserts no collectives, and each chip runs the identical fused
demod pipeline on its B/n_devices slice — the layout the scaling
playbook calls pure data parallelism with zero cross-shard traffic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHANNEL_AXIS = "channels"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_name: str = CHANNEL_AXIS) -> Mesh:
    """1-D mesh over the channel axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"need {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (axis_name,))


def channel_sharding(mesh: Mesh,
                     axis_name: str = CHANNEL_AXIS) -> NamedSharding:
    """Shard the leading (channel) dimension; replicate the rest."""
    return NamedSharding(mesh, P(axis_name))


def check_mesh_batch(batch: int, mesh: Mesh, who: str,
                     axis_name: str = CHANNEL_AXIS) -> None:
    """Fail fast (clear ValueError) when ``batch`` does not divide the
    channel mesh axis: ``jax.device_put`` of a [B] leaf over
    ``P(channels)`` otherwise raises an opaque sharding error deep in
    construction."""
    n = mesh.shape.get(axis_name, 1) if hasattr(mesh, "shape") else 1
    if n and batch % n != 0:
        raise ValueError(
            f"{who}(batch={batch}, mesh={n} devices on "
            f"'{axis_name}'): the channel batch must divide the mesh "
            f"evenly — every [B] state leaf shards over P('{axis_name}')"
            f"; use a batch that is a multiple of {n}")


def state_spec(x, axis_name: str = CHANNEL_AXIS) -> P:
    """Channel position of a demod-state leaf, by rank: 1-D leaves are
    [B]; leaves of rank >= 2 (the time-major carried windows) are
    [..., B]; 0-d leaves (e.g. the PSK delay-line index, shared by
    every channel) are replicated."""
    if x.ndim == 0:
        return P()
    if x.ndim == 1:
        return P(axis_name)
    return P(*([None] * (x.ndim - 1)), axis_name)


def shard_state(state, mesh: Mesh, axis_name: str = CHANNEL_AXIS):
    """Place a demod-state pytree with the channel axis sharded over
    ``mesh`` (``state_spec``)."""
    return jax.tree.map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh, state_spec(x, axis_name))), state)


def per_shard_step(step, mesh: Mesh, out_specs,
                   axis_name: str = CHANNEL_AXIS):
    """Run a ``(state, samples [B, T]) -> (state, out)`` chunk step once
    per shard of the channel mesh (``jax.shard_map``): channels never
    interact, so each device runs the step on its own B/n slice, and a
    custom kernel inside the step sees only that slice.  ``out_specs``
    gives the non-state outputs' specs."""

    def run(state, samples):
        st = jax.tree.map(lambda x: state_spec(x, axis_name), state)
        return jax.shard_map(
            step, mesh=mesh, in_specs=(st, P(axis_name, None)),
            out_specs=(st, out_specs), check_vma=False)(state, samples)

    return run
