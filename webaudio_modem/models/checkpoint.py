"""Checkpoint / resume for streaming demodulator state — any family.

SURVEY.md §5: the reference's only durable-state analog is the
carry-over streaming state (NCO phase, filter histories, sync windows,
framing registers — fsk.ts:102-131) held in a mutable object.  Here
that state is an explicit state pytree (``DemodState`` for FSK,
``PSKDemodState`` for DBPSK), so checkpointing is a serialization of
the pytree: a farm (or single modem) can be snapshot mid-stream,
restarted in a new process, resharded onto a different mesh, and
continue producing bit-identical output.

The snapshot records a model-family tag plus the full config
dataclass; restore dispatches through the same family registry the
farm uses (models/farm._resolve_family), so every family the farm can
run, it can also checkpoint and resume.

Plain ``.npz`` is used (self-contained, no service deps); the pytrees
also work directly with orbax if an async checkpointer is wanted.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Tuple

import numpy as np

import jax

from webaudio_modem.models.config import FSKConfig


def _family_of(config) -> str:
    from webaudio_modem.models.psk import PSKConfig

    return "psk" if isinstance(config, PSKConfig) else "fsk"


def _config_from_meta(family: str, d: dict):
    if family == "psk":
        from webaudio_modem.models.psk import PSKConfig

        d = dict(d)
        for k in ("preamble_pattern", "sfd_pattern"):
            if k in d:
                d[k] = tuple(d[k])
        return PSKConfig(**d)
    if family != "fsk":
        raise ValueError(f"unknown checkpoint family: {family!r}")
    return FSKConfig.from_dict(d)


def state_to_arrays(state) -> dict:
    leaves, treedef = jax.tree.flatten(state)
    return {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}


def save_state(path_or_file, state, config, ds_phase: int = 0) -> None:
    """Snapshot (state pytree, config, ds_phase) for any model family."""
    arrays = state_to_arrays(state)
    # npz cannot represent bfloat16 (saved as void, unreadable) — store
    # such leaves as uint16 bit patterns and record which to view back
    bf16_leaves = []
    for k, a in list(arrays.items()):
        if a.dtype == np.dtype(jax.numpy.bfloat16):
            arrays[k] = a.view(np.uint16)
            bf16_leaves.append(k)
    meta = {
        "family": _family_of(config),
        "config": dataclasses.asdict(config),
        "ds_phase": ds_phase,
        "n_leaves": len(arrays),
        "bf16_leaves": bf16_leaves,
    }
    np.savez(path_or_file, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_state(path_or_file, mesh=None) -> Tuple[object, object, int]:
    """Returns (state, config, ds_phase); optionally placed on a mesh.

    The state template (shapes, dtypes, pytree structure) is rebuilt
    from the family's own init_state, so a snapshot whose config or
    batch no longer matches its arrays is rejected loudly.
    """
    from webaudio_modem.models.farm import _resolve_family

    with np.load(path_or_file) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        config = _config_from_meta(meta.get("family", "fsk"),
                                   meta["config"])
        ops, params = _resolve_family(config)
        batch = int(data["leaf_0"].shape[0])  # agc_gain [B], both families
        template = ops.init_state(params, batch)
        leaves, treedef = jax.tree.flatten(template)
        bf16 = set(meta.get("bf16_leaves", ()))
        restored = [
            data[f"leaf_{i}"].view(np.dtype(jax.numpy.bfloat16))
            if f"leaf_{i}" in bf16 else data[f"leaf_{i}"]
            for i in range(meta["n_leaves"])]
        if meta["n_leaves"] == len(leaves) - 1:
            # migration (both families): snapshots predating the carried
            # sliding block-sum plane (r_tail) — DERIVE it from the
            # saved bit_tail: r_tail[k] = R(ds + k) = Σ bit_tail[k+1 ..
            # k+ds] (exact integer counts), restoring bit-identical
            # streams.
            flat_paths = jax.tree_util.tree_flatten_with_path(
                template)[0]
            names = ["/".join(str(getattr(k, "name", k))
                              for k in path)
                     for path, _ in flat_paths]
            r_idx = names.index("r_tail")
            b_idx = names.index("bit_tail")
            ds = params.ds_samples_per_bit
            bt = np.asarray(restored[b_idx if b_idx < r_idx
                                     else b_idx - 1], np.float32)
            cs = np.cumsum(bt, axis=0)
            r_tail = (cs[ds:] - cs[:-ds]).astype(
                np.dtype(jax.numpy.bfloat16))
            restored = restored[:r_idx] + [r_tail] + restored[r_idx:]
        if len(restored) != len(leaves):
            raise ValueError(
                f"checkpoint leaf-count mismatch: {meta['n_leaves']} vs "
                f"{len(leaves)} — family/state layout changed?")
        for ref, got in zip(leaves, restored):
            if ref.shape != got.shape:
                raise ValueError(
                    f"checkpoint shape mismatch: {got.shape} vs "
                    f"{ref.shape} — config/batch changed?")
        # Cast each leaf to the template's dtype: a snapshot taken
        # before a dtype migration (e.g. the f32 -> bf16 bit planes)
        # must not carry a mixed-dtype state forever — that silently
        # retraces the jitted step and doubles the plane's memory.
        # Bit planes hold only 0/1 so the cast is exact.
        state = jax.tree.unflatten(
            treedef, [np.asarray(x).astype(ref.dtype)
                      for ref, x in zip(leaves, restored)])
    if mesh is not None:
        from webaudio_modem.parallel.sharding import shard_state

        state = shard_state(state, mesh)
    else:
        state = jax.tree.map(jax.numpy.asarray, state)
    return state, config, int(meta["ds_phase"])


def dumps_state(state, config, ds_phase: int = 0) -> bytes:
    buf = io.BytesIO()
    save_state(buf, state, config, ds_phase)
    return buf.getvalue()


def loads_state(blob: bytes, mesh=None):
    return load_state(io.BytesIO(blob), mesh=mesh)
