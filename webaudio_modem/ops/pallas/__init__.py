"""Pallas kernels for the GPU, written for the Triton route.

Each kernel gives every channel one thread and runs the time loop
inside the kernel, so the per-step state lives in registers; the grid
runs over channel blocks.  A kernel's lax form in ops/ stays the
reference it is tested against, and the path every other backend takes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def target_platform() -> str:
    """Platform the current trace compiles for: the device set with
    ``jax.default_device`` when there is one, else the default backend."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev if isinstance(dev, str) else dev.platform
    return jax.default_backend()


def on_gpu() -> bool:
    return target_platform() == "gpu"


def check_route(interpret: bool) -> None:
    """A kernel compiles only for the GPU; anywhere else it runs only
    when the caller asks for the interpreter."""
    if not interpret and not on_gpu():
        raise RuntimeError(
            f"Triton kernel called on platform {target_platform()!r}: "
            "it compiles only for the GPU (pass interpret=True to run "
            "it in the Pallas interpreter)")


def prefetch_loop(n: int, load, step, carry, ahead: int):
    """``fori_loop`` over t < n calling ``carry = step(t, carry, rows)``
    with ``rows = load(t)`` issued ``ahead`` steps early: the loads in
    flight ride the loop carry as a queue, so a step's memory latency
    hides behind the ``ahead`` steps before it."""
    def body(t, state):
        carry, queue = state
        nxt = load(jnp.minimum(t + ahead, n - 1))
        return step(t, carry, queue[0]), queue[1:] + (nxt,)

    queue = tuple(load(min(k, n - 1)) for k in range(ahead))
    carry, _ = jax.lax.fori_loop(0, n, body, (carry, queue))
    return carry


def pad_channels(a, block: int):
    """Zero-pad the last (channel) axis up to a multiple of ``block``."""
    extra = -a.shape[-1] % block
    if not extra:
        return a
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, extra)])
