"""GF(256) arithmetic for the Reed-Solomon codec, batched.

The reference's FEC design memo names block codes as a representative
FEC family, with RS(255,223) as its worked example
(/root/reference/advanced-error-correction.md:157-160: ブロック符号
Reed-Solomon/BCH/Hamming; 例: RS(255,223)).  This module provides the
field arithmetic as batched device code: multiplication/division/inverse are
log/antilog TABLE GATHERS over int32 planes (no bit-serial loops), so
every RS stage vectorizes over a [B, ...] batch exactly like the demod
kernels.

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1
(0x11D) and generator alpha = 2 — the conventional RS(255,223)
construction.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

PRIM_POLY = 0x11D
ORDER = 255            # multiplicative group order


@functools.lru_cache(maxsize=1)
def tables() -> Tuple[np.ndarray, np.ndarray]:
    """(exp, log) tables.

    exp[i] = alpha^i for i in [0, 510) (doubled so products of two
    logs index without a mod); log[a] = i with exp[i] = a, log[0] = 0
    (callers mask zeros explicitly).
    """
    exp = np.zeros(2 * ORDER, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[ORDER:] = exp[:ORDER]
    return exp, log


def np_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise GF(256) product (numpy, host)."""
    exp, log = tables()
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    out = exp[log[a] + log[b]]
    return np.where((a == 0) | (b == 0), 0, out)


def np_inv(a: np.ndarray) -> np.ndarray:
    """Elementwise GF(256) inverse; inv(0) = 0 (callers mask)."""
    exp, log = tables()
    a = np.asarray(a, np.int32)
    return np.where(a == 0, 0, exp[ORDER - log[a]])


def _jnp_tables():
    # NOT cached as jax arrays: the first call may happen inside a jit
    # trace, where jnp.asarray returns a tracer — caching that leaks it
    # into later traces.  The numpy tables are lru-cached; embedding
    # them as constants per trace is free (XLA dedupes).
    exp, log = tables()
    return jnp.asarray(exp), jnp.asarray(log)


def mul(a, b):
    """Elementwise GF(256) product (jax; int32 planes of byte values).

    Log-domain gather: exp[log a + log b] with explicit zero masking —
    three gathers + one select, no data-dependent control flow.
    """
    exp, log = _jnp_tables()
    a = a.astype(jnp.int32)
    b = b.astype(jnp.int32)
    out = exp[log[a] + log[b]]
    return jnp.where((a == 0) | (b == 0), 0, out)


def inv(a):
    """Elementwise GF(256) inverse (jax); inv(0) = 0."""
    exp, log = _jnp_tables()
    a = a.astype(jnp.int32)
    return jnp.where(a == 0, 0, exp[ORDER - log[a]])


def np_poly_mul(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Polynomial product over GF(256) (host; coefficients high-first,
    matching the wire's byte order)."""
    p = np.asarray(p, np.int32)
    q = np.asarray(q, np.int32)
    out = np.zeros(len(p) + len(q) - 1, np.int32)
    for i, c in enumerate(p):
        out[i:i + len(q)] ^= np_mul(c, q)
    return out
