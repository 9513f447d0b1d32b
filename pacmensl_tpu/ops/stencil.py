"""Stencil primitives for the dense-box backend.

The dense-box formulation stores the probability vector as a dense N-d array
over the state bounding box, so the CME shift ``x -> x + s_r`` becomes a
zero-filled array shift — a static pad+slice that XLA lowers to pure
data-movement (and, across a sharded axis, to neighbor collective-permutes).
This replaces the reference's gather-based sparse matvec
(``src/Matrix/FspMatrixBase.cpp:36-62``) with a stencil that XLA fuses
with the propensity arithmetic.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def shift_nd(a: jnp.ndarray, shifts: Sequence[int]) -> jnp.ndarray:
    """Shift ``a`` by ``shifts`` with zero fill: out[i] = a[i - s] (where
    defined, else 0).  ``shifts`` must be static Python ints."""
    shifts = tuple(int(s) for s in shifts)
    if all(s == 0 for s in shifts):
        return a
    zero = jnp.zeros((), dtype=a.dtype)
    pad_cfg = [(max(s, 0), max(-s, 0), 0) for s in shifts]
    padded = lax.pad(a, zero, pad_cfg)
    starts = [max(-s, 0) for s in shifts]
    limits = [st + n for st, n in zip(starts, a.shape)]
    return lax.slice(padded, starts, limits)


def coord_grid(shape: Tuple[int, ...]) -> jnp.ndarray:
    """Flattened coordinate list of a box: [prod(shape), ndim] int32.

    Built from broadcasted iotas so XLA fuses it into elementwise consumers
    (no materialized HBM traffic when used inside jit).
    """
    n = int(np.prod(shape))
    cols = [lax.broadcasted_iota(jnp.int32, shape, d).reshape(n)
            for d in range(len(shape))]
    return jnp.stack(cols, axis=1)


def box_shape_from_bounds(box_bounds) -> Tuple[int, ...]:
    """Array shape for per-species coordinate maxima (inclusive)."""
    return tuple(int(b) + 1 for b in np.asarray(box_bounds).reshape(-1))
