"""FSP solution vectors and pytree vector-space operations.

The FSP solution is the pair (probability over states, sink masses).  The
reference appends the sinks to the tail of the distributed PETSc Vec and
special-cases the last MPI rank as their owner
(``src/Matrix/FspMatrixConstrained.cpp:137``).  Under a device mesh that
breaks the uniform shard layout, so the sinks are instead a small **replicated** leaf of
a pytree vector — every vector-space operation (dot, axpy, norm) treats the
pair uniformly, and integrators are written against these ops so they work
for any backend's probability layout (N-d box array or flat ELL vector).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class FspVector(NamedTuple):
    """(probability array, sink masses).  A jax pytree."""
    p: jnp.ndarray       # box-shaped [b0,...,bS-1] or flat [n_pad]
    sinks: jnp.ndarray   # [n_constraints], replicated


def vdot(a, b):
    """Global inner product over all leaves."""
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    return sum(jnp.vdot(x, y) for x, y in zip(leaves_a, leaves_b))


def norm2(a):
    return jnp.sqrt(vdot(a, a).real)


def axpy(alpha, x, y):
    """y + alpha*x (functional)."""
    return jax.tree_util.tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def scale(alpha, x):
    return jax.tree_util.tree_map(lambda xi: alpha * xi, x)


def add(x, y):
    return jax.tree_util.tree_map(jnp.add, x, y)


def sub(x, y):
    return jax.tree_util.tree_map(jnp.subtract, x, y)


def zeros_like(x):
    return jax.tree_util.tree_map(jnp.zeros_like, x)


def where(pred, x, y):
    return jax.tree_util.tree_map(
        lambda xi, yi: jnp.where(pred, xi, yi), x, y)


def total_mass(x: FspVector):
    return jnp.sum(x.p) + jnp.sum(x.sinks)


def isfinite(x) -> jnp.ndarray:
    leaves = jax.tree_util.tree_leaves(x)
    ok = jnp.bool_(True)
    for leaf in leaves:
        ok = ok & jnp.all(jnp.isfinite(leaf))
    return ok


# ------------------------------------------------------- stacked bases ----

def stack_zeros(template, m: int):
    """Allocate a Krylov basis buffer: each leaf gains leading dim m."""
    return jax.tree_util.tree_map(
        lambda leaf: jnp.zeros((m,) + leaf.shape, leaf.dtype), template)


def basis_set(basis, i, vec):
    """basis[i] = vec (functional)."""
    return jax.tree_util.tree_map(
        lambda b, v: b.at[i].set(v), basis, vec)


def basis_get(basis, i):
    return jax.tree_util.tree_map(lambda b: b[i], basis)


def basis_lincomb(coeffs, basis):
    """sum_i coeffs[i] * basis[i] over the full (padded) leading dim.

    Pad unused coefficients with zero; one contraction instead of m
    axpys (the VecMAXPY of the reference, KrylovFsp.cpp:244-252).
    """
    return jax.tree_util.tree_map(
        lambda b: jnp.tensordot(coeffs.astype(b.dtype), b, axes=1), basis)
