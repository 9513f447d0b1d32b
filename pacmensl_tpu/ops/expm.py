"""Dense matrix exponential for small (Hessenberg) matrices, matmul-only.

``jax.scipy.linalg.expm`` lowers to an LU decomposition (Pade solve) that
not every backend implements in f64; the Krylov integrator needs f64 exps of
its small Hessenberg matrices (the reference computes these with
Armadillo's ``expmat`` on the host, ``src/OdeSolver/KrylovFsp.cpp:159``).
This module implements scaling-and-squaring with a Taylor series —
matmul-only, so it runs in any dtype on any backend:

    s  = max(0, ceil(log2(||A||_inf)) + 1)     (traced)
    E  = sum_{k<=K} (A/2^s)^k / k!             (K=18; ||A/2^s|| <= 0.5)
    E  = E^(2^s)                                (squaring loop)

With the scaled norm below 0.5 the order-18 Taylor remainder is below
0.5^19/19! ~ 1.6e-23 — beyond f64 round-off.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_TAYLOR_ORDER = 18
_MAX_SQUARINGS = 64


def expm(A: jnp.ndarray) -> jnp.ndarray:
    """exp(A) for a small square matrix (jnp-traceable, any float dtype)."""
    dtype = A.dtype
    n = A.shape[0]
    norm = jnp.max(jnp.sum(jnp.abs(A), axis=1))
    # number of halvings so the scaled norm is <= 0.5
    s = jnp.maximum(0, (jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-300))) + 1)
                    ).astype(jnp.int32)
    s = jnp.where(norm <= 0.5, 0, jnp.minimum(s, _MAX_SQUARINGS))
    As = A / (2.0 ** s.astype(dtype))

    eye = jnp.eye(n, dtype=dtype)

    def taylor_body(k, acc_term):
        acc, term = acc_term
        # term_{k} = term_{k-1} @ As / k
        term = (term @ As) / k
        return acc + term, term

    acc, _ = lax.fori_loop(1, _TAYLOR_ORDER + 1, taylor_body, (eye, eye))

    def sq_body(_, E):
        return E @ E

    return lax.fori_loop(0, s, sq_body, acc)
