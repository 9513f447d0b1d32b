"""Double-float ("df64") arithmetic: ~49-bit-mantissa reals as unevaluated
sums of two float32s, built from error-free transformations (Knuth two-sum,
Dekker split / two-prod).  This module provides, from float32 storage,
the precision the reference gets from CPU doubles (CVODE/PETSc run f64 throughout,
``src/OdeSolver/CvodeFsp.cpp:137-200``) for the accumulations where f32
demonstrably walls out (the stationary Jacobi-GMRES diverges on the
repressilator in f32).

Representation: a pair ``(hi, lo)`` of same-shaped f32 arrays with
``|lo| <= ulp(hi)/2``; value = hi + lo.  All ops are elementwise
jnp-traceable (no FMA assumption: Dekker splitting).

Accuracy: add/mul are accurate to O(eps_f32^2) ~ 1e-14 relative — between
f32 (6e-8) and f64 (1e-16), enough for 1e-12 GMRES targets at moderate n.

References: Dekker (1971), Knuth TAOCP v2, Hida-Li-Bailey QD library
(public algorithms; implementation original).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_SPLIT = np.float32(4097.0)          # 2^12 + 1 for f32 Dekker splitting


def two_sum(a, b):
    """Error-free: a + b = s + e exactly (Knuth, 6 flops, no branch)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e, REQUIRES |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi, lo having 11-bit mantissas."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free: a * b = p + e exactly (Dekker, no FMA)."""
    p = a * b
    a1, a2 = split(a)
    b1, b2 = split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


# ---------------------------------------------------------------- pairs --

def dd(hi, lo=None):
    hi = jnp.asarray(hi, jnp.float32)
    return (hi, jnp.zeros_like(hi) if lo is None
            else jnp.asarray(lo, jnp.float32))


def from_f64(x):
    """Split a host float64 array into an (hi, lo) f32 pair exactly
    representing it to df64 precision."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def to_f64(x):
    """Host float64 value(s) of a df64 pair."""
    hi, lo = x
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def add(x, y):
    """df64 + df64 (accurate version: two two-sums + renormalize)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    t, f = two_sum(xl, yl)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return quick_two_sum(s, e)


def add_f(x, a):
    """df64 + f32."""
    xh, xl = x
    s, e = two_sum(xh, a)
    e = e + xl
    return quick_two_sum(s, e)


def neg(x):
    return (-x[0], -x[1])


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    """df64 * df64."""
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def mul_f(x, a):
    """df64 * f32."""
    xh, xl = x
    p, e = two_prod(xh, a)
    e = e + xl * a
    return quick_two_sum(p, e)


def div(x, y):
    """df64 / df64 by one Newton step on the f32 quotient."""
    xh, xl = x
    q1 = xh / y[0]
    r = sub(x, mul_f(y, q1))
    q2 = (r[0] + r[1]) / (y[0] + y[1])
    return quick_two_sum(q1, q2)


def recip(y):
    return div(dd(jnp.ones_like(y[0])), y)


def sqrt(x):
    """df64 sqrt via one Newton step on the f32 root."""
    s1 = jnp.sqrt(x[0])
    safe = jnp.where(s1 > 0, s1, jnp.float32(1.0))
    r = sub(x, mul((safe, jnp.zeros_like(safe)),
                   (safe, jnp.zeros_like(safe))))
    s2 = (r[0] + r[1]) / (2.0 * safe)
    h, l = quick_two_sum(safe, s2)
    zero = x[0] <= 0
    return (jnp.where(zero, 0.0, h), jnp.where(zero, 0.0, l))


def where(c, x, y):
    return (jnp.where(c, x[0], y[0]), jnp.where(c, x[1], y[1]))


def asum(x):
    """Sum all elements of a df64 array pair to a df64 SCALAR with
    compensated accumulation: per-element errors never exceed df64
    rounding because each partial add is error-free.

    Strategy: reduce along rows/axes with pairwise jnp sums of hi and lo
    WOULD lose the compensation, so instead accumulate the (hi, lo)
    streams with a two-sum cascade over a small number of chunks: f32
    pairwise sums inside a chunk are exact enough only for ~2^11
    same-magnitude terms, so chunk partials are computed in df64.
    Implementation: flatten, pad to [k, 2048], tree-reduce the k chunk
    axis in df64 (log2 k two-sum levels), then a final within-chunk
    df64 cascade via lax.scan-free unrolled halving."""
    xh = x[0].reshape(-1)
    xl = x[1].reshape(-1)
    n = xh.shape[0]
    m = 1
    while m < n:
        m *= 2
    pad = m - n
    if pad:
        xh = jnp.concatenate([xh, jnp.zeros((pad,), xh.dtype)])
        xl = jnp.concatenate([xl, jnp.zeros((pad,), xl.dtype)])
    cur = (xh, xl)
    while cur[0].shape[0] > 1:
        k = cur[0].shape[0] // 2
        a = (cur[0][:k], cur[1][:k])
        b = (cur[0][k:], cur[1][k:])
        cur = add(a, b)
    return (cur[0][0], cur[1][0])


def dot(x, y):
    """df64 dot product of two df64 array pairs -> df64 scalar."""
    return asum(mul(x, y))


def norm2(x):
    return sqrt(dot(x, x))


def scale(a, x):
    """df64-scalar * df64-array (a broadcast pair of scalars)."""
    return mul((jnp.broadcast_to(a[0], x[0].shape),
                jnp.broadcast_to(a[1], x[1].shape)), x)


def axpy(a, x, y):
    """y + a*x with df64 scalar a and df64 arrays x, y."""
    return add(y, scale(a, x))
