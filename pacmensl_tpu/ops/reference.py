"""Plain reference for the truncated CME generator.

A scipy CSR matrix built by enumerating the FSP state list — structurally
the reference's stored-SELL operator (``FspMatrixBase::GenerateValues``,
``src/Matrix/FspMatrixBase.cpp:76-251``, with the sink rows of
``FspMatrixConstrained.cpp:121-282``).  It shares no code with the device
operators (:class:`~.box_operator.BoxOperator`,
:class:`~.ell_operator.EllOperator`): only the model's propensity and
coefficient functions, the constraint function, and numpy/scipy index
math.  Tests, ``bench.py`` and ``chip_smoke.py`` compare the device
operators with it, on the geometries built here (:func:`box_space_fixed`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from ..sys.environment import local_cpu_device


class CsrGenerator(NamedTuple):
    """``A`` [n, n]: column i holds the transitions out of state i;
    ``S`` [n_c, n]: the sink rows (a transition leaving the set feeds the
    sink of every constraint its target violates)."""
    A: sp.csr_matrix
    S: sp.csr_matrix

    @property
    def nnz(self) -> int:
        return int(self.A.nnz)

    def apply(self, p: np.ndarray):
        """(dp, dsinks) for a probability vector over the enumerated
        states, in float64."""
        p = np.asarray(p, np.float64)
        return self.A @ p, self.S @ p


def _keys(states: np.ndarray, radix: np.ndarray) -> np.ndarray:
    key = np.zeros(states.shape[0], np.int64)
    for d in range(states.shape[1]):
        key = key * radix[d] + states[:, d]
    return key


def generator_csr(model, states, constraint_fn: Optional[Callable],
                  bounds, t: float = 0.0) -> CsrGenerator:
    """Build the generator at time ``t`` over ``states`` [n, S] (any order;
    row/column i is ``states[i]``).  ``constraint_fn`` maps [n, S] states
    to [n, n_c] constraint values (None = the coordinates themselves) and
    ``bounds`` [n_c] are their right-hand sides.

    Semantics: for every state x and reaction r, the diagonal loses
    ``c_r a_r(x)``; the target ``x + s_r`` gains it when it is in the
    list, and every constraint it violates gains it in its sink row."""
    states = np.ascontiguousarray(np.asarray(states, np.int64))
    n, S = states.shape
    stoich = np.atleast_2d(np.asarray(model.stoichiometry, np.int64))
    bounds = np.asarray(bounds, np.float64)
    n_c = bounds.shape[0]
    cpu = local_cpu_device()
    with jax.default_device(cpu):
        c = np.asarray(jax.device_get(
            model.coefficients(t, jnp.float64)), np.float64)

        def values(x):
            if constraint_fn is None:
                return x.astype(np.float64)
            return np.asarray(jax.device_get(constraint_fn(
                jnp.asarray(x))), np.float64).reshape(x.shape[0], n_c)

        def propensity(r):
            return np.asarray(jax.device_get(model.propensity(
                jnp.asarray(states, jnp.float64), r)),
                np.float64).reshape(n)

        radix = states.max(axis=0) + 2 * (np.abs(stoich).max(axis=0) + 1)
        base = states.min(axis=0) - np.abs(stoich).max(axis=0) - 1
        if float(np.prod(radix.astype(np.float64))) >= 2.0 ** 62:
            raise ValueError("state keys would overflow int64")
        keys = _keys(states - base, radix)
        order = np.argsort(keys)
        sorted_keys = keys[order]

        rows, cols, vals = [], [], []
        s_rows, s_cols, s_vals = [], [], []
        diag = np.zeros(n)
        src = np.arange(n)
        for r in range(stoich.shape[0]):
            rate = c[r] * propensity(r)
            diag -= rate
            tgt = states + stoich[r]
            tk = _keys(tgt - base, radix)
            pos = np.minimum(np.searchsorted(sorted_keys, tk), n - 1)
            found = sorted_keys[pos] == tk
            rows.append(order[pos[found]])
            cols.append(src[found])
            vals.append(rate[found])
            viol = values(tgt) > bounds[None, :]             # [n, n_c]
            ci, si = np.nonzero(viol.T)
            s_rows.append(ci)
            s_cols.append(si)
            s_vals.append(rate[si])
        rows.append(src)
        cols.append(src)
        vals.append(diag)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    Smat = sp.csr_matrix((np.concatenate(s_vals),
                          (np.concatenate(s_rows), np.concatenate(s_cols))),
                         shape=(n_c, n))
    return CsrGenerator(A=A, S=Smat)


def box_space_fixed(bound: int):
    """The repressilator's fixed hyper-rectangle {0..bound}^3 at exact
    capacity: ``(model bundle, BoxStateSpace)``.  At ``bound=127`` it is
    the 128^3 box (2,097,152 states) of the operator checks and
    ``bench.py``."""
    import pacmensl_tpu as pm
    from ..statespace.box_space import BoxStateSpace
    from ..statespace.constraints import ConstraintSet
    b = pm.models.repressilator()
    cs = ConstraintSet(None, np.full(3, bound), np.full(3, 0.2))
    space = BoxStateSpace(b.model.stoichiometry, cs, b.x0,
                          prealloc_budget=float((bound + 1) ** 3))
    return b, space


def rel_l1(got, want) -> float:
    """Relative l1 distance sum|got - want| / sum|want| (float64)."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-300))


def box_action_error(op, t, p_box, data=None, ref=None):
    """Compare ``BoxOperator`` ``op`` with the CSR reference at time ``t``
    on the box-shaped vector ``p_box`` (host array, zero off the mask).

    Returns ``(rel_l1_dp, rel_l1_sinks, max_abs_dp_off_mask, ref)``: the
    operator's dp over the valid states and its sink derivative against
    the reference's, and the largest |dp| at invalid box positions (must
    be 0).  Pass a ``ref`` returned earlier to skip rebuilding it."""
    from .vecops import FspVector
    space = op.space
    mask = np.asarray(space.mask_host, bool)
    if ref is None:
        ref = generator_csr(op.model, np.argwhere(mask),
                            space.constraints.fn, space.constraints.bounds,
                            t)
    dp_ref, ds_ref = ref.apply(np.asarray(p_box, np.float64)[mask])
    y = FspVector(p=jnp.asarray(p_box, op.dtype),
                  sinks=jnp.zeros((space.num_constraints,), op.dtype))
    out = jax.jit(op.action)(t, y, data if data is not None else op.data())
    dp = np.asarray(jax.device_get(out.p), np.float64)
    ds = np.asarray(jax.device_get(out.sinks), np.float64)
    off = float(np.abs(dp[~mask]).max()) if (~mask).any() else 0.0
    return rel_l1(dp[mask], dp_ref), rel_l1(ds, ds_ref), off, ref


def ell_action_error(op, t, p, ref=None):
    """Compare ``EllOperator`` ``op`` with the CSR reference at time ``t``
    on the flat vector ``p`` [n_pad] (host array, zero past n).

    Returns ``(rel_l1_dp, rel_l1_sinks, max_abs_dp_past_n, ref)``."""
    from .vecops import FspVector
    ss = op.state_set
    n = ss.num_states
    if ref is None:
        ref = generator_csr(op.model, ss.states, ss.constraints.fn,
                            ss.constraints.bounds, t)
    p = np.asarray(p, np.float64)
    dp_ref, ds_ref = ref.apply(p[:n])
    y = FspVector(p=jnp.asarray(p, op.dtype),
                  sinks=jnp.zeros((op.num_constraints,), op.dtype))
    out = jax.jit(op.action)(t, y, op.data())
    dp = np.asarray(jax.device_get(out.p), np.float64)
    ds = np.asarray(jax.device_get(out.sinks), np.float64)
    tail = float(np.abs(dp[n:]).max()) if dp.shape[0] > n else 0.0
    return rel_l1(dp[:n], dp_ref), rel_l1(ds, ds_ref), tail, ref
