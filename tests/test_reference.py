"""Device operators against the plain CSR reference (ops/reference.py),
and the reference itself against a dense brute force.

The box action (static pad+slice stencil, XLA) is checked over every
geometry the operator meets: 1-D, 2-D and 3-D product constraints, a
time-varying model at several t, a 6-D box and |s| = 2 dimerization
shifts — in float64 to 1e-12 relative l1 and in float32 to 1e-5 (inflow
and outflow terms cancel at float32's eps ~ 6e-8)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pacmensl_tpu as pm
from pacmensl_tpu.models.model import Model
from pacmensl_tpu.ops.box_operator import BoxOperator
from pacmensl_tpu.ops.ell_operator import EllOperator
from pacmensl_tpu.ops.reference import (generator_csr, box_action_error,
                                        ell_action_error)
from pacmensl_tpu.statespace.box_space import BoxStateSpace
from pacmensl_tpu.statespace.constraints import ConstraintSet
from pacmensl_tpu.statespace.state_set import StateSet

def dimerization():
    """M birth/death plus 2M <-> D: shifts with |s| = 2 along one axis."""
    stoich = np.array([[1, 0], [-1, 0], [-2, 1], [2, -1]])

    def prop(x, r):
        xf = x if jnp.issubdtype(x.dtype, jnp.floating) \
            else x.astype(jnp.float64)
        m, d = xf[:, 0], xf[:, 1]
        return (jnp.full_like(m, 2.0), 0.1 * m, 0.05 * m * (m - 1.0),
                0.3 * d)[r]

    return Model(stoich, prop), None, np.array([24, 12]), np.array([[0, 0]])


def _bundle(name):
    if name == "dimerization":
        return dimerization()
    b = getattr(pm.models, name)()
    return b.model, b.constraint, b.bounds, b.x0


# (model, bounds override, t values)
BOX_CASES = [
    ("poisson", [50], (0.0,)),
    ("toggle", [12, 9, 40], (0.0,)),
    ("repressilator", [25, 15, 15, 60, 30, 60], (0.0,)),
    ("hog1p_3d", None, (0.0, 30.0, 120.0)),
    ("transcription_regulation_6d", None, (0.0, 600.0)),
    ("dimerization", None, (0.0,)),
]


def _box_op(name, bounds, dtype):
    model, fn, b0, x0 = _bundle(name)
    cs = ConstraintSet(fn, b0 if bounds is None else np.asarray(bounds))
    space = BoxStateSpace(model.stoichiometry, cs, x0)
    return BoxOperator(model, space, dtype=dtype)


def _random_box(op, seed):
    rng = np.random.default_rng(seed)
    return rng.random(op.space.shape) * op.space.mask_host


@pytest.mark.parametrize("name,bounds,ts", BOX_CASES,
                         ids=[c[0] for c in BOX_CASES])
def test_box_action_matches_reference(name, bounds, ts):
    op = _box_op(name, bounds, jnp.float64)
    p = _random_box(op, 0)
    for t in ts:
        e_dp, e_s, off, ref = box_action_error(op, t, p)
        assert e_dp <= 1e-12 and e_s <= 1e-12, (t, e_dp, e_s)
        assert off == 0.0
        assert ref.nnz > op.space.num_states


@pytest.mark.parametrize("name", ["toggle", "repressilator"])
def test_box_action_float32_matches_reference(name):
    bounds = {c[0]: c[1] for c in BOX_CASES}[name]
    op = _box_op(name, bounds, jnp.float32)
    e_dp, e_s, off, _ = box_action_error(op, 0.0, _random_box(op, 1))
    assert e_dp <= 1e-5 and e_s <= 1e-5, (e_dp, e_s)
    assert off == 0.0


def test_box_epoch_bounds_are_data():
    """Growing bounds within capacity changes only the operator data:
    the jitted action is reused without a retrace and still matches the
    reference at the new bounds."""
    from pacmensl_tpu.ops.vecops import FspVector
    b = pm.models.toggle()
    cs = ConstraintSet(b.constraint, np.array([16, 9, 40]),
                       b.expansion_factors)
    space = BoxStateSpace(b.model.stoichiometry, cs, b.x0)
    op = BoxOperator(b.model, space, dtype=jnp.float64)
    traces = []

    @jax.jit
    def act(y, data):
        traces.append(1)
        return op.action(0.0, y, data)

    shape0 = space.shape
    nc = space.num_constraints
    y = FspVector(p=jnp.asarray(_random_box(op, 2)),
                  sinks=jnp.zeros((nc,), jnp.float64))
    act(y, op.data())
    space.set_bounds(np.array([18, 9, 41]))
    assert tuple(space.shape) == tuple(shape0), "capacity must not change"
    data = op.refresh_data()
    act(y, data)
    assert len(traces) == 1
    e_dp, e_s, off, _ = box_action_error(op, 0.0, _random_box(op, 3), data)
    assert e_dp <= 1e-12 and e_s <= 1e-12 and off == 0.0


@pytest.mark.parametrize("mode", ["bucket", "plain"])
def test_ell_action_matches_reference(mode, monkeypatch):
    monkeypatch.setenv("PACMENSL_ELL_GATHER", mode)
    b = pm.models.repressilator()
    cs = ConstraintSet(b.constraint, np.array([30, 12, 12, 120, 40, 120]),
                       b.expansion_factors)
    ss = StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    op = EllOperator(b.model, ss, dtype=jnp.float64)
    rng = np.random.default_rng(4)
    p = np.zeros(op.n_pad)
    p[:ss.num_states] = rng.random(ss.num_states)
    e_dp, e_s, tail, _ = ell_action_error(op, 0.0, p)
    assert e_dp <= 1e-12 and e_s <= 1e-12 and tail == 0.0


def _dense_brute_force(model, states, fn, bounds, t):
    """Loop over states and reactions one at a time."""
    index = {tuple(int(v) for v in x): i for i, x in enumerate(states)}
    n, n_c = len(states), len(bounds)
    c = np.asarray(model.coefficients(t, jnp.float64))
    A = np.zeros((n, n))
    S = np.zeros((n_c, n))
    leave = np.zeros(n)
    for i, x in enumerate(states):
        for r, s in enumerate(np.asarray(model.stoichiometry)):
            a = c[r] * float(model.propensity(
                jnp.asarray(x[None, :], jnp.float64), r)[0])
            A[i, i] -= a
            tgt = x + s
            j = index.get(tuple(int(v) for v in tgt))
            if j is not None:
                A[j, i] += a
            else:
                leave[i] += a
            vals = (tgt if fn is None
                    else np.asarray(fn(jnp.asarray(tgt[None, :])))[0])
            for k in range(n_c):
                if vals[k] > bounds[k]:
                    S[k, i] += a
    return A, S, leave


@pytest.mark.parametrize("name,bounds", [
    ("poisson", [12]), ("toggle", [4, 3, 9]), ("dimerization", [8, 4]),
    ("birth_death", [9])])
def test_reference_matches_dense_brute_force(name, bounds):
    model, fn, _, x0 = _bundle(name)
    cs = ConstraintSet(fn, np.asarray(bounds))
    space = BoxStateSpace(model.stoichiometry, cs, x0)
    states = np.argwhere(space.mask_host)
    ref = generator_csr(model, states, fn, cs.bounds, 0.0)
    A, S, leave = _dense_brute_force(model, states, fn, cs.bounds, 0.0)
    np.testing.assert_allclose(ref.A.toarray(), A, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(ref.S.toarray(), S, rtol=1e-14, atol=1e-14)
    # column sums: what leaves the set is exactly the outward flux, and
    # with coordinate bounds (one violated constraint per exit) it all
    # reaches the sinks
    np.testing.assert_allclose(-np.asarray(ref.A.sum(axis=0)).ravel(),
                               leave, rtol=1e-12, atol=1e-14)
    if fn is None:
        np.testing.assert_allclose(np.asarray(ref.S.sum(axis=0)).ravel(),
                                   leave, rtol=1e-12, atol=1e-14)
