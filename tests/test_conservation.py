"""Mass-conservation regression tests.

The truncated generator + sink rows conserve probability up to the
reference's deliberate sink *multi-counting*: a transition whose target
violates k >= 1 constraints deposits its flux into all k sinks
(FspMatrixConstrained.cpp:173-195), so

    sum(dp) + sum(dsinks) = sum over transitions of (k - 1) * flux  >= 0.

Negative defect = probability destroyed with no sink credit — the regression
this file guards: hog1p's coordinate-gated constraints
((x0==g)*(x1+x2) <= b, hog1p_3d_model.h) defeated the axis-ray bounding-box
probe, the mixed-radix key space came out too small, and the state directory
silently rejected out-of-range BFS states (observed as a -0.9/s leak).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pacmensl_tpu as pm
from pacmensl_tpu.ops.ell_operator import EllOperator
from pacmensl_tpu.ops.box_operator import BoxOperator
from pacmensl_tpu.ops.vecops import FspVector
from pacmensl_tpu.statespace.constraints import ConstraintSet
from pacmensl_tpu.statespace.state_set import StateSet
from pacmensl_tpu.statespace.box_space import BoxStateSpace


MODELS = ["toggle", "repressilator", "hog1p_3d", "hog1p_5d"]


@pytest.mark.parametrize("name", MODELS)
def test_ell_operator_conserves_mass(name):
    b = getattr(pm.models, name)()
    cs = ConstraintSet(b.constraint, b.bounds, b.expansion_factors)
    ss = StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    op = EllOperator(b.model, ss)
    n = ss.num_states
    rng = np.random.default_rng(0)
    p = np.zeros(op.n_pad)
    p[:n] = rng.random(n)
    y = FspVector(p=jnp.asarray(p), sinks=jnp.zeros(cs.num_constraints))

    bits = np.asarray(op.sink_bits)          # [R, n_pad] uint32
    diag = np.asarray(op.diag_val, np.float64)
    pops = np.zeros_like(diag)
    for c in range(cs.num_constraints):
        pops += ((bits >> c) & 1).astype(np.float64)

    for t in (0.0, 7.5, 60.0):
        d = jax.jit(op.action)(t, y)
        defect = float(d.p.sum()) + float(d.sinks.sum())
        c_t = np.asarray(jax.device_get(
            b.model.coefficients(t, jnp.float64)))
        c_sel = c_t[list(op.enable_reactions)]
        expected = float(
            (c_sel[:, None] * diag * np.maximum(pops - 1.0, 0.0) * p).sum())
        scale = max(float((c_sel[:, None] * diag * p).sum()), 1.0)
        # defect must equal the multi-count surplus exactly — in particular
        # it must never be negative (mass destruction)
        assert defect >= -1e-9 * scale, (t, defect)
        np.testing.assert_allclose(defect, expected, rtol=1e-9,
                                   atol=1e-9 * scale)


@pytest.mark.parametrize("name", ["toggle", "hog1p_3d"])
def test_box_operator_never_destroys_mass(name):
    b = getattr(pm.models, name)()
    cs = ConstraintSet(b.constraint, b.bounds, b.expansion_factors)
    space = BoxStateSpace(b.model.stoichiometry, cs, b.x0)
    op = BoxOperator(b.model, space)
    rng = np.random.default_rng(1)
    p = rng.random(space.shape) * np.asarray(space.mask_host, np.float64)
    y = FspVector(p=jnp.asarray(p), sinks=jnp.zeros(cs.num_constraints))
    for t in (0.0, 7.5, 60.0):
        d = jax.jit(op.action)(t, y, op.data())
        defect = float(d.p.sum()) + float(d.sinks.sum())
        scale = max(float(np.abs(np.asarray(d.p)).sum()), 1.0)
        assert defect >= -1e-9 * scale, (t, defect)


def test_hog1p_sets_agree_across_backends():
    """The BFS list and the box mask must enumerate the same set (gated
    constraints were silently truncating both)."""
    b = pm.models.hog1p_3d()
    cs = ConstraintSet(b.constraint, b.bounds, b.expansion_factors)
    ss = StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    space = BoxStateSpace(b.model.stoichiometry, cs, b.x0)
    set_a = {tuple(s) for s in ss.states}
    set_b = {tuple(s) for s in space.states()}
    assert set_a == set_b
    assert len(set_a) == 78      # regression pin (was 30 when truncated)


@pytest.mark.slow
def test_hog1p_solve_preserves_mass():
    """End-to-end: retained mass must satisfy the FSP certificate, and
    retained + (unique) sunk mass accounts for 1 (sinks may overcount)."""
    b = pm.models.hog1p_3d()
    s = pm.FspSolverMultiSinks()
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    d = s.solve(60.0, 1e-4)
    mass = float(d.sum())
    sunk = float(np.asarray(d.sinks).sum())
    assert 1.0 - 1e-4 <= mass <= 1.0 + 1e-8, mass      # FSP certificate
    assert mass + sunk >= 1.0 - 1e-8                   # nothing destroyed
