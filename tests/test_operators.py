"""Operator tests mirroring the reference's test_mat.cpp strategy:
conservation of the generator (column sums = 0 including sink rows),
action vs explicitly materialized matrix on random vectors, constrained
variants with sinks, and cross-backend consistency."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import pacmensl_tpu as pm
from pacmensl_tpu.ops.box_operator import BoxOperator
from pacmensl_tpu.ops.ell_operator import EllOperator
from pacmensl_tpu.ops.vecops import FspVector, total_mass
from pacmensl_tpu.statespace.box_space import BoxStateSpace
from pacmensl_tpu.statespace.state_set import StateSet
from pacmensl_tpu.statespace.constraints import ConstraintSet


def make_birth(rate=2.0, bound=6):
    """1-species birth process (reference test_mat.cpp's oracle model)."""
    bundle = pm.models.poisson(rate)
    cs = ConstraintSet(None, [bound], [0.1])
    return bundle.model, cs


def box_pair(model, cs, x0):
    space = BoxStateSpace(model.stoichiometry, cs, x0)
    return space, BoxOperator(model, space)


def ell_pair(model, cs, x0):
    ss = StateSet(model.stoichiometry, cs, init_states=x0)
    ss.expand()
    return ss, EllOperator(model, ss)


def rand_fspvec(op, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.random(op.zero_vector().p.shape)
    if hasattr(op, "mask_f"):
        p = p * np.asarray(jax.device_get(op.mask_f))
    if hasattr(op, "n_states"):
        p[op.n_states:] = 0.0
    return FspVector(p=jnp.asarray(p), sinks=op.zero_vector().sinks)


# ------------------------------------------------------------ conservation

@pytest.mark.parametrize("backend", ["box", "ell"])
def test_birth_conservation(backend):
    """Column sums of the full generator (states + sinks) are zero:
    d/dt (sum p + sum sinks) == 0 for any p (single-constraint model,
    so no sink multi-counting)."""
    model, cs = make_birth()
    make = box_pair if backend == "box" else ell_pair
    _, op = make(model, cs, [[0]])
    y = rand_fspvec(op)
    dy = op.action(0.0, y)
    assert abs(float(total_mass(dy))) < 1e-12


@pytest.mark.parametrize("backend", ["box", "ell"])
def test_toggle_conservation(backend):
    bundle = pm.models.toggle()
    cs = ConstraintSet(None, [10, 10])   # coordinate bounds: no overlap
    make = box_pair if backend == "box" else ell_pair
    _, op = make(bundle.model, cs, bundle.x0)
    y = rand_fspvec(op, seed=3)
    dy = op.action(0.0, y)
    assert abs(float(total_mass(dy))) < 1e-10


# ----------------------------------------------------- action == matrix ---

def test_ell_action_matches_dense():
    bundle = pm.models.toggle()
    cs = ConstraintSet(bundle.constraint, [6, 6, 12])
    ss, op = ell_pair(bundle.model, cs, bundle.x0)
    A = op.dense_matrix()
    n = ss.num_states
    rng = np.random.default_rng(1)
    for seed in range(3):
        v = rng.random(n)
        vec = np.zeros(op.n_pad)
        vec[:n] = v
        y = FspVector(p=jnp.asarray(vec),
                      sinks=jnp.zeros(op.num_constraints))
        dy = op.action(0.0, y)
        ref = A @ v
        np.testing.assert_allclose(np.asarray(dy.p)[:n], ref[:n],
                                   rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(np.asarray(dy.sinks), ref[n:],
                                   rtol=1e-12, atol=1e-13)


def test_box_matches_ell():
    """Both backends must produce the same generator action on the same
    state set (custom constraints => both see identical member states)."""
    bundle = pm.models.toggle()
    cs = ConstraintSet(bundle.constraint, [6, 6, 12])
    space, bop = box_pair(bundle.model, cs, bundle.x0)
    ss, eop = ell_pair(bundle.model, cs, bundle.x0)
    assert space.num_states == ss.num_states

    rng = np.random.default_rng(7)
    n = ss.num_states
    v = rng.random(n)

    # Build matching vectors in both layouts
    pe = np.zeros(eop.n_pad)
    pe[:n] = v
    ye = FspVector(p=jnp.asarray(pe), sinks=jnp.zeros(eop.num_constraints))

    pb = np.zeros(space.size)
    idx = space.state2index(ss.states)
    assert (idx >= 0).all()
    pb[idx] = v
    yb = FspVector(p=jnp.asarray(pb).reshape(space.shape),
                   sinks=jnp.zeros(space.num_constraints))

    de = eop.action(0.0, ye)
    db = bop.action(0.0, yb)
    np.testing.assert_allclose(
        np.asarray(db.p).reshape(-1)[idx], np.asarray(de.p)[:n],
        rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(db.sinks), np.asarray(de.sinks),
                               rtol=1e-12, atol=1e-13)


def test_time_varying_coefficients():
    """hog1p 5d has a time-varying reaction; action must track c_r(t)."""
    bundle = pm.models.hog1p_5d()
    cs = ConstraintSet(bundle.constraint, bundle.bounds_hyperrec[:5].tolist()
                       + [20, 20] if False else bundle.bounds)
    # keep the space small
    cs = ConstraintSet(bundle.constraint, [3, 3, 3, 3, 3, 4, 4])
    space, op = box_pair(bundle.model, cs, bundle.x0)
    y = rand_fspvec(op, seed=5)
    d0 = op.action(0.0, y)
    d60 = op.action(60.0, y)
    # the tv reaction (gene activation) changes massively between t=0, 60
    assert not np.allclose(np.asarray(d0.p), np.asarray(d60.p))
    # jit with traced t works
    f = jax.jit(lambda t, y: op.action(t, y))
    d60j = f(60.0, y)
    np.testing.assert_allclose(np.asarray(d60j.p), np.asarray(d60.p),
                               rtol=1e-12)


def test_sink_rows_capture_outflow():
    """For a pure birth process with bound N, sink rate = rate * p[N]."""
    model, cs = make_birth(rate=2.0, bound=6)
    space, op = box_pair(model, cs, [[0]])
    p = np.zeros(space.shape)
    p[6] = 0.5   # mass at the boundary state
    y = FspVector(p=jnp.asarray(p), sinks=jnp.zeros(1))
    dy = op.action(0.0, y)
    np.testing.assert_allclose(float(dy.sinks[0]), 2.0 * 0.5, rtol=1e-13)
    np.testing.assert_allclose(float(jnp.sum(dy.p)), -1.0, rtol=1e-13)


def test_ell_bucket_gather_matches_plain(monkeypatch):
    """The bucket-shift gather (dynamic rolls + compacted residue — the
    roll-based path for compressed spaces) must reproduce the plain XLA
    gather exactly, including across an expansion-style reassembly."""
    import jax.numpy as jnp
    from pacmensl_tpu.statespace.state_set import StateSet
    from pacmensl_tpu.statespace.constraints import ConstraintSet
    from pacmensl_tpu.ops.ell_operator import EllOperator
    from pacmensl_tpu.ops.vecops import FspVector

    b = pm.models.repressilator()
    cs = ConstraintSet(b.constraint, b.bounds, b.expansion_factors)
    ss = StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    op = EllOperator(b.model, ss, dtype=jnp.float64)
    print("residue fraction:", op._rem_frac)

    rng = np.random.default_rng(0)
    p = np.zeros(op.n_pad)
    p[:ss.num_states] = rng.random(ss.num_states)
    y = FspVector(p=jnp.asarray(p), sinks=jnp.zeros((6,), jnp.float64))

    outs = {}
    for mode in ("plain", "bucket"):
        monkeypatch.setenv("PACMENSL_ELL_GATHER", mode)
        outs[mode] = op.action(0.7, y)
    np.testing.assert_allclose(np.asarray(outs["bucket"].p),
                               np.asarray(outs["plain"].p),
                               rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(np.asarray(outs["bucket"].sinks),
                               np.asarray(outs["plain"].sinks),
                               rtol=1e-13, atol=1e-14)

    # expansion epoch: grow bounds, reassemble, compare again
    ss.set_bounds(cs.expanded_bounds(np.ones(6, bool)))
    ss.expand()
    op.reassemble()
    p2 = np.zeros(op.n_pad)
    p2[:ss.num_states] = rng.random(ss.num_states)
    y2 = FspVector(p=jnp.asarray(p2), sinks=jnp.zeros((6,), jnp.float64))
    outs = {}
    for mode in ("plain", "bucket"):
        monkeypatch.setenv("PACMENSL_ELL_GATHER", mode)
        outs[mode] = op.action(0.7, y2)
    np.testing.assert_allclose(np.asarray(outs["bucket"].p),
                               np.asarray(outs["plain"].p),
                               rtol=1e-13, atol=1e-14)


def test_ell_bucket_full_solve_matches(monkeypatch):
    """End-to-end Poisson oracle through the bucket gather path."""
    from scipy.stats import poisson as poisson_law
    monkeypatch.setenv("PACMENSL_ELL_GATHER", "bucket")
    b = pm.models.poisson(2.0)
    s = pm.FspSolverMultiSinks(backend="ell", odes_type="krylov")
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    s.set_ode_tolerances(1e-8, 1e-14)
    d = s.solve(6.0, 1e-6)
    pdf = poisson_law.pmf(d.states[:, 0], 12.0)
    assert np.abs(d.p - pdf).sum() <= 1e-6


def test_ell_plain_reassembly_keeps_compiled_shapes(monkeypatch):
    """In plain-gather mode an expansion inside the padded capacity keeps
    every jit argument's shape: the bucket arrays (whose top-K offsets
    move every epoch) are not passed, so the solve is not recompiled."""
    import jax.numpy as jnp
    from pacmensl_tpu.statespace.state_set import StateSet
    from pacmensl_tpu.statespace.constraints import ConstraintSet
    from pacmensl_tpu.ops.ell_operator import EllOperator

    monkeypatch.delenv("PACMENSL_ELL_GATHER", raising=False)
    b = pm.models.repressilator()
    cs = ConstraintSet(b.constraint, b.bounds, b.expansion_factors)
    ss = StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    op = EllOperator(b.model, ss, dtype=jnp.float64,
                     capacity_floor=8 * ss.num_states)
    shapes = jax.tree_util.tree_map(jnp.shape, op.data())
    ss.set_bounds(cs.expanded_bounds(np.ones(6, bool)))
    ss.expand()
    assert not op.reassemble()
    assert jax.tree_util.tree_map(jnp.shape, op.data()) == shapes
    assert op.data().rem_row is None
