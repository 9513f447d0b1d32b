"""State-space tests mirroring the reference's test_fss.cpp strategy:
exhaustive-enumeration oracles for expansion under constraints, index
round-trips, and error handling for mismatched dimensions."""
import numpy as np
import pytest

import pacmensl_tpu as pm
from pacmensl_tpu.statespace.constraints import ConstraintSet
from pacmensl_tpu.statespace.box_space import BoxStateSpace
from pacmensl_tpu.statespace.state_set import StateSet
from pacmensl_tpu.sys.errors import StateSpaceError

import jax.numpy as jnp

# Toggle-switch stoichiometry (2 species, 6 reactions), as in test_fss.cpp
TOGGLE_SM = np.array([[1, 0], [1, 0], [-1, 0], [0, 1], [0, 1], [0, -1]])


def simplex_constraint(x):
    # x0 + x1 <= b with also per-coordinate bounds, as test_fss.cpp:104-130
    return jnp.stack([x[:, 0], x[:, 1], x[:, 0] + x[:, 1]], axis=1)


def test_toggle_simplex_enumeration_stateset():
    """Expansion of the toggle model under x0+x1<=3 must enumerate exactly
    the 10 lattice points of the simplex (reference oracle, test_fss.cpp)."""
    cs = ConstraintSet(simplex_constraint, [3, 3, 3])
    ss = StateSet(TOGGLE_SM, cs, init_states=[[0, 0]])
    ss.expand()
    assert ss.num_states == 10
    # every enumerated state has a valid round-trip index
    idx = ss.state2index(ss.states)
    assert (idx == np.arange(10)).all()
    # all simplex members found
    expected = {(i, j) for i in range(4) for j in range(4) if i + j <= 3}
    assert {tuple(s) for s in ss.states} == expected
    # a state outside the set maps to -1
    assert ss.state2index([[4, 0]])[0] == -1
    assert ss.state2index([[2, 2]])[0] == -1


def test_toggle_simplex_enumeration_box():
    cs = ConstraintSet(simplex_constraint, [3, 3, 3])
    box = BoxStateSpace(TOGGLE_SM, cs, init_states=[[0, 0]])
    assert box.num_states == 10
    states = box.states()
    expected = {(i, j) for i in range(4) for j in range(4) if i + j <= 3}
    assert {tuple(s) for s in states} == expected
    idx = box.state2index(states)
    assert (idx >= 0).all()
    assert box.state2index([[2, 2]])[0] == -1


def test_box_reachability_masks_unreachable():
    """A pure-birth process starting at 2 can never reach 0 or 1."""
    sm = np.array([[1]])
    cs = ConstraintSet(None, [5])
    box = BoxStateSpace(sm, cs, init_states=[[2]])
    states = box.states().ravel().tolist()
    assert states == [2, 3, 4, 5]


def test_expansion_growth_and_embed():
    cs = ConstraintSet(None, [3], expansion_factors=[0.5])
    box = BoxStateSpace(np.array([[1], [-1]]), cs, init_states=[[0]])
    assert box.num_states == 4
    old_shape = box.shape
    new_bounds = cs.expanded_bounds([True])
    # reference growth formula: round(3*1.5+0.5) = 5
    assert new_bounds[0] == 5
    box.set_bounds(new_bounds)
    assert box.num_states == 6
    p_old = jnp.arange(4, dtype=jnp.float64)
    p_new = box.embed_old(p_old, old_shape)
    np.testing.assert_allclose(np.asarray(p_new)[:4], np.arange(4))
    np.testing.assert_allclose(np.asarray(p_new)[4:], 0.0)


def test_stateset_expand_after_bounds_growth():
    cs = ConstraintSet(simplex_constraint, [3, 3, 3])
    ss = StateSet(TOGGLE_SM, cs, init_states=[[0, 0]])
    ss.expand()
    assert ss.num_states == 10
    ss.set_bounds([4, 4, 4])
    ss.expand()
    assert ss.num_states == 15   # simplex x0+x1<=4


def test_dimension_mismatch_raises():
    cs = ConstraintSet(None, [3, 3])
    ss = StateSet(TOGGLE_SM, cs)
    with pytest.raises(StateSpaceError):
        ss.add_states([[1, 2, 3]])   # 3 species vs 2


def test_default_constraint_needs_bound_per_species():
    with pytest.raises(StateSpaceError):
        ConstraintSet(None, [3], num_species=2)


def test_partitioner_block_and_graph():
    from pacmensl_tpu.statespace.partitioner import (
        StatePartitioner, PartitioningType)
    cs = ConstraintSet(simplex_constraint, [10, 10, 10])
    ss = StateSet(TOGGLE_SM, cs, init_states=[[0, 0]])
    ss.expand()
    for ptype in (PartitioningType.BLOCK, PartitioningType.GRAPH,
                  PartitioningType.HYPERGRAPH):
        part = StatePartitioner(ptype)
        res = part.partition(ss.states, ss.stoich, 4,
                             state2index=ss.state2index)
        assert res.boundaries[0] == 0 and res.boundaries[-1] == ss.num_states
        assert (np.diff(res.boundaries) >= 0).all()
        assert np.sort(res.order).tolist() == list(range(ss.num_states))


def test_host_constraint_sweeps_compile_once_per_size_class():
    """Host-side constraint evaluations pad rows to power-of-two classes
    and share one jit through with_bounds copies, so an adaptive solve's
    ever-changing sweep sizes do not compile a program each."""
    cs = ConstraintSet(simplex_constraint, [3, 3, 3])
    rng = np.random.default_rng(0)
    for n, c in ((300, cs), (400, cs.with_bounds([5, 5, 5])), (511, cs)):
        x = rng.integers(0, 6, size=(n, 2))
        got = c.satisfied(x)
        want = np.asarray(simplex_constraint(jnp.asarray(x))) <= c.bounds
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(c.all_satisfied(x), want.all(axis=1))
    assert cs._jit_cache["values"]._cache_size() == 1
