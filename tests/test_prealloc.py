"""Eager box-capacity preallocation + device-built incremental masks.

With ``preallocate=True``, adaptive solves water-fill the vector-memory
budget as box capacity up-front (one compiled solve program for the whole
expansion trajectory) and rebuild the validity mask per epoch with a
device-side BFS seeded from the previous mask.  These tests force the
policy on CPU and pin (a) capacity/water-filling invariants, (b) exact
agreement of the incremental mask with a from-scratch build, and (c)
end-to-end solve equality against the default (ladder) policy.
"""
import numpy as np
import pytest

import pacmensl_tpu as pm
from pacmensl_tpu.statespace.box_space import BoxStateSpace
from pacmensl_tpu.statespace.constraints import ConstraintSet


def test_waterfill_capacity_and_incremental_bfs(monkeypatch):
    b = pm.models.repressilator()
    cs = ConstraintSet(b.constraint, b.bounds, b.expansion_factors)
    # headroom 0 = round-3 fill-the-budget policy (one compile, max cap)
    monkeypatch.setenv("PACMENSL_BOX_HEADROOM", "0")
    sp_full = BoxStateSpace(b.model.stoichiometry, cs, b.x0,
                            prealloc_budget=2.0e5, build_on_device=True)
    assert sp_full.size <= 2.0e5
    # growable axes share a common water-filled cap
    assert len(set(sp_full.shape)) == 1

    # default headroom: capacity targets need * 8, not the whole budget
    monkeypatch.delenv("PACMENSL_BOX_HEADROOM", raising=False)
    sp = BoxStateSpace(b.model.stoichiometry, cs, b.x0,
                       prealloc_budget=2.0e5, build_on_device=True)
    assert sp.size <= 2.0e5
    assert sp.size < sp_full.size, \
        "headroom target should allocate below the full budget"
    n0 = sp.num_states

    # several expansion epochs: fill-budget capacity stays put, headroom
    # capacity may climb its rungs monotonically, and EVERY epoch's mask
    # (incremental BFS) equals a from-scratch ladder build on both
    shape_full0 = sp_full.shape
    prev_shape = sp.shape
    bounds = np.asarray(b.bounds)
    for _ in range(3):
        bounds = ConstraintSet(b.constraint, bounds,
                               b.expansion_factors).expanded_bounds(
                                   np.ones(len(bounds), bool))
        sp.set_bounds(bounds)
        sp_full.set_bounds(bounds)
        assert sp_full.shape == shape_full0, \
            "fill-budget capacity must not move within budget"
        assert all(a >= b_ for a, b_ in zip(sp.shape, prev_shape)), \
            "headroom capacity must be monotone"
        prev_shape = sp.shape
        ref = BoxStateSpace(
            b.model.stoichiometry,
            ConstraintSet(b.constraint, bounds, b.expansion_factors), b.x0)
        for s_chk in (sp, sp_full):
            assert s_chk.num_states == ref.num_states
            assert set(map(tuple, s_chk.states())) == \
                set(map(tuple, ref.states()))
    assert sp.num_states > n0


def test_budget_too_small_raises():
    b = pm.models.repressilator()
    cs = ConstraintSet(None, np.array([100, 100, 100]), None)
    from pacmensl_tpu.sys.errors import StateSpaceError
    with pytest.raises(StateSpaceError):
        BoxStateSpace(b.model.stoichiometry, cs, b.x0,
                      prealloc_budget=1.0e3)


@pytest.mark.slow
def test_prealloc_solve_matches_default(monkeypatch):
    monkeypatch.setenv("PACMENSL_BOX_MEM_BUDGET", "1e8")
    b = pm.models.repressilator()

    def run(pre):
        s = pm.FspSolverMultiSinks(backend="box", preallocate=pre)
        s.set_model(b.model)
        s.set_constraint_functions(b.constraint)
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors(b.expansion_factors)
        s.set_initial_distribution(b.x0, b.p0)
        return s.solve(0.6, 1e-4)

    d1, d2 = run(True), run(False)
    assert d1.num_states == d2.num_states
    m = {tuple(x): float(p) for x, p in zip(d2.states, d2.p)}
    tv = 0.5 * sum(abs(float(p) - m[tuple(x)])
                   for x, p in zip(d1.states, d1.p))
    assert tv < 1e-6, tv
