"""Backend routing + mid-solve box->ELL migration.

Custom-constraint (non-hyper-rectangle) solves route to the compressed
backend by default; a box-backend solve carries a safety valve, a
mid-solve migration to the compressed backend when expansion outgrows
the vector-memory budget (PACMENSL_BOX_MEM_BUDGET) or fill collapses.
These tests pin the routing, the migration semantics and box/ELL
agreement for the flagship custom-constraint shape.
"""
import os

import numpy as np
import pytest

import pacmensl_tpu as pm


def _solve(backend, t_final=1.0, budget=None, monkeypatch=None):
    if budget is not None:
        monkeypatch.setenv("PACMENSL_BOX_MEM_BUDGET", str(budget))
    b = pm.models.repressilator()
    s = pm.FspSolverMultiSinks(backend=backend)
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    d = s.solve(t_final, 1e-4)
    return d, s


def _as_dict(d):
    return {tuple(x): float(p) for x, p in zip(d.states, d.p)}


@pytest.mark.slow
def test_custom_constraint_box_matches_ell():
    """Product-constraint repressilator through the box backend must give
    the ELL backend's distribution (same states, TV at solver-tolerance
    scale)."""
    d_box, s_box = _solve("box")
    d_ell, s_ell = _solve("ell")
    assert s_box._backend_used == "box"
    assert d_box.num_states == d_ell.num_states
    a, b = _as_dict(d_box), _as_dict(d_ell)
    assert set(a) == set(b)
    tv = 0.5 * sum(abs(a[k] - b[k]) for k in a)
    assert tv < 1e-5, tv


@pytest.mark.slow
def test_box_migrates_to_ell_on_budget(monkeypatch):
    """A vector-memory budget too small for the growing box must trigger
    the mid-solve migration — and the final answer must match a pure-box
    solve."""
    d_ref, _ = _solve("box", t_final=1.0)
    d_mig, s = _solve("box", t_final=1.0, budget=5e5,
                      monkeypatch=monkeypatch)
    assert s._backend_used == "ell", "migration did not trigger"
    a, b = _as_dict(d_ref), _as_dict(d_mig)
    assert set(a) == set(b)
    tv = 0.5 * sum(abs(a[k] - b[k]) for k in a)
    assert tv < 1e-5, tv


@pytest.mark.medium
def test_auto_routing_on_cpu_prefers_ell_for_custom_fn():
    """Auto keeps custom constraints on the compressed backend."""
    _, s = _solve("auto", t_final=0.05)
    assert s._backend_used == "ell"


def test_hog1p_5d_box_matches_ell():
    """The 5-species time-varying hog1p benchmark through the dense box
    backend must match the compressed backend."""
    b = pm.models.hog1p_5d()

    def run(backend):
        s = pm.FspSolverMultiSinks(backend=backend, odes_type="cvode")
        s.set_model(b.model)
        s.set_constraint_functions(b.constraint)
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors(b.expansion_factors)
        s.set_initial_distribution(b.x0, b.p0)
        return s.solve(4.0, 1e-4)

    d1, d2 = run("box"), run("ell")
    assert d1.num_states == d2.num_states
    m = {tuple(x): float(p) for x, p in zip(d2.states, d2.p)}
    tv = 0.5 * sum(abs(float(p) - m[tuple(x)])
                   for x, p in zip(d1.states, d1.p))
    assert tv < 1e-6, tv


def test_fill_collapse_gate_ignores_headroom_padding():
    """Round-4 regression: the fill-collapse migration gate must measure
    fill against the TIGHT bounding box of the new bounds, not the
    headroom-padded capacity.  On chip the flagship repressilator
    (12-40% tight fill, 8x headroom) presented <1.5% fill vs capacity at
    its first expansion and the whole solve fell onto the gather backend
    (7x wall regression).  This reproduces that event's numbers exactly:
    n=36k states, tight box ~150k, padded capacity 2.5M."""
    _, s = _solve("box", t_final=0.1)
    assert s._backend_used == "box"

    real_space = s._space

    class _PaddedSpace:
        size = 2.5e6          # 8x-headroom-padded capacity
        num_states = 36000    # ~24% fill of the tight box below

        def __getattr__(self, name):
            # delegate anything the gate reads beyond the overrides above
            # to the real space, so a future attribute read exercises the
            # gate instead of failing with AttributeError
            return getattr(real_space, name)

    s._space = _PaddedSpace()
    # bounds whose tight box is (52,52,52) ~ 1.4e5 elements
    new_bounds = np.asarray([51, 51, 51, 5000, 5000, 5000], np.int64)
    assert s._should_leave_box(new_bounds) is False
