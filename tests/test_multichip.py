"""Multi-device tests on the virtual 8-device CPU mesh: sharded solves
must agree exactly with single-device solves (the reference's strategy of
re-running the same tests at several MPI rank counts, SURVEY.md §4)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.stats import poisson as poisson_law

import pacmensl_tpu as pm
from pacmensl_tpu.parallel.mesh import make_mesh, shard_fsp_vector, box_spec
from pacmensl_tpu.ops.box_operator import BoxOperator
from pacmensl_tpu.ops.vecops import FspVector
from pacmensl_tpu.statespace.box_space import BoxStateSpace
from pacmensl_tpu.statespace.constraints import ConstraintSet


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_matvec_matches_single():
    """The sharded stencil matvec must equal the unsharded one bit-for-bit
    in structure (same math, collective permutes for halos)."""
    b = pm.models.toggle()
    cs = ConstraintSet(None, [63, 31])
    space = BoxStateSpace(b.model.stoichiometry, cs, b.x0)
    op = BoxOperator(b.model, space)
    rng = np.random.default_rng(0)
    p = rng.random(space.shape) * np.asarray(jax.device_get(op.mask_f))
    y = FspVector(p=jnp.asarray(p), sinks=jnp.zeros(2))
    d_single = jax.jit(op.action)(0.0, y)

    mesh = make_mesh()
    y_sh = shard_fsp_vector(y, mesh)
    assert y_sh.p.sharding.spec == box_spec(space.shape, 8)
    d_sh = jax.jit(op.action)(0.0, y_sh)
    # different reduction orders across shards => tiny fp differences
    np.testing.assert_allclose(np.asarray(jax.device_get(d_sh.p)),
                               np.asarray(jax.device_get(d_single.p)),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(jax.device_get(d_sh.sinks)),
                               np.asarray(jax.device_get(d_single.sinks)),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["box", "ell"])
def test_sharded_fsp_solve_matches_single(backend):
    """Full FSP solve with expansion on the 8-device mesh equals the
    single-device result."""
    def build(mesh):
        b = pm.models.poisson(2.0)
        s = pm.FspSolverMultiSinks(backend=backend, odes_type="krylov",
                                   mesh=mesh)
        s.set_model(b.model)
        s.set_initial_bounds([10])
        s.set_expansion_factors([0.5])
        s.set_initial_distribution(b.x0, b.p0)
        return s

    d1 = build(None).solve(10.0, 1e-6)
    d8 = build(make_mesh()).solve(10.0, 1e-6)
    assert d1.num_states == d8.num_states
    np.testing.assert_allclose(d8.p, d1.p, rtol=1e-12, atol=1e-16)
    err = np.abs(d8.p - poisson_law.pmf(d8.states[:, 0], 20.0)).sum()
    assert err <= 1e-6


def test_halo_ell_matches_single_device():
    """The shard_map halo-exchange ELL matvec (explicit all_to_all plan,
    the reference's VecScatter halo) must equal the single-device ELL
    operator exactly."""
    from pacmensl_tpu.parallel.halo_ell import ShardedEllOperator
    from pacmensl_tpu.ops.ell_operator import EllOperator
    from pacmensl_tpu.statespace.state_set import StateSet

    b = pm.models.toggle()
    cs = ConstraintSet(b.constraint, b.bounds, b.expansion_factors)
    ss = StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    mesh = make_mesh(8)
    op1 = EllOperator(b.model, ss)
    op8 = ShardedEllOperator(b.model, ss, mesh)
    # surface-not-volume communication: the halo is a thin band
    assert op8.halo_width < op8.shard_len

    rng = np.random.default_rng(1)
    vals = rng.random(ss.num_states)
    p1 = np.zeros(op1.n_pad)
    p1[:ss.num_states] = vals
    p8 = np.zeros(op8.n_pad)
    p8[:ss.num_states] = vals
    y1 = FspVector(p=jnp.asarray(p1), sinks=jnp.zeros(cs.num_constraints))
    y8 = op8.zero_vector()
    y8 = FspVector(p=y8.p + jnp.asarray(p8), sinks=y8.sinks)

    d1 = jax.jit(op1.action)(0.5, y1)
    d8 = jax.jit(op8.action)(0.5, y8)
    n = ss.num_states
    np.testing.assert_allclose(np.asarray(d8.p)[:n], np.asarray(d1.p)[:n],
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(d8.sinks), np.asarray(d1.sinks),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.medium
def test_sharded_ell_bucket_matches_plain(monkeypatch):
    """The sharded bucket-shift gather (per-shard local rolls + residue
    over the halo-extended vector) must equal the plain unified gather
    exactly."""
    import os
    import jax.numpy as jnp
    from pacmensl_tpu.parallel.halo_ell import ShardedEllOperator
    from pacmensl_tpu.statespace.state_set import StateSet
    from pacmensl_tpu.statespace.constraints import ConstraintSet
    from pacmensl_tpu.ops.vecops import FspVector

    b = pm.models.toggle()
    cs = ConstraintSet(None, [31, 31])
    ss = StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    mesh = make_mesh(8)
    outs = {}
    for mode in ("plain", "bucket"):
        monkeypatch.setenv("PACMENSL_ELL_GATHER", mode)
        op = ShardedEllOperator(b.model, ss, mesh, dtype=jnp.float64)
        rng = np.random.default_rng(0)
        p = np.zeros(op.n_pad)
        p[:ss.num_states] = rng.random(ss.num_states)
        y = FspVector(p=jnp.asarray(p), sinks=jnp.zeros((2,), jnp.float64))
        out = op.action(0.3, y)
        outs[mode] = (np.asarray(out.p), np.asarray(out.sinks))
    np.testing.assert_allclose(outs["bucket"][0], outs["plain"][0],
                               rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(outs["bucket"][1], outs["plain"][1],
                               rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_gspmd_box_action_matches_reference(n_dev):
    """The box action sharded over the mesh by GSPMD (XLA inserts the
    halo collective-permutes) against the CSR reference: 3-D product
    constraints, sinks included."""
    from pacmensl_tpu.ops.reference import generator_csr, rel_l1
    b = pm.models.repressilator()
    cs = ConstraintSet(b.constraint, np.array([31, 7, 7, 99, 21, 99]),
                       b.expansion_factors)
    space = BoxStateSpace(b.model.stoichiometry, cs, b.x0,
                          pad_quanta=[8, 1, 1])
    op = BoxOperator(b.model, space)
    mask = space.mask_host
    p = np.random.default_rng(0).random(space.shape) * mask
    y = shard_fsp_vector(FspVector(p=jnp.asarray(p),
                                   sinks=jnp.zeros(cs.num_constraints)),
                         make_mesh(n_dev))
    out = jax.jit(op.action)(0.3, y, op.data())
    ref = generator_csr(b.model, np.argwhere(mask), b.constraint,
                        cs.bounds, 0.3)
    dp_ref, ds_ref = ref.apply(p[mask])
    dp = np.asarray(jax.device_get(out.p))
    assert rel_l1(dp[mask], dp_ref) <= 1e-12
    assert rel_l1(jax.device_get(out.sinks), ds_ref) <= 1e-12
    assert not dp[~mask].any()


def test_gspmd_box_solve_matches_single_device():
    """Meshed end-to-end box solve (expansion included) on the GSPMD
    stencil: same states as one device, Poisson(10) to the FSP
    tolerance."""
    b = pm.models.poisson(2.0)

    def run(mesh):
        s = pm.FspSolverMultiSinks(backend="box", odes_type="krylov",
                                   mesh=mesh)
        s.set_model(b.model)
        s.set_initial_bounds([15])
        s.set_expansion_factors([0.5])
        s.set_initial_distribution(b.x0, b.p0)
        return s.solve(5.0, 1e-5)

    d8, d1 = run(make_mesh(8)), run(None)
    assert d8.num_states == d1.num_states
    err = np.abs(d8.p - poisson_law.pmf(d8.states[:, 0], 10.0)).sum()
    assert err <= 5e-5, err
    assert np.abs(d8.p - d1.p).sum() <= 1e-10
