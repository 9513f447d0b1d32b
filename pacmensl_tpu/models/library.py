"""Bundled example models.

Re-implementations (from the published model definitions, not code copies) of
the reference's header-only example CMEs:

* toggle switch            (``src/Models/toggle_model.h``)
* repressilator            (``src/Models/repressilator_model.h``)
* hog1p 3-species MAPK     (``src/Models/hog1p_3d_model.h``)
* hog1p 5-species MAPK     (``src/Models/hog1p_5d_model.h``)
* 6-species transcription regulation (``src/Models/transcription_regulation_6d_model.h``)

plus the analytic-oracle test models used by the reference test-suite
(Poisson pure-birth, birth-death, telegraph/bursting gene;
``tests/test_fsp_solver.cpp:180-220``, ``tests/test_sensfsp_solver.cpp``).

Each entry bundles the :class:`Model` with its FSP shape (constraint function,
right-hand-side bounds, expansion factors) and a default initial condition.
All propensities are jnp-traceable and vectorized over states.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from .model import Model, SensModel

def _f(x):
    """Cast states to a float dtype for propensity arithmetic, keeping the
    caller's compute dtype (the operators pass float32/float64 coordinate
    grids; hard-coding float64 would promote a float32 operator's
    arithmetic to float64)."""
    import jax.numpy as _jnp
    if _jnp.issubdtype(x.dtype, _jnp.floating):
        return x
    return x.astype(_jnp.float64)


def _ipow(x, n: int):
    """x**n for small non-negative integer n by repeated squaring.

    The matrix-free box operator re-evaluates propensities on every
    matvec; ``jnp.power`` with a float exponent lowers to a
    transcendental pow (exp + log per element), while integer Hill
    exponents (the reference models use pow(x, 6.0) etc.,
    repressilator_model.h:15,39) need only log2(n) multiplies.
    """
    assert n >= 1 and n == int(n)
    n = int(n)
    out = None
    sq = x
    while n:
        if n & 1:
            out = sq if out is None else out * sq
        n >>= 1
        if n:
            sq = sq * sq
    return out



@dataclass
class BundledModel:
    model: Model
    constraint: Optional[Callable]       # (states[n,S]) -> [n, n_c] int; None = coord bounds
    bounds: np.ndarray                   # [n_c] int
    expansion_factors: np.ndarray        # [n_c] float
    x0: np.ndarray                       # [n_init, S] int
    p0: np.ndarray                       # [n_init] float
    name: str
    # Optional hyper-rectangle variant (reference *_hyperrec)
    bounds_hyperrec: Optional[np.ndarray] = None
    expansion_factors_hyperrec: Optional[np.ndarray] = None


# --------------------------------------------------------------- toggle ---

def toggle() -> BundledModel:
    """Two-species genetic toggle switch (toggle_model.h:8-51).

    Rate constants folded into the propensity (time-invariant convention,
    see tests/test_ode.cpp:62-85).
    """
    ayx, axy, nyx, nxy = 2.6e-3, 6.1e-3, 3.0, 2.1
    kx0, kx, dx = 2.2e-3, 1.7e-2, 3.8e-4
    ky0, ky, dy = 6.8e-5, 1.6e-2, 3.8e-4
    # rows = reactions: birth0_x, birth_x, death_x, birth0_y, birth_y, death_y
    stoich = np.array([[1, 0], [1, 0], [-1, 0], [0, 1], [0, 1], [0, -1]])

    def prop(x, r):
        xf = _f(x)
        if r == 0:
            return jnp.full_like(xf[:, 0], kx0)
        if r == 1:
            return kx / (1.0 + ayx * _ipow(xf[:, 1], 3))  # nyx = 3
        if r == 2:
            return dx * xf[:, 0]
        if r == 3:
            return jnp.full_like(xf[:, 0], ky0)
        if r == 4:
            return ky / (1.0 + axy * jnp.power(xf[:, 0], nxy))
        if r == 5:
            return dy * xf[:, 1]
        raise ValueError(r)

    def constr(x):
        return jnp.stack([x[:, 0], x[:, 1], x[:, 0] * x[:, 1]], axis=1)

    return BundledModel(
        model=Model(stoich, prop),
        constraint=constr,
        bounds=np.array([200, 200, 2000]),
        expansion_factors=np.array([0.2, 0.2, 0.2]),
        x0=np.array([[0, 0]]), p0=np.array([1.0]),
        name="toggle",
    )


# --------------------------------------------------------- repressilator ---

def repressilator() -> BundledModel:
    """Three-gene repressilator (repressilator_model.h:8-59)."""
    k1, ka, ket, kg = 100.0, 20.0, 6.0, 1.0
    stoich = np.array([
        [1, 0, 0], [-1, 0, 0],
        [0, 1, 0], [0, -1, 0],
        [0, 0, 1], [0, 0, -1],
    ])

    def prop(x, r):
        xf = _f(x)
        if r == 0:
            return k1 / (1.0 + ka * _ipow(xf[:, 1], 6))  # ket = 6
        if r == 1:
            return kg * xf[:, 0]
        if r == 2:
            return k1 / (1.0 + ka * _ipow(xf[:, 2], 6))  # ket = 6
        if r == 3:
            return kg * xf[:, 1]
        if r == 4:
            return k1 / (1.0 + ka * _ipow(xf[:, 0], 6))  # ket = 6
        if r == 5:
            return kg * xf[:, 2]
        raise ValueError(r)

    def constr(x):
        return jnp.stack([
            x[:, 0], x[:, 1], x[:, 2],
            x[:, 0] * x[:, 1], x[:, 2] * x[:, 1], x[:, 0] * x[:, 2],
        ], axis=1)

    return BundledModel(
        model=Model(stoich, prop),
        constraint=constr,
        bounds=np.array([22, 2, 2, 44, 4, 44]),
        expansion_factors=np.array([0.2] * 6),
        bounds_hyperrec=np.array([22, 2, 2]),
        expansion_factors_hyperrec=np.array([0.2, 0.2, 0.2]),
        x0=np.array([[21, 0, 0]]), p0=np.array([1.0]),
        name="repressilator",
    )


# ------------------------------------------------------------- hog1p 5d ---

def _hog_signal(t):
    """Time-varying Hog1p signal shared by the 3d/5d MAPK models
    (hog1p_5d_model.h:54-64)."""
    r1, r2, eta, Ahog, Mhog = 6.9e-5, 7.1e-3, 3.1, 9.3e9, 6.4e-4
    h1 = (1.0 - jnp.exp(-r1 * t)) * jnp.exp(-r2 * t)
    hog1p = jnp.power(h1 / (1.0 + h1 / Mhog), eta) * Ahog
    return jnp.maximum(0.0, 3200.0 - 7710.0 * hog1p)


def hog1p_5d() -> BundledModel:
    """Five-species hog1p MAPK model with time-varying gene activation
    (hog1p_5d_model.h); reaction 2 is time-varying."""
    k12, k23, k34 = 1.29, 0.0067, 0.133
    k32, k43, k21 = 0.027, 0.0381, 1.0
    kr21, kr31, kr41 = 0.005, 0.45, 0.025
    kr22, kr32, kr42 = 0.0116, 0.987, 0.0538
    trans, gamma1, gamma2 = 0.01, 0.001, 0.0049

    stoich = np.array([
        [1, 0, 0, 0, 0], [-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0],
        [0, 1, 0, 0, 0], [0, 0, 1, 0, 0],
        [0, -1, 0, 1, 0], [0, 0, -1, 0, 1],
        [0, 0, 0, -1, 0], [0, 0, 0, 0, -1],
    ])

    def prop(x, r):
        g = x[:, 0]
        xf = _f(x)
        if r == 0:
            return k12 * (g == 0) + k23 * (g == 1) + k34 * (g == 2)
        if r == 1:
            return k32 * (g == 2) + k43 * (g == 3)
        if r == 2:
            return 1.0 * (g == 1)       # x c_2(t) = signal
        if r == 3:
            return kr21 * (g == 1) + kr31 * (g == 2) + kr41 * (g == 3)
        if r == 4:
            return kr22 * (g == 1) + kr32 * (g == 2) + kr42 * (g == 3)
        if r == 5:
            return trans * xf[:, 1]
        if r == 6:
            return trans * xf[:, 2]
        if r == 7:
            return gamma1 * xf[:, 3]
        if r == 8:
            return gamma2 * xf[:, 4]
        raise ValueError(r)

    def t_coeff(t):
        c = jnp.ones((9,))
        return c.at[2].set(_hog_signal(t))

    def constr(x):
        return jnp.stack([
            x[:, 0], x[:, 1], x[:, 2], x[:, 3], x[:, 4],
            x[:, 1] + x[:, 3], x[:, 2] + x[:, 4],
        ], axis=1)

    return BundledModel(
        model=Model(stoich, prop, t_coeff, tv_reactions=(2,)),
        constraint=constr,
        bounds=np.array([3, 10, 10, 10, 10, 10, 10]),
        expansion_factors=np.array([0.0, .25, .25, .25, .25, .25, .25]),
        bounds_hyperrec=np.array([3, 10, 10, 10, 10]),
        expansion_factors_hyperrec=np.array([0.0, .25, .25, .25, .25]),
        x0=np.array([[0, 0, 0, 0, 0]]), p0=np.array([1.0]),
        name="hog1p_5d",
    )


def hog1p_3d() -> BundledModel:
    """Three-species reduction of the hog1p model (hog1p_3d_model.h)."""
    k12, k21, k23 = 1.29, 1.0, 0.0067
    k32, k34, k43 = 0.027, 0.133, 0.0381
    kr2, kr3, kr4 = 0.0116, 0.987, 0.0538
    trans, gamma = 0.01, 0.0049

    stoich = np.array([
        [1, 0, 0], [-1, 0, 0], [-1, 0, 0],
        [0, 1, 0], [0, -1, 1], [0, -1, 0], [0, 0, -1],
    ])

    def prop(x, r):
        g = x[:, 0]
        xf = _f(x)
        if r == 0:
            return k12 * (g == 0) + k23 * (g == 1) + k34 * (g == 2)
        if r == 1:
            return k32 * (g == 2) + k43 * (g == 3)
        if r == 2:
            return 1.0 * (g == 1)
        if r == 3:
            return kr2 * (g == 1) + kr3 * (g == 2) + kr4 * (g == 3)
        if r == 4:
            return trans * xf[:, 1]
        if r == 5:
            return gamma * xf[:, 1]
        if r == 6:
            return gamma * xf[:, 2]
        raise ValueError(r)

    def t_coeff(t):
        c = jnp.ones((7,))
        return c.at[2].set(_hog_signal(t))

    def constr(x):
        rna = x[:, 1] + x[:, 2]
        return jnp.stack([
            x[:, 0], x[:, 1], x[:, 2],
            (x[:, 0] == 0) * rna, (x[:, 0] == 1) * rna,
            (x[:, 0] == 2) * rna, (x[:, 0] == 3) * rna,
        ], axis=1)

    return BundledModel(
        model=Model(stoich, prop, t_coeff, tv_reactions=(2,)),
        constraint=constr,
        bounds=np.array([3, 4, 4, 1, 10, 10, 10]),
        expansion_factors=np.array([0.0, .5, .5, .5, .5, .5, .5]),
        x0=np.array([[0, 0, 0]]), p0=np.array([1.0]),
        name="hog1p_3d",
    )


# ----------------------------------------------- transcription reg (6d) ---

def transcription_regulation_6d() -> BundledModel:
    """Six-species transcription regulation with cell-volume growth
    (transcription_regulation_6d_model.h); reactions 4, 6, 8 time-varying."""
    c0, c1, c2, c3 = 0.043, 0.0007, 0.078, 0.0039
    c5, c7, c9 = 0.4791, 0.8765e-11, 0.5
    avg_cell_cyc_time = 35 * 60.0

    stoich = np.array([
        # species:  M    D   RNAP  DNA.D  DNA.2D  RNA
        [1, 0, 0, 0, 0, 0],        # 0: transcription RNA->M
        [-1, 0, 0, 0, 0, 0],       # 1: M degradation
        [0, 0, 0, 0, 0, 1],        # 2: RNA production from DNA.D
        [0, 0, 0, 0, 0, -1],       # 3: RNA degradation
        [0, -1, -1, 1, 0, 0],      # 4: D + RNAP -> DNA.D
        [0, 1, 1, -1, 0, 0],       # 5: DNA.D -> D + RNAP
        [0, -1, 0, -1, 1, 0],      # 6: DNA.D + D -> DNA.2D
        [0, 1, 0, 1, -1, 0],       # 7: DNA.2D -> DNA.D + D
        [-2, 1, 0, 0, 0, 0],       # 8: 2M -> D
        [2, -1, 0, 0, 0, 0],       # 9: D -> 2M
    ])

    def prop(x, r):
        xf = _f(x)
        if r == 0:
            return c0 * xf[:, 5]
        if r == 1:
            return c1 * xf[:, 0]
        if r == 2:
            return c2 * xf[:, 3]
        if r == 3:
            return c3 * xf[:, 5]
        if r == 4:
            return xf[:, 1] * xf[:, 2]
        if r == 5:
            return c5 * xf[:, 3]
        if r == 6:
            return xf[:, 3] * xf[:, 1]
        if r == 7:
            return c7 * xf[:, 4]
        if r == 8:
            return 0.5 * xf[:, 0] * (xf[:, 0] - 1.0)
        if r == 9:
            return c9 * xf[:, 1]
        raise ValueError(r)

    def t_coeff(t):
        av = 6.022140857e8 * jnp.power(2.0, t / avg_cell_cyc_time)
        c = jnp.ones((10,))
        c = c.at[4].set(0.012e9 / av)
        c = c.at[6].set(0.00012e9 / av)
        c = c.at[8].set(0.05e9 / av)
        return c

    return BundledModel(
        model=Model(stoich, prop, t_coeff, tv_reactions=(4, 6, 8)),
        constraint=None,   # default coordinate-wise bounds
        bounds=np.array([10, 6, 1, 2, 1, 1]),
        expansion_factors=np.array([0.5] * 6),
        bounds_hyperrec=np.array([10, 6, 1, 2, 1, 1]),
        expansion_factors_hyperrec=np.array([0.5] * 6),
        x0=np.array([[2, 6, 0, 2, 0, 0]]), p0=np.array([1.0]),
        name="transcr_reg_6d",
    )


# ------------------------------------------------------ analytic oracles ---

def poisson(rate: float = 2.0) -> BundledModel:
    """Pure-birth process; p(t) is exactly Poisson(rate*t).

    The reference uses this as its main correctness oracle
    (tests/test_fsp_solver.cpp:180-220).
    """
    stoich = np.array([[1]])

    def prop(x, r):
        return jnp.full_like(_f(x)[:, 0], rate)

    return BundledModel(
        model=Model(stoich, prop),
        constraint=None,
        bounds=np.array([5]),
        expansion_factors=np.array([0.1]),
        x0=np.array([[0]]), p0=np.array([1.0]),
        name="poisson",
    )


def poisson_sens(rate: float = 2.0) -> BundledModel:
    """Poisson model as a SensModel in one parameter (the rate), with the
    rate carried by the time coefficient (tests/test_sensfsp_solver.cpp)."""
    stoich = np.array([[1]])

    def prop(x, r):
        return jnp.full_like(_f(x)[:, 0], 1.0)

    def t_coeff(t):
        return jnp.array([rate])

    def d_t_coeff(j, t):
        return jnp.array([1.0])

    m = SensModel(stoich, prop, t_coeff, tv_reactions=(0,),
                  num_parameters=1,
                  d_t_coeff=d_t_coeff, dtcoef_sparsity=((0,),),
                  d_propensity=None, dprop_sparsity=())
    return BundledModel(
        model=m, constraint=None,
        bounds=np.array([5]), expansion_factors=np.array([0.1]),
        x0=np.array([[0]]), p0=np.array([1.0]),
        name="poisson_sens",
    )


def birth_death(birth: float = 1.0, death: float = 0.1) -> BundledModel:
    """Birth-death process; stationary law is Poisson(birth/death)."""
    stoich = np.array([[1], [-1]])

    def prop(x, r):
        if r == 0:
            return jnp.full_like(_f(x)[:, 0], birth)
        return death * _f(x)[:, 0]

    return BundledModel(
        model=Model(stoich, prop),
        constraint=None,
        bounds=np.array([10]),
        expansion_factors=np.array([0.25]),
        x0=np.array([[0]]), p0=np.array([1.0]),
        name="birth_death",
    )


def telegraph(k01: float = 1.0e-2, k10: float = 1.0e-1,
              kr: float = 10.0, gamma: float = 1.0) -> BundledModel:
    """Telegraph (bursting gene) model: gene off/on + mRNA
    (tests/test_sensfsp_solver.cpp telegraph fixture).

    Species: (g_off, g_on, rna). As a SensModel in (k01, k10, kr, gamma).
    """
    stoich = np.array([
        [-1, 1, 0], [1, -1, 0], [0, 0, 1], [0, 0, -1],
    ])

    def prop(x, r):
        xf = _f(x)
        if r == 0:
            return k01 * xf[:, 0]
        if r == 1:
            return k10 * xf[:, 1]
        if r == 2:
            return kr * xf[:, 1]
        if r == 3:
            return gamma * xf[:, 2]
        raise ValueError(r)

    def d_prop(x, j, r):
        xf = _f(x)
        if j == 0 and r == 0:
            return xf[:, 0]
        if j == 1 and r == 1:
            return xf[:, 1]
        if j == 2 and r == 2:
            return xf[:, 1]
        if j == 3 and r == 3:
            return xf[:, 2]
        return jnp.full_like(_f(x)[:, 0], 0.0)

    m = SensModel(stoich, prop,
                  num_parameters=4,
                  d_propensity=d_prop,
                  dprop_sparsity=((0,), (1,), (2,), (3,)),
                  d_t_coeff=None, dtcoef_sparsity=())
    return BundledModel(
        model=m, constraint=None,
        bounds=np.array([2, 2, 1]),
        expansion_factors=np.array([0.25, 0.25, 0.25]),
        x0=np.array([[1, 0, 0]]), p0=np.array([1.0]),
        name="telegraph",
    )


def hog1p_3d_sens() -> BundledModel:
    """hog1p_3d as a SensModel in (trans, gamma) — the translation and
    degradation rates (the reference's SensModels are user-assembled from
    DPropFun callbacks + sparsity lists, SensModel.h:58-97; this bundles
    the benchmark model the same way for the sensitivity driver)."""
    base = hog1p_3d()
    trans, gamma = 0.01, 0.0049
    stoich = base.model.stoichiometry

    def d_prop(x, j, r):
        xf = _f(x)
        if j == 0 and r == 4:          # d/d trans [trans * x1]
            return xf[:, 1]
        if j == 1 and r == 5:          # d/d gamma [gamma * x1]
            return xf[:, 1]
        if j == 1 and r == 6:          # d/d gamma [gamma * x2]
            return xf[:, 2]
        return jnp.zeros_like(xf[:, 0])

    m = SensModel(stoich, base.model.propensity,
                  base.model.t_coeff, tv_reactions=(2,),
                  num_parameters=2,
                  d_propensity=d_prop,
                  dprop_sparsity=((4,), (5, 6)),
                  d_t_coeff=None, dtcoef_sparsity=())
    return BundledModel(
        model=m, constraint=base.constraint,
        bounds=base.bounds, expansion_factors=base.expansion_factors,
        x0=base.x0, p0=base.p0, name="hog1p_3d_sens",
    )


def hog1p_5d_sens() -> BundledModel:
    """hog1p_5d as a SensModel in (trans, gamma1) — the translation rate
    (reactions 5, 6) and the first mRNA degradation rate (reaction 7).
    BASELINE.json config 4 names 'forward sensitivity FSP on hog1p';
    this is the honest 5-species interpretation at the transient
    config's protocol (examples/hog1p.cpp:150-158: t=180, tol 1e-4)."""
    base = hog1p_5d()
    stoich = base.model.stoichiometry

    def d_prop(x, j, r):
        xf = _f(x)
        if j == 0 and r == 5:          # d/d trans [trans * x1]
            return xf[:, 1]
        if j == 0 and r == 6:          # d/d trans [trans * x2]
            return xf[:, 2]
        if j == 1 and r == 7:          # d/d gamma1 [gamma1 * x3]
            return xf[:, 3]
        return jnp.zeros_like(xf[:, 0])

    m = SensModel(stoich, base.model.propensity,
                  base.model.t_coeff, tv_reactions=(2,),
                  num_parameters=2,
                  d_propensity=d_prop,
                  dprop_sparsity=((5, 6), (7,)),
                  d_t_coeff=None, dtcoef_sparsity=())
    return BundledModel(
        model=m, constraint=base.constraint,
        bounds=base.bounds, expansion_factors=base.expansion_factors,
        x0=base.x0, p0=base.p0, name="hog1p_5d_sens",
    )


ALL_MODELS = {
    "toggle": toggle,
    "repressilator": repressilator,
    "hog1p_3d": hog1p_3d,
    "hog1p_5d": hog1p_5d,
    "transcr_reg_6d": transcription_regulation_6d,
    "poisson": poisson,
    "birth_death": birth_death,
    "telegraph": telegraph,
    "hog1p_3d_sens": hog1p_3d_sens,
    "hog1p_5d_sens": hog1p_5d_sens,
}
