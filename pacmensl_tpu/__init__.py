"""pacmensl_tpu — a JAX Finite State Projection (FSP) framework.

A from-scratch re-design of the capabilities of pacmensl (PArallel Chemical
Master EquatioN Solver Library, C++/MPI/PETSc) for accelerators with
JAX/XLA: solve the Chemical Master Equation of stochastic reaction
networks by adaptive Finite State Projection — transient distributions,
forward parameter sensitivities and Fisher information, stationary
distributions, and smFISH likelihoods — on one chip or a sharded device mesh.

Quick start::

    import pacmensl_tpu as pm

    bundle = pm.models.repressilator()
    solver = pm.FspSolverMultiSinks()
    solver.set_model(bundle.model)
    solver.set_constraints(bundle.constraint, bundle.bounds,
                           bundle.expansion_factors)
    solver.set_initial_distribution(bundle.x0, bundle.p0)
    dist = solver.solve(t_final=10.0, fsp_tol=1e-4)
    marg = dist.marginal(0)
"""
from . import config  # noqa: F401  (must run first: sets jax_enable_x64)

from .config import DEFAULT_DTYPE, default_dtype  # noqa: F401
from .sys import errors  # noqa: F401
from .sys.errors import (  # noqa: F401
    PacmenslError, SetupError, StateSpaceError, IntegratorError)
from .sys.environment import Environment, init, finalize, STATE_AXIS  # noqa: F401
from .sys.options import Options, GLOBAL_OPTIONS  # noqa: F401
from .sys.events import EventLog  # noqa: F401
from .models.model import Model, SensModel  # noqa: F401
from .models import library as models  # noqa: F401
from .statespace.constraints import ConstraintSet  # noqa: F401
from .statespace.box_space import BoxStateSpace  # noqa: F401
from .statespace.state_set import StateSet  # noqa: F401
from .statespace.partitioner import (  # noqa: F401
    StatePartitioner, PartitioningType, PartitioningApproach)

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports of the heavier solver layers to keep import time low.
    if name in ("FspSolverMultiSinks", "DiscreteDistribution"):
        from .fsp import solver as _s, distribution as _d
        return {"FspSolverMultiSinks": _s.FspSolverMultiSinks,
                "DiscreteDistribution": _d.DiscreteDistribution}[name]
    if name in ("SensFspSolverMultiSinks", "SensDiscreteDistribution"):
        from .sensfsp import sens_solver as _ss
        return getattr(_ss, name)
    if name == "StationaryFspSolverMultiSinks":
        from .stationary import solver as _st
        return _st.StationaryFspSolverMultiSinks
    if name in ("SmFishSnapshot", "smfish_loglikelihood", "smfish_gradient"):
        from .smfish import snapshot as _sn
        return getattr(_sn, name)
    if name == "Pdo":
        from .pdo.pdo import Pdo
        return Pdo
    raise AttributeError(name)
