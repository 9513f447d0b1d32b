"""Sensitivity CME operators.

Equivalent of the reference ``SensFspMatrix<T>``
(``src/SensFsp/SensFspMatrix.h:44-209``): the derivative of the generator
w.r.t. parameter j splits as

    d_j A(t) = [d_j c(t)] x A   (+)   c(t) x [d_j A_r]

i.e. one operator built with the *derivative time coefficients* over the
``dtcoef_sparsity[j]`` reactions (``dcxA_``), plus one built with the
*derivative propensities* over the ``dprop_sparsity[j]`` reactions
(``cxdA_``).  Both are ordinary truncated-CME operators, so they are
composed here from the standard backends (Box or ELL) with restricted
reaction sets and substituted propensity/coefficient callables — including
their sink rows, exactly as the reference's constrained template
instantiation does.

The forward-sensitivity system

    d/dt [p, s_1..s_Np] = [A p, A s_1 + (d_1 A) p, ...]

is *linear* in the stacked vector, so the combined operator plugs straight
into every integrator in :mod:`..solvers` (the reference is restricted to
CVODES staggered integration; here Krylov-expm sensitivity integration
works too).  The ``A s_j`` applications are batched with ``vmap``, so the
sensitivity matvecs are the same operator with an extra batch axis.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from ..models.model import Model, SensModel
from .vecops import FspVector


class SensFspVector(NamedTuple):
    """Stacked (probability, sinks, sensitivities, sens-sinks) pytree."""
    p: jnp.ndarray        # box or flat
    sinks: jnp.ndarray    # [n_c]
    s: jnp.ndarray        # [n_par, ...]
    ssinks: jnp.ndarray   # [n_par, n_c]


def _coef_model(model: SensModel, j: int) -> Optional[Model]:
    """Model whose action is [d_j c(t)] x A restricted to its sparsity."""
    if model.d_t_coeff is None or not model.dtcoef_sparsity[j]:
        return None
    return Model(model.stoichiometry, model.propensity,
                 t_coeff=lambda t: model.d_t_coeff(j, t),
                 tv_reactions=model.dtcoef_sparsity[j])


def _prop_model(model: SensModel, j: int) -> Optional[Model]:
    """Model whose action is c(t) x [d_j A_r] restricted to its sparsity."""
    if model.d_propensity is None or not model.dprop_sparsity[j]:
        return None
    return Model(model.stoichiometry,
                 lambda x, r: model.d_propensity(x, j, r),
                 t_coeff=model.t_coeff,
                 tv_reactions=model.tv_reactions)


class SensOperator:
    """A(t) plus its per-parameter derivative operators."""

    def __init__(self, model: SensModel, space, operator_cls, dtype=None,
                 **op_kwargs):
        self.model = model
        self.dtype = dtype or DEFAULT_DTYPE
        self.n_par = model.num_parameters
        self.base = operator_cls(model.base_model(), space,
                                 dtype=self.dtype, **op_kwargs)
        self.dcxA: List[Optional[object]] = []
        self.cxdA: List[Optional[object]] = []
        for j in range(self.n_par):
            cm = _coef_model(model, j)
            self.dcxA.append(
                operator_cls(cm, space, dtype=self.dtype,
                             enable_reactions=model.dtcoef_sparsity[j],
                             **op_kwargs) if cm is not None else None)
            pmod = _prop_model(model, j)
            self.cxdA.append(
                operator_cls(pmod, space, dtype=self.dtype,
                             enable_reactions=model.dprop_sparsity[j],
                             **op_kwargs) if pmod is not None else None)

    # ----------------------------------------------------- epoch machinery
    def _sub_ops(self):
        return [self.base] + [o for o in self.dcxA if o is not None] + \
            [o for o in self.cxdA if o is not None]

    def data(self):
        """Per-epoch data of all sub-operators, as one pytree — thread it
        through jitted solves as an argument so one compiled program
        serves every expansion epoch at fixed capacity (same design as
        the transient driver's BoxOpData/EllOpData)."""
        def d(op):
            return op.data() if op is not None and hasattr(op, "data") \
                else None
        return (d(self.base), tuple(d(o) for o in self.dcxA),
                tuple(d(o) for o in self.cxdA))

    def refresh_data(self):
        """Box backend: re-snapshot masks/bounds after a within-capacity
        bounds change."""
        for op in self._sub_ops():
            if hasattr(op, "refresh_data"):
                op.refresh_data()

    def reassemble(self) -> bool:
        """ELL backend: re-assemble all sub-operators after the state set
        changed; True when any padded capacity grew (downstream programs
        must re-jit).  The ladders are deterministic in the state count,
        so all sub-operators grow in lockstep."""
        grew = False
        for op in self._sub_ops():
            if hasattr(op, "reassemble"):
                grew = op.reassemble() or grew
        return grew

    @property
    def n_pad(self) -> int:
        return self.base.n_pad

    # ------------------------------------------------------------------
    def sens_action(self, j: int, t, y: FspVector,
                    data=None) -> FspVector:
        """(d_j A)(t) y  (reference SensAction, SensFspMatrix.h:195-209)."""
        dc = None if data is None else data[1][j]
        dp = None if data is None else data[2][j]
        out = FspVector(p=jnp.zeros_like(y.p), sinks=jnp.zeros_like(y.sinks))
        if self.dcxA[j] is not None:
            d = self.dcxA[j].action(t, y, dc)
            out = FspVector(p=out.p + d.p, sinks=out.sinks + d.sinks)
        if self.cxdA[j] is not None:
            d = self.cxdA[j].action(t, y, dp)
            out = FspVector(p=out.p + d.p, sinks=out.sinks + d.sinks)
        return out

    def action(self, t, y: SensFspVector, data=None) -> SensFspVector:
        """Combined forward-sensitivity generator action."""
        base_d = None if data is None else data[0]
        base = self.base.action(t, FspVector(p=y.p, sinks=y.sinks), base_d)
        # A s_j for all j, batched over the parameter axis
        As = jax.vmap(
            lambda sp, sk: self.base.action(
                t, FspVector(p=sp, sinks=sk), base_d))(y.s, y.ssinks)
        pv = FspVector(p=y.p, sinks=y.sinks)
        gs, gsink = [], []
        for j in range(self.n_par):
            g = self.sens_action(j, t, pv, data)
            gs.append(g.p)
            gsink.append(g.sinks)
        g_p = jnp.stack(gs) if gs else jnp.zeros_like(y.s)
        g_k = jnp.stack(gsink) if gsink else jnp.zeros_like(y.ssinks)
        return SensFspVector(p=base.p, sinks=base.sinks,
                             s=As.p + g_p, ssinks=As.sinks + g_k)

    def __call__(self, t, y, data=None):
        return self.action(t, y, data)

    # ------------------------------------------------------------------
    def zero_vector(self) -> SensFspVector:
        z = self.base.zero_vector()
        return SensFspVector(
            p=z.p, sinks=z.sinks,
            s=jnp.zeros((self.n_par,) + z.p.shape, self.dtype),
            ssinks=jnp.zeros((self.n_par,) + z.sinks.shape, self.dtype))

    def local_mv_flops(self) -> float:
        return self.base.local_mv_flops() * (1 + self.n_par)
