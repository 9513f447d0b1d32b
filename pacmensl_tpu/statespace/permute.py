"""Species-axis permutation for the dense-box backend.

Orderings are free: position in the box is pure data layout.  Sorting the
species axes by DESCENDING box extent puts the longest axis first (the
shard axis under a device mesh) and keeps the trailing dims as large as
possible.  This module
rewrites a (model, constraints, initial states) problem into an internal
species order: stoichiometry columns and initial-state columns permute,
while propensity/constraint callables receive a column-remapping view so
user code keeps seeing ITS species indices.  Constraint outputs (bounds,
sinks) keep user order — only coordinate inputs are remapped — so the
driver's bookkeeping and results need no translation except the state
columns of the final distribution.

The reference has no analogue: PETSc's sparse rows are layout-free.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..models.model import Model, SensModel
from .constraints import ConstraintSet


class _PermCols:
    """Column-remapping view: ``v[:, i]`` reads column ``inv[i]`` of the
    wrapped object (anything supporting ``x[:, int]``/``astype``)."""

    __slots__ = ("_x", "_inv")

    def __init__(self, x, inv):
        self._x = x
        self._inv = inv

    @property
    def dtype(self):
        return self._x.dtype

    def astype(self, dt):
        return _PermCols(self._x.astype(dt), self._inv)

    def __getitem__(self, key):
        if (isinstance(key, tuple) and len(key) == 2
                and isinstance(key[0], slice) and key[0] == slice(None)
                and isinstance(key[1], (int, np.integer))):
            return self._x[:, int(self._inv[key[1]])]
        raise TypeError(
            f"permuted state view supports only x[:, i] access, got {key!r}")

    def __len__(self):
        raise TypeError("permuted state view has no static length")


def choose_axis_order(box_extents) -> Optional[np.ndarray]:
    """Axis order by extent; None when the current order already
    matches.  Assignment: largest extent -> axis 0 (the shard axis),
    second and third largest -> the last two axes (second-largest last),
    the rest (smallest extents) in the middle."""
    ext = np.asarray(box_extents, dtype=np.int64)
    S = ext.shape[0]
    idx = np.argsort(-ext, kind="stable")
    if S <= 2:
        order = idx
    else:
        order = np.concatenate([idx[:1], idx[3:], idx[2:3], idx[1:2]])
    if (order == np.arange(S)).all():
        return None
    return order


def _wrap_cols(fn, inv):
    """Wrap a callable whose first argument is a states batch."""
    def wrapped(x, *args):
        return fn(_PermCols(x, inv), *args)
    return wrapped


def permute_model(model: Model, order) -> Model:
    """Model in internal species order ``order`` (internal axis j = user
    species order[j]); the propensity keeps seeing user indices."""
    order = np.asarray(order, dtype=np.int64)
    inv = np.argsort(order)
    stoich = model.stoichiometry[:, order]
    names = (None if model.species_names is None
             else [model.species_names[int(s)] for s in order])
    if isinstance(model, SensModel):
        d_prop = (None if model.d_propensity is None
                  else _wrap_cols(model.d_propensity, inv))
        return SensModel(stoich, _wrap_cols(model.propensity, inv),
                         model.t_coeff, model.tv_reactions, names,
                         num_parameters=model.num_parameters,
                         d_t_coeff=model.d_t_coeff,
                         dtcoef_sparsity=model.dtcoef_sparsity,
                         d_propensity=d_prop,
                         dprop_sparsity=model.dprop_sparsity)
    return Model(stoich, _wrap_cols(model.propensity, inv),
                 model.t_coeff, model.tv_reactions, names)


def permute_constraints(cs: ConstraintSet, order,
                        num_species: int) -> ConstraintSet:
    """ConstraintSet whose fn reads internally-ordered
    coordinates; constraint OUTPUT order (bounds, sinks) is unchanged.
    Default (fn=None) coordinate constraints become explicit user-column
    getters so their output order stays the user's species order."""
    order = np.asarray(order, dtype=np.int64)
    inv = np.argsort(order)
    if cs.fn is None:
        # constraint i = user species i = internal column inv[i]
        def fn(x):
            import jax.numpy as jnp
            return jnp.stack([x[:, int(inv[i])]
                              for i in range(num_species)], axis=1)
        return ConstraintSet(fn, cs.bounds, cs.expansion_factors)
    fn = _wrap_cols(cs.fn, inv)
    return ConstraintSet(fn, cs.bounds, cs.expansion_factors)
