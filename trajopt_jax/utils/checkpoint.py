"""Checkpoint/resume of solver state.

The reference has no checkpointing (SURVEY.md §5) — examples pickle raw rollout dicts
(examples/ilqr/mpc/pendulum_parallel.py:59-61).  Here every solver's state is a pytree
(reference trajectory + controller + duals), so checkpointing is a generic
orbax save/restore of that pytree between outer iterations.
"""

from __future__ import annotations

import pathlib
from typing import Any

import jax
import numpy as np


def solver_state(solver) -> dict[str, Any]:
    """Extract the resumable pytree from any trajopt_jax solver instance."""
    state: dict[str, Any] = {}
    for name in (
        "xref", "uref", "ctl", "ictl", "vfunc", "qfunc", "cost", "dyn",
        "xdist", "udist", "xudist", "param", "nominal", "noise",
        "bref_mu", "bref_sigma", "gocost", "comecost",
        "lmbda", "dlmbda", "alpha", "beta", "eta", "last_return",
        "kl_bound", "kl_mult",
    ):
        if hasattr(solver, name):
            value = getattr(solver, name)
            if value is not None:
                state[name] = value
    return state


def save(path: str | pathlib.Path, solver) -> None:
    """Persist solver state with orbax (atomic directory checkpoint)."""
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).resolve()
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, solver_state(solver), force=True)


def _known_types():
    from ..core.belief import BeliefCostExpansion, BeliefDynamicsExpansion
    from ..core.types import (
        GaussianSequence,
        LinearDynamics,
        LinearGaussianDynamics,
        LinearGaussianPolicy,
        LinearPolicy,
        MatrixNormalParams,
        QuadraticCost,
        QuadraticQValue,
        QuadraticValue,
    )

    return [
        LinearGaussianDynamics, LinearDynamics, LinearGaussianPolicy, LinearPolicy,
        QuadraticCost, QuadraticQValue, QuadraticValue, GaussianSequence,
        MatrixNormalParams, BeliefCostExpansion, BeliefDynamicsExpansion,
    ]


def _rebuild(value, template):
    """Reconstruct NamedTuple containers from orbax's dict representation."""
    if isinstance(value, dict):
        if template is not None and hasattr(template, "_fields"):
            cls = type(template)
            return cls(**{
                f: _rebuild(value[f], getattr(template, f)) for f in cls._fields
            })
        for cls in _known_types():
            if set(cls._fields) == set(value.keys()):
                return cls(**{f: value[f] for f in cls._fields})
    return value


def restore(path: str | pathlib.Path, solver) -> None:
    """Restore previously saved state into a freshly-constructed solver.

    The solver must have been constructed with the same env/horizon configuration.
    orbax stores NamedTuples as field dicts; container types are rebuilt from the
    fresh solver's attributes (or the known pytree registry when the fresh attribute
    is still None).
    """
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).resolve()
    with ocp.PyTreeCheckpointer() as ckptr:
        raw = ckptr.restore(path)
    for name, value in raw.items():
        setattr(solver, name, _rebuild(value, getattr(solver, name, None)))
