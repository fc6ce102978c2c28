"""Fixed-trip-count scalar solvers, batched over whole fields.

Port of ``breeze_tpu/thermo/solvers.py``: a fixed iteration count with no
convergence branch, so every point does the same work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class FixedIterations:
    iterations: int = 3


@dataclasses.dataclass(frozen=True)
class NewtonSolver:
    iterations: int = 3
    damping: float = 1.0


@dataclasses.dataclass(frozen=True)
class SecantSolver:
    iterations: int = 5
    perturbation: float = 1e-3


def newton_solve(residual: Callable, x0, iterations: int = 3,
                 derivative: Callable | None = None, damping: float = 1.0):
    """Batched Newton, x ← x − damping·r(x)/r'(x).  Without ``derivative``
    the slope is the forward-mode derivative with a ones tangent."""
    def deriv(x):
        if derivative is not None:
            return derivative(x)
        return torch.func.jvp(residual, (x,), (torch.ones_like(x),))[1]

    x = x0
    for _ in range(iterations):
        x = x - damping * residual(x) / deriv(x)
    return x


def secant_solve(residual: Callable, x0, x1=None, iterations: int = 5,
                 perturbation: float = 1e-3):
    """Batched secant with a fixed trip count; where the secant slope is
    zero the iterate stays put."""
    if x1 is None:
        x1 = x0 * (1.0 + perturbation)
    r0 = residual(x0)
    for _ in range(iterations):
        r1 = residual(x1)
        dr = r1 - r0
        nonzero = torch.abs(dr) > 0
        safe = torch.where(nonzero, dr, torch.ones_like(dr))
        x2 = torch.where(nonzero, x1 - r1 * (x1 - x0) / safe, x1)
        x0, r0, x1 = x1, r1, x2
    return x1


def solve(residual: Callable, x0, solver, derivative: Callable | None = None):
    """Dispatch on the solver config."""
    if isinstance(solver, NewtonSolver):
        return newton_solve(residual, x0, solver.iterations, derivative,
                            solver.damping)
    if isinstance(solver, SecantSolver):
        return secant_solve(residual, x0, iterations=solver.iterations,
                            perturbation=solver.perturbation)
    if isinstance(solver, FixedIterations):
        return newton_solve(residual, x0, solver.iterations, derivative)
    raise TypeError(f"unknown solver {solver!r}")
