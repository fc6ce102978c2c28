"""Batched tridiagonal (Thomas) solve along z.

Port of ``breeze_tpu/dynamics/tridiagonal.py::thomas_solve``: the plain
column solve of the acoustic substep loop (``kernels/acoustic.py``), a
Python loop over levels vectorized across every (y, x) column.
"""

from __future__ import annotations

import torch


def thomas_solve(lower, diag, upper, rhs):
    """Solve tridiagonal systems along axis 0.

    ``lower[k]`` couples row k to k−1 (``lower[0]`` ignored), ``upper[k]``
    couples row k to k+1 (``upper[-1]`` ignored).  Coefficients broadcast
    against ``rhs``; trailing axes are batch dimensions.
    """
    n = rhs.shape[0]
    lower, diag, upper = (torch.broadcast_to(c, rhs.shape) for c in (lower, diag, upper))
    c_prime = torch.empty_like(rhs)
    d_prime = torch.empty_like(rhs)
    c_prev = d_prev = torch.zeros_like(rhs[0])
    for k in range(n):
        inv = 1.0 / (diag[k] - lower[k] * c_prev)
        c_prev = c_prime[k] = upper[k] * inv
        d_prev = d_prime[k] = (rhs[k] - lower[k] * d_prev) * inv
    x = torch.empty_like(rhs)
    x[n - 1] = d_prime[n - 1]
    for k in range(n - 2, -1, -1):
        x[k] = d_prime[k] - c_prime[k] * x[k + 1]
    return x
