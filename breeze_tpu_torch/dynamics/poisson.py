"""Fourier-tridiagonal Poisson solver for the anelastic pressure projection.

Port of ``breeze_tpu/dynamics/poisson.py`` on its ``transform="fourier"``,
``vertical_solve="scan"`` path.  For each horizontal Fourier mode with
eigenvalue λ ≥ 0 it solves

    ρ̄ᶠ[k+1](φ[k+1] − φ[k])/Δzᶠ[k+1] − ρ̄ᶠ[k](φ[k] − φ[k−1])/Δzᶠ[k]
  − ρᶜ[k] Δzᶜ[k] λ φ[k]  =  Δzᶜ[k] δ̂[k] / Δt

with homogeneous Neumann ends.  The Thomas factors depend only on the
reference state and the grid: they are computed once in float64 on the host
and stored in the grid dtype.  The singular (0,0) mode is pinned by
replacing its top-level row with φ = 0 (a zero pivot reciprocal there).

The transforms are ``torch.fft.rfft2``/``irfft2``; the Thomas sweep is a
Python loop over z (2·nz small launches per solve on a GPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..grid import Grid, Topology


def _periodic_eigenvalues(n: int, delta: float, rfft: bool) -> np.ndarray:
    """λ[m] = (2 sin(π m / n) / Δ)², the eigenvalues of −∂² (periodic)."""
    m = np.arange(n // 2 + 1 if rfft else n)
    return (2.0 * np.sin(np.pi * m / n) / delta) ** 2


@dataclasses.dataclass(frozen=True)
class AnelasticPoissonSolver:
    lower: torch.Tensor       # (nz, 1, 1) sub-diagonal coupling ρ̄ᶠ[k]/Δzᶠ[k]
    c_prime: torch.Tensor     # (nz, ny, nxr) Thomas upper factors
    inv_den: torch.Tensor     # (nz, ny, nxr) Thomas pivot reciprocals
    dz_c: torch.Tensor        # (nz, 1, 1) cell heights

    def solve(self, divergence: torch.Tensor, dt) -> torch.Tensor:
        """φ for δ = ∇·(ρũ) (interior shape) over the projection step dt."""
        rhs = divergence * self.dz_c
        rhs_hat = torch.fft.rfft2(rhs, dim=(1, 2)) / dt
        x = fourier_tridiagonal_scan(rhs_hat, self.lower, self.inv_den,
                                     self.c_prime)
        return torch.fft.irfft2(x, s=divergence.shape[1:], dim=(1, 2))


def fourier_tridiagonal_scan(rhs_hat, lower, inv_den, c_prime):
    """Per-mode Thomas solve over z.  The (0,0) mode's top row is pinned to
    φ = 0 by its zero ``inv_den`` entry (compatibility makes the dropped
    equation redundant)."""
    nz = rhs_hat.shape[0]
    d = torch.empty_like(rhs_hat)
    d_prev = torch.zeros_like(rhs_hat[0])
    for k in range(nz):
        d_prev = (rhs_hat[k] - lower[k] * d_prev) * inv_den[k]
        d[k] = d_prev
    x = torch.empty_like(d)
    x[nz - 1] = d[nz - 1]
    for k in range(nz - 2, -1, -1):
        x[k] = d[k] - c_prime[k] * x[k + 1]
    return x


def build_anelastic_poisson_solver(grid: Grid, rho_c, rho_f) -> AnelasticPoissonSolver:
    """Thomas factors for the ρᵣ-weighted Fourier-tridiagonal solve.

    ``rho_c``: reference density at centers ``(nz,)``; ``rho_f``: at faces
    ``(nz+1,)``.  Periodic horizontal axes only.
    """
    if Topology.BOUNDED in (grid.x_topology, grid.y_topology):
        raise NotImplementedError(
            "bounded horizontal axes need the real eigenbasis transform, "
            "which is not ported yet")
    nz, ny, nx = grid.shape
    nxr = nx // 2 + 1
    lam = (_periodic_eigenvalues(ny, grid.dy, rfft=False)[:, None]
           + _periodic_eigenvalues(nx, grid.dx, rfft=True)[None, :])  # (ny, nxr)

    rho_c = grid.host(rho_c)
    rho_f = grid.host(rho_f)
    dz_c = grid.host(grid.dz_c)
    dz_f = grid.host(grid.dz_f)

    # a[k] = ρᶠ[k]/Δzᶠ[k] couples (k-1, k); the wall couplings are dropped
    a = rho_f / dz_f
    lower = np.zeros(nz)
    upper = np.zeros((nz, ny, nxr))
    diag = np.zeros((nz, ny, nxr))
    for k in range(nz):
        lo = a[k] if k > 0 else 0.0
        up = a[k + 1] if k < nz - 1 else 0.0
        lower[k] = lo
        upper[k] = up
        diag[k] = -(lo + up) - rho_c[k] * dz_c[k] * lam

    # pin the (0,0) mode at the top level to φ = 0: row nz-2 drops its (then
    # identically zero) coupling to it, and a zero pivot reciprocal on the
    # top row makes the forward sweep write 0 there whatever it carries
    upper[nz - 2, 0, 0] = 0.0

    c_prime = np.zeros_like(diag)
    inv_den = np.zeros_like(diag)
    inv_den[0] = 1.0 / diag[0]
    c_prime[0] = upper[0] * inv_den[0]
    for k in range(1, nz):
        inv_den[k] = 1.0 / (diag[k] - lower[k] * c_prime[k - 1])
        c_prime[k] = upper[k] * inv_den[k]
    inv_den[nz - 1, 0, 0] = 0.0

    as_t = lambda arr: torch.as_tensor(arr, dtype=grid.dtype, device=grid.device)
    return AnelasticPoissonSolver(
        lower=as_t(lower)[:, None, None], c_prime=as_t(c_prime),
        inv_den=as_t(inv_den), dz_c=as_t(dz_c)[:, None, None])
