"""The port's Fourier-tridiagonal Poisson solver and pressure projection in
float64: against ``breeze_tpu``'s solver on its CPU path (rfft + Thomas
scan), a manufactured solution, the (0,0)-mode pin, and the projection's
contracts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breeze_tpu as bz
from breeze_tpu.dynamics.poisson import build_anelastic_poisson_solver as jax_solver
from breeze_tpu.model import make_model as jax_make_model
from breeze_tpu.model import pressure_projection as jax_projection
import breeze_tpu_torch as bt
from breeze_tpu_torch import fields as fl
from breeze_tpu_torch.dynamics.poisson import build_anelastic_poisson_solver
from breeze_tpu_torch.model import pressure_projection
from breeze_tpu_torch.ops import StencilOps

F64 = torch.float64
SIZE = (16, 12, 20)
STRETCHED_Z = np.concatenate([[0.0], np.cumsum(0.03 * 1.05 ** np.arange(20))])


def _grids(z=(0.0, 1.0)):
    kw = dict(x=(0.0, 2.0), y=(0.0, 1.5), z=z)
    jg = bz.make_grid(size=SIZE, topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                      dtype=jnp.float64, **kw)
    tg = bt.make_grid(SIZE, dtype=F64, device="cpu", **kw)
    return jg, tg


def _density(tg):
    z_c, z_f = tg.host(tg.z_c), tg.host(tg.z_f)
    return np.exp(-z_c), np.exp(-z_f)


def apply_operator(tg, rho_c, rho_f, phi):
    """∇·(ρᵣ∇φ) with the discretization the solver inverts (Neumann walls)."""
    dz_c, dz_f = tg.host(tg.dz_c), tg.host(tg.dz_f)
    nz = tg.nz
    lap_h = ((np.roll(phi, -1, 2) - 2 * phi + np.roll(phi, 1, 2)) / tg.dx ** 2
             + (np.roll(phi, -1, 1) - 2 * phi + np.roll(phi, 1, 1)) / tg.dy ** 2)
    grad_f = np.zeros((nz + 1,) + phi.shape[1:])
    grad_f[1:nz] = (phi[1:] - phi[:-1]) / dz_f[1:nz, None, None]
    flux = rho_f[:, None, None] * grad_f
    return rho_c[:, None, None] * lap_h + (flux[1:] - flux[:-1]) / dz_c[:, None, None]


@pytest.mark.parametrize("z", [(0.0, 1.0), STRETCHED_Z], ids=["uniform", "stretched"])
def test_solve_matches_jax(z):
    jg, tg = _grids(z)
    rho_c, rho_f = _density(tg)
    div = np.random.default_rng(0).standard_normal(tg.shape)
    ref = jax_solver(jg, rho_c, rho_f, use_matmul_dft=False, transform="fourier",
                     vertical_solve="scan").solve(jnp.asarray(div), 0.7)
    got = build_anelastic_poisson_solver(tg, torch.from_numpy(rho_c),
                                         torch.from_numpy(rho_f)).solve(
        torch.from_numpy(div), 0.7)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-10


@pytest.mark.parametrize("z", [(0.0, 1.0), STRETCHED_Z], ids=["uniform", "stretched"])
def test_recovers_manufactured_solution(z):
    _, tg = _grids(z)
    rho_c, rho_f = _density(tg)
    x = (np.arange(tg.nx) + 0.5) * tg.dx
    y = (np.arange(tg.ny) + 0.5) * tg.dy
    zc = tg.host(tg.z_c)
    phi = (np.cos(np.pi * zc)[:, None, None]
           * np.cos(2 * np.pi * x / tg.Lx)[None, None, :]
           + 0.3 * np.sin(2 * np.pi * y / tg.Ly)[None, :, None] * zc[:, None, None] ** 2)
    dt = 0.5
    rhs = apply_operator(tg, rho_c, rho_f, phi) * dt
    solver = build_anelastic_poisson_solver(tg, torch.from_numpy(rho_c),
                                            torch.from_numpy(rho_f))
    got = solver.solve(torch.from_numpy(rhs), dt).numpy()
    # φ is defined up to a constant: compare after removing the means
    got, phi = got - got.mean(), phi - phi.mean()
    assert np.abs(got - phi).max() < 1e-9


def test_zero_mode_pin():
    """The singular (0,0) mode is pinned by φ = 0 on its top row: the top
    level's horizontal mean vanishes, and a horizontally uniform (0,0)-only
    right-hand side gives a horizontally uniform φ that solves the column
    equation."""
    _, tg = _grids()
    rho_c, rho_f = _density(tg)
    solver = build_anelastic_poisson_solver(tg, torch.from_numpy(rho_c),
                                            torch.from_numpy(rho_f))
    div = torch.from_numpy(np.random.default_rng(1).standard_normal(tg.shape))
    div = div - div.mean()        # compatible: zero volume integral
    phi = solver.solve(div, 1.0)
    assert abs(float(phi[-1].mean())) < 1e-12
    column = torch.cos(np.pi * tg.z_c)[:, None, None].expand(tg.shape)
    dz = tg.dz_c[:, None, None]
    column = column - (column * dz).sum() / (dz.sum() * tg.nx * tg.ny)
    phi = solver.solve(column.contiguous(), 1.0).numpy()
    assert np.abs(phi - phi[:, :1, :1]).max() < 1e-12
    assert abs(phi[-1].mean()) < 1e-12
    resid = apply_operator(tg, rho_c, rho_f, phi) - column.numpy()
    assert np.abs(resid[:-1]).max() < 1e-9   # the pinned top row is replaced


def _projection_case():
    jg, tg = _grids(STRETCHED_Z)
    jm = jax_make_model(jg, potential_temperature=300.0)
    tm = bt.make_model(tg, advection=bt.WENO(5), potential_temperature=300.0)
    rng = np.random.default_rng(2)
    fields = [rng.standard_normal(tg.shape) for _ in range(3)]
    return jm, tm, fields


def test_projection_matches_jax_and_kills_divergence():
    jm, tm, fields = _projection_case()
    ref = jax_projection(jm, *(jnp.asarray(f) for f in fields), 0.4)
    got = pressure_projection(tm, *(torch.from_numpy(f) for f in fields), 0.4)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() / np.abs(r).max() < 1e-11
    g = tm.grid
    so = StencilOps(g, halo=1)
    div = so.div_c(fl.pad(got[0], g, fl.CCF, halo=1), fl.pad(got[1], g, fl.CFC, halo=1),
                   fl.pad(got[2], g, fl.FCC, halo=1))
    assert float(div.abs().max()) < 1e-10


def test_projection_idempotent():
    _, tm, fields = _projection_case()
    once = pressure_projection(tm, *(torch.from_numpy(f) for f in fields), 1.0)
    twice = pressure_projection(tm, *once[:3], 1.0)
    for a, b in zip(once[:3], twice[:3]):
        assert float((a - b).abs().max()) < 1e-11
