"""Terrain-following σ-coordinates for the compressible core.

Port of ``breeze_tpu/dynamics/terrain.py`` on its Cartesian path: the
metrics (:class:`TerrainMetrics`, :func:`make_terrain`), the contravariant
vertical mass flux, the kinematic bottom, the slope-corrected pressure
gradients, the stage-entry slow tendencies of the split-explicit core over
terrain and the mountain-wave initial state.

Coordinate map (Gal-Chen/Somerville with linear decay):

    z(x, y, ζ) = ζ + h(x, y) · (1 − ζ/H),   ζ ∈ [0, H]

so the Jacobian J = ∂z/∂ζ = 1 − h/H is ζ-independent (a 2-D field) and the
slope ∂z/∂x|_ζ = ∂h/∂x · (1 − ζ/H).  SLEVE (Schär et al. 2002) splits h
into a smoothed large-scale part and the residual, each with its own sinh
decay, and J then depends on ζ.

The metrics are computed in float64 numpy, as the reference does, and then
moved to the grid's dtype and device.  The port's grids are Cartesian;
lat-lon terrain is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import fields as fl
from ..grid import Grid
from ..kernels.advection import div_rho_u_c
from ..kernels.momentum import momentum_div
from ..kernels.weno import H
from ..ops import StencilOps
from ..physics.coriolis import coriolis_terms
from ..thermo.constants import ThermodynamicConstants


@dataclasses.dataclass(frozen=True)
class TerrainMetrics:
    """Precomputed terrain metric fields (``breeze_tpu``'s).

    2-D fields are ``(ny, nx)``; profiles ``(nz,)``; the hydrostatic
    reference ``p_ref``, ``rho_ref`` is per column over the terrain.

    - **LinearDecay** (Gal-Chen): J = 1 − h/H, so ``jac_*`` are 2-D and
      the second-component fields are ``None``.
    - **TwoLevelDecay** (SLEVE): z = ζ + h₁b₁ + h₂b₂, so ``jac_*`` are 3-D
      and ``jac_cf`` holds J at ζ-faces; ``h_c``, ``sx_xf``, ``decay_*``
      hold the large-scale component and its basis, the ``*2`` fields the
      small-scale one.
    """

    height: float                        # domain top H
    h_c: torch.Tensor                    # surface elevation at centers (h₁ for SLEVE)
    jac_c: torch.Tensor                  # J at (ζ-centers, xy-centers): 2-D or 3-D
    jac_xf: torch.Tensor                 # J at x-faces (ζ-centers)
    jac_yf: torch.Tensor                 # J at y-faces (ζ-centers)
    sx_xf: torch.Tensor                  # ∂h/∂x at x-faces (∂h₁/∂x for SLEVE)
    sy_yf: torch.Tensor                  # ∂h/∂y at y-faces
    decay_c: torch.Tensor                # decay basis b(ζ) at ζ-centers (nz,)
    decay_f: torch.Tensor                # at the stored ζ-faces (nz,)
    z_true_c: torch.Tensor               # physical height of each cell (nz, ny, nx)
    p_ref: torch.Tensor                  # hydrostatic reference pressure (3-D)
    rho_ref: torch.Tensor                # hydrostatic reference density (3-D)
    h2_c: torch.Tensor | None = None     # SLEVE: small-scale terrain at centers
    sx2_xf: torch.Tensor | None = None   # SLEVE: ∂h₂/∂x at x-faces
    sy2_yf: torch.Tensor | None = None   # SLEVE: ∂h₂/∂y at y-faces
    basis2_c: torch.Tensor | None = None  # SLEVE: b₂(ζ) at ζ-centers
    basis2_f: torch.Tensor | None = None  # SLEVE: b₂(ζ) at ζ-faces
    jac_cf: torch.Tensor | None = None   # SLEVE: J at (ζ-faces, xy-centers)

    # broadcastable 3-D Jacobian views, shape (1|nz, ny, nx)
    @property
    def jac_c3(self):
        return self.jac_c[None] if self.jac_c.dim() == 2 else self.jac_c

    @property
    def jac_xf3(self):
        return self.jac_xf[None] if self.jac_xf.dim() == 2 else self.jac_xf

    @property
    def jac_yf3(self):
        return self.jac_yf[None] if self.jac_yf.dim() == 2 else self.jac_yf

    @property
    def jac_cf3(self):
        """J at ζ-faces; for LinearDecay J is ζ-independent: ``jac_c3``."""
        return self.jac_c3 if self.jac_cf is None else self.jac_cf

    @property
    def h_total(self):
        return self.h_c if self.h2_c is None else self.h_c + self.h2_c

    def slope_x(self, at_zface: bool):
        """∂z/∂x|_ζ at x-faces on ζ-face or ζ-center rows, ``(nz, ny, nx)``."""
        decay = self.decay_f if at_zface else self.decay_c
        s = decay[:, None, None] * self.sx_xf[None]
        if self.sx2_xf is not None:
            b2 = self.basis2_f if at_zface else self.basis2_c
            s = s + b2[:, None, None] * self.sx2_xf[None]
        return s

    def slope_y(self, at_zface: bool):
        decay = self.decay_f if at_zface else self.decay_c
        s = decay[:, None, None] * self.sy_yf[None]
        if self.sy2_yf is not None:
            b2 = self.basis2_f if at_zface else self.basis2_c
            s = s + b2[:, None, None] * self.sy2_yf[None]
        return s


def make_terrain(grid: Grid, constants: ThermodynamicConstants,
                 surface_elevation: Callable | np.ndarray,
                 potential_temperature=300.0,
                 surface_pressure: float = 101325.0,
                 p_standard: float = 1.0e5,
                 smoothing_passes: int = 0,
                 large_scale_height: float | None = None,
                 small_scale_height: float | None = None,
                 sleve_smoothing_passes: int = 20) -> TerrainMetrics:
    """The terrain metrics and the per-column hydrostatic reference.

    ``surface_elevation`` is a ``(ny, nx)`` array or a callable of numpy
    cell-center coordinates ``x`` ``(1, nx)`` and ``y`` ``(ny, 1)``;
    ``smoothing_passes`` diffuses it first.  Passing both
    ``large_scale_height`` (s₁) and ``small_scale_height`` (s₂) selects
    SLEVE: the large-scale part is h smoothed by ``sleve_smoothing_passes``
    passes, and each part decays as bₙ(ζ) = sinh((H−ζ)/sₙ)/sinh(H/sₙ).
    Otherwise the linear decay b(ζ) = 1 − ζ/H.  The reference column is the
    discrete hydrostatic balance solved by Newton's method on each column's
    true heights, from ``potential_temperature`` (a number or a callable of
    the true height).
    """
    if getattr(grid, "is_latlon", False):
        raise NotImplementedError("lat-lon terrain is not ported")
    ny, nx = grid.ny, grid.nx
    H_top = float(grid.Lz)

    if callable(surface_elevation):
        x = grid.x_c()[None, :]
        y = grid.y_c()[:, None]
        h = np.asarray(surface_elevation(x, y), np.float64) * np.ones((ny, nx))
    else:
        h = np.asarray(surface_elevation, np.float64)

    def smooth(a, passes):
        for _ in range(passes):
            a = 0.25 * (np.roll(a, 1, 1) + np.roll(a, -1, 1)
                        + np.roll(a, 1, 0) + np.roll(a, -1, 0))
        return a

    h = smooth(h, smoothing_passes)

    sleve = large_scale_height is not None or small_scale_height is not None
    if sleve and (large_scale_height is None or small_scale_height is None):
        raise ValueError("SLEVE needs both large_scale_height and small_scale_height")

    # the grid's heights as its dtype holds them, as the reference reads them
    zeta_c = grid.host(grid.z_c)
    zeta_f = grid.host(grid.z_f)[: grid.nz]

    def face_means_and_slopes(hh):
        h_xf = 0.5 * (hh + np.roll(hh, 1, axis=1))   # x-face i between i-1, i
        h_yf = 0.5 * (hh + np.roll(hh, 1, axis=0))
        sx = (hh - np.roll(hh, 1, axis=1)) / grid.dx
        sy = (hh - np.roll(hh, 1, axis=0)) / grid.dy
        return h_xf, h_yf, sx, sy

    h2 = sx2_xf = sy2_yf = basis2_c = basis2_f = jac_cf = None
    if sleve:
        s1, s2 = float(large_scale_height), float(small_scale_height)
        h1 = smooth(h, sleve_smoothing_passes)
        h2 = h - h1
        b = lambda zeta, s: np.sinh((H_top - zeta) / s) / np.sinh(H_top / s)
        db = lambda zeta, s: -np.cosh((H_top - zeta) / s) / (s * np.sinh(H_top / s))
        decay_c, decay_f = b(zeta_c, s1), b(zeta_f, s1)
        basis2_c, basis2_f = b(zeta_c, s2), b(zeta_f, s2)
        db1_c, db1_f = db(zeta_c, s1), db(zeta_f, s1)
        db2_c, db2_f = db(zeta_c, s2), db(zeta_f, s2)

        h1_xf, h1_yf, sx_xf, sy_yf = face_means_and_slopes(h1)
        h2_xf, h2_yf, sx2_xf, sy2_yf = face_means_and_slopes(h2)

        def jac3(h1_2d, h2_2d, db1, db2):
            return (1.0 + h1_2d[None] * db1[:, None, None]
                    + h2_2d[None] * db2[:, None, None])

        jac_c = jac3(h1, h2, db1_c, db2_c)
        jac_xf = jac3(h1_xf, h2_xf, db1_c, db2_c)
        jac_yf = jac3(h1_yf, h2_yf, db1_c, db2_c)
        jac_cf = jac3(h1, h2, db1_f, db2_f)
        jmin = min(jac_c.min(), jac_xf.min(), jac_yf.min(), jac_cf.min())
        if jmin <= 0.05:
            raise ValueError(
                f"SLEVE Jacobian min {jmin:.3f} ≤ 0.05: grid levels fold over the "
                "terrain; increase the decay scale heights")
        z_true_c = (zeta_c[:, None, None] + h1[None] * decay_c[:, None, None]
                    + h2[None] * basis2_c[:, None, None])
        h_for_metrics = h1
    else:
        jac_c = 1.0 - h / H_top
        h_xf, h_yf, sx_xf, sy_yf = face_means_and_slopes(h)
        jac_xf = 1.0 - h_xf / H_top
        jac_yf = 1.0 - h_yf / H_top
        decay_c = 1.0 - zeta_c / H_top
        decay_f = 1.0 - zeta_f / H_top
        z_true_c = zeta_c[:, None, None] + h[None] * decay_c[:, None, None]
        h_for_metrics = h

    # the discretely balanced dry hydrostatic reference on each column's
    # true heights, Newton on every column at once
    Rd = constants.Rd
    cpd = constants.dry_air.heat_capacity
    kappa = Rd / cpd
    g_acc = constants.gravitational_acceleration
    theta_fn = (potential_temperature if callable(potential_temperature)
                else (lambda z: float(potential_temperature) * np.ones_like(z)))

    nz = grid.nz
    p_ref = np.empty((nz, ny, nx))
    rho_ref = np.empty((nz, ny, nx))
    theta_lv = np.asarray(theta_fn(z_true_c), np.float64) * np.ones_like(z_true_c)

    # anchor at the lowest cell through the continuous Exner function
    Pi_surf = (surface_pressure / p_standard) ** kappa
    dz0 = z_true_c[0] - h
    Pi0 = Pi_surf - g_acc * dz0 / (cpd * theta_lv[0])
    p_ref[0] = p_standard * np.maximum(Pi0, 1e-10) ** (1.0 / kappa)
    rho_ref[0] = p_ref[0] ** (1.0 - kappa) * p_standard ** kappa / (Rd * theta_lv[0])

    for k in range(1, nz):
        dzf = z_true_c[k] - z_true_c[k - 1]
        th = theta_lv[k]

        def rho_of(pp):
            return pp ** (1.0 - kappa) * p_standard ** kappa / (Rd * th)

        Pi_prev = (p_ref[k - 1] / p_standard) ** kappa
        Pi_guess = Pi_prev - g_acc * dzf / (cpd * th)
        pp = p_standard * np.maximum(Pi_guess, 1e-10) ** (1.0 / kappa)
        for _ in range(25):
            F = (pp - p_ref[k - 1]) / dzf + g_acc * 0.5 * (rho_of(pp) + rho_ref[k - 1])
            dF = 1.0 / dzf + g_acc * 0.5 * (1.0 - kappa) * rho_of(pp) / pp
            pp = pp - F / dF
        p_ref[k] = pp
        rho_ref[k] = rho_of(pp)

    as_t = lambda a: None if a is None else torch.as_tensor(
        np.ascontiguousarray(a), dtype=grid.dtype, device=grid.device)
    return TerrainMetrics(
        height=H_top, h_c=as_t(h_for_metrics), jac_c=as_t(jac_c), jac_xf=as_t(jac_xf),
        jac_yf=as_t(jac_yf), sx_xf=as_t(sx_xf), sy_yf=as_t(sy_yf),
        decay_c=as_t(decay_c), decay_f=as_t(decay_f), z_true_c=as_t(z_true_c),
        p_ref=as_t(p_ref), rho_ref=as_t(rho_ref), h2_c=as_t(h2), sx2_xf=as_t(sx2_xf),
        sy2_yf=as_t(sy2_yf), basis2_c=as_t(basis2_c), basis2_f=as_t(basis2_f),
        jac_cf=as_t(jac_cf))


# ---------------------------------------------------------------------------
# Contravariant flux, kinematic bottom, slope-corrected pressure gradients
# ---------------------------------------------------------------------------

def contravariant_rho_w(terrain: TerrainMetrics, so: StencilOps,
                        rho_u_pad, rho_v_pad, rho_w):
    """ρw̃ = ρw − sx·ℑ(ρu) − sy·ℑ(ρv) at ζ-faces: the slope-weighted
    horizontal momenta as 4-point x/z and y/z averages at (center x,
    center y, ζ-face).  ``rho_u_pad``, ``rho_v_pad`` are padded as ``so``
    expects."""
    sx = terrain.slope_x(at_zface=True)
    sy = terrain.slope_y(at_zface=True)
    ru_czf = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                     + so.v(rho_u_pad, dz=-1) + so.v(rho_u_pad, dx=1, dz=-1))
    rv_czf = 0.25 * (so.v(rho_v_pad) + so.v(rho_v_pad, dy=1)
                     + so.v(rho_v_pad, dz=-1) + so.v(rho_v_pad, dy=1, dz=-1))
    sx_c = 0.5 * (sx + torch.roll(sx, -1, 2))     # x-face slope to x-centers
    sy_c = 0.5 * (sy + torch.roll(sy, -1, 1))
    return rho_w - sx_c * ru_czf - sy_c * rv_czf


def kinematic_bottom_rho_w(terrain: TerrainMetrics, rho_u, rho_v):
    """ρw on the surface face from impenetrability ρw̃ = 0:
    ρw|₀ = sx·ℑ(ρu)|₀ + sy·ℑ(ρv)|₀ with the slope at the bottom ζ-face."""
    sx0 = terrain.slope_x(at_zface=True)[0]
    sy0 = terrain.slope_y(at_zface=True)[0]
    sx_c0 = 0.5 * (sx0 + torch.roll(sx0, -1, 1))
    sy_c0 = 0.5 * (sy0 + torch.roll(sy0, -1, 0))
    ru0 = 0.5 * (rho_u[0] + torch.roll(rho_u[0], -1, 1))
    rv0 = 0.5 * (rho_v[0] + torch.roll(rho_v[0], -1, 0))
    return sx_c0 * ru0 + sy_c0 * rv0


def terrain_pressure_gradients(terrain: TerrainMetrics, so: StencilOps, p_pert_pad):
    """Slope-corrected horizontal pressure gradients,
    (∂p/∂x)_z = (∂p/∂x)_ζ − (∂z/∂x)_ζ ∂p/∂z, and ∂p/∂z at ζ-faces."""
    dpdx_zeta = so.dx_cf(p_pert_pad)                 # at x-faces
    dpdy_zeta = so.dy_cf(p_pert_pad)
    dpdz_true_f = so.dz_cf(p_pert_pad) / terrain.jac_cf3   # at ζ-faces
    # to ζ-centers (the top row duplicated), then to x- and y-faces
    dpdz_cc = 0.5 * (dpdz_true_f + torch.cat([dpdz_true_f[1:], dpdz_true_f[-1:]], 0))
    dpdz_xf = 0.5 * (dpdz_cc + torch.roll(dpdz_cc, 1, 2))
    dpdz_yf = 0.5 * (dpdz_cc + torch.roll(dpdz_cc, 1, 1))
    dpdx_true = dpdx_zeta - terrain.slope_x(at_zface=False) * dpdz_xf
    dpdy_true = dpdy_zeta - terrain.slope_y(at_zface=False) * dpdz_yf
    return dpdx_true, dpdy_true, dpdz_true_f


# ---------------------------------------------------------------------------
# Slow tendencies and the initial state over terrain
# ---------------------------------------------------------------------------

def terrain_slow_tendencies(model, terrain: TerrainMetrics, state, aux):
    """Stage-entry slow tendencies over terrain (``breeze_tpu``'s, for the
    split-explicit core): J-weighted flux-form advection with contravariant
    vertical transport, Coriolis, the frozen slope-corrected horizontal
    pressure gradient, and the vertical stage-entry imbalance
    −(1/J)∂ζ(p − p_ref) − g·ℑ(ρ − ρ_ref) against the terrain's 3-D
    hydrostatic reference.

    The WENO5 parts run the momentum and scalar kernels on the J-weighted
    mass fluxes, ρw̃ (row 0 zeroed) and, for θ, Jρ with the contravariant
    velocity w̃; the momenta are advected with the Cartesian w.  Closures
    and forcings over terrain are not ported (the model's envelope refuses
    them)."""
    from .compressible import SlowTendencies

    g = model.grid
    so = StencilOps(g, halo=1)
    g_acc = model.constants.gravitational_acceleration
    cols = model.z_columns
    inv_dx, inv_dy = float(1.0 / g.dx), float(1.0 / g.dy)
    p1 = lambda a, loc: fl.pad(a, g, loc, halo=1)
    pz = lambda a, loc: fl.pad(a, g, loc, halo=H, axes=(0, 1))

    jac_c3, jac_xf3, jac_yf3 = terrain.jac_c3, terrain.jac_xf3, terrain.jac_yf3
    inv_jac_c3 = 1.0 / jac_c3

    rho_u_pad = p1(state.rho_u, fl.CCF)
    rho_v_pad = p1(state.rho_v, fl.CFC)
    rho_w_tilde = contravariant_rho_w(terrain, so, rho_u_pad, rho_v_pad, state.rho_w)
    rho_w_tilde[0] = 0.0

    # reconstruction velocities: Cartesian horizontal, contravariant vertical
    rho_pad1 = p1(state.rho, fl.CCC)
    wt = rho_w_tilde / (0.5 * (so.v(rho_pad1) + so.v(rho_pad1, dz=-1)))
    pzu, pzv = pz(aux.u, fl.CCF), pz(aux.v, fl.CFC)

    jru = state.rho_u * jac_xf3
    jrv = state.rho_v * jac_yf3

    # mass: G_ρ = −(1/J)[δx(Jρu) + δy(Jρv) + δζ(ρw̃)]
    G_rho = -so.div_c(p1(jru, fl.CCF), p1(jrv, fl.CFC), p1(rho_w_tilde, fl.FCC)) * inv_jac_c3

    # ρθ in flux form with contravariant transport (the kernel returns −∇·)
    G_rho_theta = div_rho_u_c(
        pz(aux.theta, fl.CCC), pzu, pzv, pz(wt, fl.FCC), pz(state.rho * jac_c3, fl.CCC),
        cols.inv_dzc, inv_dx, inv_dy,
        bounds=model.scalar_advection.bounds_preserving) * inv_jac_c3

    # momentum advection with the J-weighted mass fluxes
    adv_u, adv_v, adv_w = momentum_div(
        pz(jru, fl.CCF), pz(jrv, fl.CFC), pz(rho_w_tilde, fl.FCC), pzu, pzv,
        pz(aux.w, fl.FCC), cols.inv_dzc, cols.inv_dzf, inv_dx, inv_dy)
    adv_u = adv_u / jac_xf3
    adv_v = adv_v / jac_yf3
    adv_w = adv_w * inv_jac_c3

    cor_x, cor_y, cor_z = coriolis_terms(model.coriolis, so, rho_u_pad, rho_v_pad,
                                         p1(state.rho_w, fl.FCC))

    # frozen slope-corrected horizontal PGF, vertical stage-entry imbalance
    dpdx, dpdy, dpdz_f = terrain_pressure_gradients(
        terrain, so, p1(aux.p - terrain.p_ref, fl.CCC))
    imbalance = -dpdz_f - g_acc * so.iz_cf(p1(state.rho - terrain.rho_ref, fl.CCC))

    return SlowTendencies(rho=G_rho, rho_u=-adv_u - cor_x - dpdx,
                          rho_v=-adv_v - cor_y - dpdy,
                          rho_w=-adv_w - cor_z + imbalance, rho_theta=G_rho_theta)


def terrain_initial_state(model, terrain: TerrainMetrics, theta=None, u=None):
    """The mountain-wave start: density from the terrain's 3-D reference
    (pressure-balanced against θ, ρ = ρ_ref θᵣ/θ), ρu from ``u``, ρv = 0
    and ρw = 0 but on the surface face, where the kinematic bottom sets it.
    ``theta`` and ``u`` are callables of ``(x, y, z)`` with z the TRUE
    height, or ``u`` a number."""
    from .compressible import CompressibleState

    g = model.grid
    x, y, _ = g.xyz_c()
    z_true = terrain.z_true_c
    ones = torch.ones(g.shape, dtype=g.dtype, device=g.device)
    theta_ref = model.reference.theta_col * ones
    theta_arr = theta_ref if theta is None else theta(x, y, z_true) * ones
    rho = terrain.rho_ref * theta_ref / theta_arr
    if callable(u):
        u_arr = u(x, y, z_true) * ones
    else:
        u_arr = torch.full(g.shape, 0.0 if u is None else float(u), dtype=g.dtype,
                           device=g.device)
    rho_u = 0.5 * (rho + torch.roll(rho, 1, 2)) * u_arr
    rho_v = torch.zeros_like(rho)
    rho_w = torch.zeros_like(rho)
    rho_w[0] = kinematic_bottom_rho_w(terrain, rho_u, rho_v)
    return CompressibleState(rho=rho, rho_u=rho_u, rho_v=rho_v, rho_w=rho_w,
                             rho_theta=rho * theta_arr)
