"""The anelastic model: state, configuration, diagnostics, stage update,
pressure projection.

Port of ``breeze_tpu/model.py`` on the anelastic paths the BOMEX case runs.
``compute_tendencies`` takes one of two routes, as the reference selects
them (``model.py:565-629``):

- **fused**, when the fused tendency kernel's envelope takes the model
  (Coriolis ``None`` or :class:`FPlane`): the tendency kernel emits the
  stage-blended prognostics, and the surface-flux extras are added as
  +αΔt·G;
- **unfused** otherwise (a :class:`BetaPlane`): the column-momentum, scalar
  and closure kernels, the whole-field Coriolis and buoyancy, the surface
  fluxes and the forcings' columns build G, and ``stage_update`` blends.

``pressure_projection`` runs the projection kernels around the Poisson
solve.  The model holds its tensors (reference columns, Poisson factors,
the kernels' columns), all on the grid's device.

Envelope (raises outside it): periodic x and y, bounded z, WENO5 (not
bounds-preserving) for momentum and scalars, Coriolis ``None``,
:class:`FPlane` or :class:`BetaPlane`, closure ``None`` or
:class:`SmagorinskyLilly`, microphysics ``None`` or
:class:`SaturationAdjustment`, prescribed surface fluxes, the BOMEX
forcings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from . import fields as fl
from .advection import WENO
from .dynamics.poisson import AnelasticPoissonSolver, build_anelastic_poisson_solver
from .grid import Grid, Topology
from .kernels import projection as kproj
from .kernels.advection import div_rho_u_c
from .kernels.closure import closure_tendencies as closure_kernel
from .kernels.momentum import momentum_div_cols
from .kernels.tendency import H, TendencyColumns, TendencyConfig, fused_tendency
from .ops import StencilOps
from .physics.closures import SmagorinskyLilly
from .physics.coriolis import BetaPlane, FPlane, coriolis_terms
from .physics.microphysics import SaturationAdjustment, saturation_adjust
from .physics.surface import apply_boundary_flux_tendencies
from .thermo.constants import MoistureMassFractions, ThermodynamicConstants
from .thermo.reference import ReferenceState, make_reference_state
from .thermo.states import temperature_from_theta_li


@dataclasses.dataclass(frozen=True)
class State:
    """Prognostic state: ρu, ρv, ρw on their faces, ρθ and (moist) ρqᵗ at
    centers.  ``diagnostics`` carries non-advected stepwise values, such as
    the saturation adjustment's warm-start temperature ``"T_warm"``."""

    rho_u: torch.Tensor
    rho_v: torch.Tensor
    rho_w: torch.Tensor
    rho_theta: torch.Tensor
    rho_qt: torch.Tensor | None
    time: float = 0.0
    diagnostics: dict = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


class Aux(NamedTuple):
    """Diagnostics recomputed from the prognostic state every stage."""

    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    theta: torch.Tensor
    qt: torch.Tensor | None
    T: torch.Tensor
    q: MoistureMassFractions
    buoyancy_force: torch.Tensor   # at cell centers, −g ρ′


@dataclasses.dataclass(frozen=True)
class AtmosphereModel:
    grid: Grid
    reference: ReferenceState
    solver: AnelasticPoissonSolver
    constants: ThermodynamicConstants
    advection: WENO
    microphysics: Any
    coriolis: Any
    closure: Any
    forcings: tuple
    boundary_fluxes: Any
    p_standard: float
    tendency_config: TendencyConfig
    tendency_columns: TendencyColumns
    fused: bool                      # the fused tendency kernel's route

    @property
    def has_moisture(self) -> bool:
        return self.microphysics is not None


def _pad_center_column(col: torch.Tensor, h: int) -> torch.Tensor:
    """z-pad a center column by ``h`` (even mirror about the walls)."""
    return fl.pad_axis(col, 0, h, Topology.BOUNDED, fl.C)


def _padded_face_column(col: torch.Tensor, nz: int, h: int) -> torch.Tensor:
    """z-pad a face column ``(nz+1,)`` by ``h``, mirrored about the wall
    faces 0 and nz, so that it times the odd-reflected w pad gives the
    odd-reflected ρw pad."""
    return torch.cat([col[1:h + 1].flip(0), col[:nz], col[nz:nz + 1],
                      col[nz - h + 1:nz].flip(0)])


def _tendency_columns(grid: Grid, ref: ReferenceState, closure) -> TendencyColumns:
    as_t = lambda a: torch.as_tensor(a, dtype=grid.dtype, device=grid.device)
    cols = dict(colc=_pad_center_column(ref.rho_c, H),
                colf=_padded_face_column(ref.rho_f, grid.nz, H),
                invdzc=1.0 / grid.dz_c, invdzf=1.0 / grid.dz_f[: grid.nz])
    if closure is not None:
        dz_c = np.asarray(grid.dz_c_meta, np.float64)
        dz_f = np.asarray(grid.dz_f_meta, np.float64)[: grid.nz]
        cd2 = (closure.coefficient * (grid.dx * grid.dy * dz_c) ** (1.0 / 3.0)) ** 2
        pad_col = lambda c: _pad_center_column(as_t(c), H)
        cols.update(invdzc_e=pad_col(1.0 / dz_c), invdzf_e=pad_col(1.0 / dz_f),
                    cd2_e=pad_col(cd2))
    return TendencyColumns(**cols)


def _weno5(scheme, bounds_ok: bool = False) -> bool:
    return (isinstance(scheme, WENO) and scheme.order == 5
            and (bounds_ok or not scheme.bounds_preserving))


def _periodic_xy(grid) -> bool:
    return grid.topologies() == (Topology.BOUNDED, Topology.PERIODIC, Topology.PERIODIC)


def fused_supported(grid, momentum_scheme, scalar_scheme, coriolis) -> bool:
    """The fused tendency kernel's envelope (the counterpart of
    ``breeze_tpu``'s ``tendency.supported`` without its TPU block sizes)."""
    return (_weno5(momentum_scheme) and _weno5(scalar_scheme, bounds_ok=True)
            and (coriolis is None or isinstance(coriolis, FPlane)) and _periodic_xy(grid))


def momentum_supported(grid, scheme) -> bool:
    """The column-momentum kernel's envelope (``momentum.supported``): no
    Coriolis condition, so a β-plane lands here."""
    return _weno5(scheme) and _periodic_xy(grid)


def scalar_supported(grid, scheme) -> bool:
    """The scalar kernel's envelope (``advection.supported``)."""
    return _weno5(scheme, bounds_ok=True) and _periodic_xy(grid)


def _check_envelope(grid, advection, microphysics, coriolis, closure):
    problems = []
    if not _periodic_xy(grid):
        problems.append("x and y must be periodic and z bounded")
    if not fused_supported(grid, advection, advection, coriolis) and not (
            momentum_supported(grid, advection) and scalar_supported(grid, advection)):
        # the whole-field momentum and scalar advection of other schemes
        # are not ported
        problems.append("advection must be WENO(5) without bounds preservation")
    if coriolis is not None and not isinstance(coriolis, (FPlane, BetaPlane)):
        problems.append("Coriolis must be None, FPlane or BetaPlane")
    if closure is not None and not isinstance(closure, SmagorinskyLilly):
        problems.append("the closure must be None or SmagorinskyLilly")
    if microphysics is not None and not isinstance(microphysics, SaturationAdjustment):
        problems.append("microphysics must be None or SaturationAdjustment")
    if problems:
        raise NotImplementedError("outside the ported envelope: " + "; ".join(problems))


def make_model(grid: Grid, advection: WENO,
               constants: ThermodynamicConstants | None = None,
               reference: ReferenceState | None = None, microphysics=None,
               coriolis=None, closure=None, forcings=(), boundary_fluxes=None,
               surface_pressure: float = 101325.0,
               potential_temperature: float = 288.0,
               p_standard: float = 1.0e5) -> AtmosphereModel:
    """Model factory: builds the reference state, the Poisson factors and
    the kernels' columns on the grid's device.  ``advection`` serves
    momentum and scalars alike."""
    _check_envelope(grid, advection, microphysics, coriolis, closure)
    constants = constants or ThermodynamicConstants()
    if reference is None:
        reference = make_reference_state(
            grid, constants, surface_pressure=surface_pressure,
            potential_temperature=potential_temperature)
    g_acc = constants.gravitational_acceleration
    cfg = TendencyConfig(
        inv_dx=float(1.0 / grid.dx), inv_dy=float(1.0 / grid.dy),
        f_cor=float(coriolis.f) if isinstance(coriolis, FPlane) else None,
        closure=None if closure is None else (
            float(closure.prandtl), bool(closure.buoyancy_correction), float(g_acc)))
    return AtmosphereModel(
        grid=grid, reference=reference,
        solver=build_anelastic_poisson_solver(grid, reference.rho_c, reference.rho_f),
        constants=constants, advection=advection, microphysics=microphysics,
        coriolis=coriolis, closure=closure, forcings=tuple(forcings),
        boundary_fluxes=boundary_fluxes, p_standard=p_standard,
        tendency_config=cfg,
        tendency_columns=_tendency_columns(grid, reference, closure),
        fused=fused_supported(grid, advection, advection, coriolis))


def initial_state(model: AtmosphereModel, u=None, v=None, w=None, theta=None,
                  qt=None) -> State:
    """A :class:`State` from specific fields (θ, qᵗ, velocities), converted
    against the reference density.  Unset θ is the reference θ; unset
    velocities are at rest.  When any velocity is given, the momenta are
    projected once onto the anelastic constraint."""
    g = model.grid
    ref = model.reference
    rho_c, rho_f = ref.rho_col, ref.rho_f_col
    rho_theta = fl.full(g, theta, ref.potential_temperature) * rho_c
    rho_qt = fl.full(g, qt, 0.0) * rho_c if model.has_moisture else None
    rho_u, rho_v, rho_w = fl.enforce_wall_normals(
        g, fl.full(g, u, 0.0) * rho_c, fl.full(g, v, 0.0) * rho_c,
        fl.full(g, w, 0.0) * rho_f)
    if any(val is not None for val in (u, v, w)):
        rho_u, rho_v, rho_w, _ = pressure_projection(model, rho_u, rho_v, rho_w, 1.0)
    state = State(rho_u=rho_u, rho_v=rho_v, rho_w=rho_w,
                  rho_theta=rho_theta, rho_qt=rho_qt)
    if isinstance(model.microphysics, SaturationAdjustment):
        # warm start of the first step's saturation adjustment
        state = state.replace(diagnostics={"T_warm": diagnose(model, state).T})
    return state


def diagnose(model: AtmosphereModel, state: State, T_guess=None) -> Aux:
    """Velocities, θ, the saturation-adjusted T and moisture partition, and
    the perturbation buoyancy −gρᵣ(RᵐᵣTᵣ/(RᵐT) − 1) from the state.
    ``T_guess`` warm-starts the saturation adjustment."""
    ref = model.reference
    c = model.constants
    rho_c = ref.rho_col
    p_r = ref.p_col
    u = state.rho_u / rho_c
    v = state.rho_v / rho_c
    w = state.rho_w / ref.rho_f_col
    theta = state.rho_theta / rho_c
    if model.has_moisture:
        qt = state.rho_qt / rho_c
        T, q = saturation_adjust(theta, qt, p_r, c, model.microphysics,
                                 model.p_standard, T_guess=T_guess)
    else:
        qt = None
        zero = torch.zeros_like(theta)
        q = MoistureMassFractions(zero, zero, zero)
        T = temperature_from_theta_li(theta, q, p_r, c, model.p_standard)
    Rm_ref = c.mixture_gas_constant(ref.moisture_fractions_col())
    Rm = c.mixture_gas_constant(q)
    buoyancy_force = (-c.gravitational_acceleration * rho_c
                      * (Rm_ref * ref.T_col / (Rm * T) - 1.0))
    return Aux(u=u, v=v, w=w, theta=theta, qt=qt, T=T, q=q,
               buoyancy_force=buoyancy_force)


def _prognostic_names(model: AtmosphereModel) -> list[str]:
    names = ["rho_u", "rho_v", "rho_w", "rho_theta"]
    return names + ["rho_qt"] if model.has_moisture else names


def _forcing_columns(model: AtmosphereModel, state: State, aux: Aux):
    """Sum the forcings' ``column_parts`` into per-output ``(nz,)`` add and
    damp columns (``None`` where no forcing acts)."""
    names = _prognostic_names(model)
    adds = [None] * len(names)
    damps = [None] * len(names)
    nz = model.grid.nz
    flat = lambda c: torch.broadcast_to(c, (nz, 1, 1)).reshape(nz).contiguous()
    for forcing in model.forcings:
        for name, (add, damp) in forcing.column_parts(model, state, aux).items():
            if name not in names:
                raise ValueError(f"forcing on {name!r}, which the model does not carry")
            n = names.index(name)
            if add is not None:
                adds[n] = add if adds[n] is None else adds[n] + add
            if damp is not None:
                damps[n] = damp if damps[n] is None else damps[n] + damp
    return ([None if a is None else flat(a) for a in adds],
            [None if d is None else flat(d) for d in damps])


def _pad_zy(model: AtmosphereModel, a: torch.Tensor, loc) -> torch.Tensor:
    """A kernel's window: ``a`` padded by H rows in z and y."""
    return fl.pad(a, model.grid, loc, halo=H, axes=(0, 1))


def _windows(model: AtmosphereModel, aux: Aux) -> tuple:
    """The kernels' velocity and scalar windows ``(u, v, w, scalars, thb)``:
    ``scalars`` θ and (moist) qᵗ, ``thb`` θᵥ for Lilly's correction when
    the model is moist, θ's window otherwise."""
    pz = lambda a, loc: _pad_zy(model, a, loc)
    scalars = [pz(aux.theta, fl.CCC)]
    if model.has_moisture:
        scalars.append(pz(aux.qt, fl.CCC))
    thb = scalars[0]
    if (model.closure is not None and model.closure.buoyancy_correction
            and model.has_moisture):
        c = model.constants
        delta_rv = c.Rv / c.Rd - 1.0
        thb = pz(aux.theta * (1.0 + delta_rv * aux.q.vapor - aux.q.liquid
                              - aux.q.ice), fl.CCC)
    return pz(aux.u, fl.CCF), pz(aux.v, fl.CFC), pz(aux.w, fl.FCC), scalars, thb


def tendency_kernel_args(model: AtmosphereModel, state: State, aux: Aux,
                         dt: float, state0: State, alpha: float) -> tuple:
    """The arguments of :func:`~.kernels.tendency.fused_tendency` for one
    stage: the padded windows, the forcing columns and the prognostics."""
    u, v, w, scalars, thb = _windows(model, aux)
    fadd, fdamp = _forcing_columns(model, state, aux)
    names = _prognostic_names(model)
    return (model.tendency_config, model.tendency_columns, u, v, w, scalars,
            _pad_zy(model, aux.buoyancy_force, fl.CCC), thb, fadd, fdamp,
            [getattr(state, n) for n in names],
            [getattr(state0, n) for n in names], alpha, dt)


def compute_tendencies(model: AtmosphereModel, state: State, aux: Aux,
                       dt: float, state0: State, alpha: float) -> tuple[State, bool]:
    """``(result, blended)``.  On the fused route ``result`` is the blended
    prognostics (1−α)s⁰ + α(s + Δt·G), with the surface-flux tendencies
    added on top as +αΔt·G, and ``blended`` is true; on the unfused route
    ``result`` is the tendency G and ``stage_update`` blends."""
    if not model.fused:
        return _unfused_tendencies(model, state, aux), False
    args = tendency_kernel_args(model, state, aux, dt, state0, alpha)
    new = dict(zip(_prognostic_names(model), fused_tendency(*args)))
    if model.boundary_fluxes is not None:
        apply_boundary_flux_tendencies(model, aux, new, alpha * dt)
    return state.replace(**new), True


def _unfused_tendencies(model: AtmosphereModel, state: State, aux: Aux) -> State:
    """G outside the fused tendency kernel (``breeze_tpu``'s unfused branch,
    ``model.py:745-819``, and the closure, surface fluxes and forcings after
    it): the column-momentum kernel, the whole-field Coriolis and buoyancy,
    θ and qᵗ through the scalar kernel against the broadcast ρᵣ window, the
    closure kernel, the surface fluxes and the forcings' columns."""
    g = model.grid
    cfg, cols = model.tendency_config, model.tendency_columns
    so = StencilOps(g, halo=1)
    p1 = lambda a, loc: fl.pad(a, g, loc, halo=1)
    pzu, pzv, pzw, scalars, thb = _windows(model, aux)
    adv_u, adv_v, adv_w = momentum_div_cols(pzu, pzv, pzw, cols.colc, cols.colf,
                                            cols.invdzc, cols.invdzf, cfg.inv_dx, cfg.inv_dy)
    # ρu = ρᵣ(z)·u on halo-1 pads for the Coriolis terms
    ref = model.reference
    rho_c_pad = _pad_center_column(ref.rho_c, 1)[:, None, None]
    rho_f_pad = _padded_face_column(ref.rho_f, g.nz, 1)[:, None, None]
    u_pad, v_pad, w_pad = p1(aux.u, fl.CCF), p1(aux.v, fl.CFC), p1(aux.w, fl.FCC)
    cor_x, cor_y, cor_z = coriolis_terms(model.coriolis, so, u_pad * rho_c_pad,
                                         v_pad * rho_c_pad, w_pad * rho_f_pad, g)
    G = {"rho_u": -adv_u - cor_x, "rho_v": -adv_v - cor_y,
         # buoyancy interpolated center → z-face
         "rho_w": -adv_w - cor_z + so.iz_cf(p1(aux.buoyancy_force, fl.CCC))}

    # θ and qᵗ advected as specific quantities against the broadcast ρᵣ
    rho_r = _pad_zy(model, ref.rho_col.expand(g.shape).contiguous(), fl.CCC)
    names = _prognostic_names(model)
    for name, c in zip(names[3:], scalars):
        G[name] = div_rho_u_c(c, pzu, pzv, pzw, rho_r, cols.invdzc, cfg.inv_dx, cfg.inv_dy)

    if model.closure is not None:
        for name, gc in zip(names, closure_kernel(cfg, cols, pzu, pzv, pzw, thb, scalars)):
            G[name] = G[name] + gc
    if model.boundary_fluxes is not None:
        apply_boundary_flux_tendencies(model, aux, G, 1.0)
    # the forcings: G += add(z) − damp(z)·state
    col = lambda c: c[:, None, None]
    for name, add, damp in zip(names, *_forcing_columns(model, state, aux)):
        if add is not None:
            G[name] = G[name] + col(add)
        if damp is not None:
            G[name] = G[name] - col(damp) * getattr(state, name)
    return State(**{"rho_qt": None, **G})


def stage_update(model: AtmosphereModel, state: State, state0: State, dt: float,
                 alpha: float, aux: Aux | None = None) -> State:
    """One SSP-RK3 stage blend (before the projection): every prognostic at
    (1−α)s⁰ + α(s + Δt·G), inside the tendency kernel on the fused route,
    here otherwise."""
    if aux is None:
        aux = diagnose(model, state)
    res, blended = compute_tendencies(model, state, aux, dt, state0, alpha)
    if blended:
        return res
    blend = lambda s, s0, gg: (1.0 - alpha) * s0 + alpha * (s + dt * gg)
    return state.replace(**{n: blend(getattr(state, n), getattr(state0, n), getattr(res, n))
                            for n in _prognostic_names(model)})


def pressure_projection(model: AtmosphereModel, rho_u, rho_v, rho_w, dt: float):
    """Project the momenta onto ∇·(ρᵣu) = 0: solve ∇·(ρᵣ∇φ) = ∇·(ρũ)/Δt,
    then ρu ← ρu − Δt ρᵣ ∇φ with ρᵣ at each component's location.  The
    divergence and the correction (which pins the bottom face of ρw) are
    the projection kernels.  Returns ``(rho_u, rho_v, rho_w, phi)``."""
    g = model.grid
    cfg, cols, ref = model.tendency_config, model.tendency_columns, model.reference
    rho_u, rho_v, rho_w = fl.enforce_wall_normals(g, rho_u, rho_v, rho_w)
    div = kproj.divergence(rho_u, rho_v, rho_w, cols.invdzc, cfg.inv_dx, cfg.inv_dy)
    phi = model.solver.solve(div, dt)
    return (*kproj.gradient_correct(phi, rho_u, rho_v, rho_w, ref.rho_c, ref.rho_f[: g.nz],
                                    cols.invdzf, cfg.inv_dx, cfg.inv_dy, dt), phi)
