"""The anelastic model: state, configuration, diagnostics, stage update,
pressure projection.

Port of ``breeze_tpu/model.py`` on the path the BOMEX case runs: the fused
tendency branch of ``compute_tendencies`` with its substep epilogue, plus
the surface-flux extras added as +αΔt·G on top of the kernel's output.
The model holds its tensors (reference columns, Poisson factors, the
tendency kernel's columns), all on the grid's device.

Envelope (raises outside it): periodic x and y, bounded z, WENO5 (not
bounds-preserving) for momentum and scalars, Coriolis ``None`` or
:class:`FPlane`, closure ``None`` or :class:`SmagorinskyLilly`,
microphysics ``None`` or :class:`SaturationAdjustment`, prescribed surface
fluxes, column-linear forcings.
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
from .kernels.tendency import H, TendencyColumns, TendencyConfig, fused_tendency
from .ops import StencilOps
from .physics.closures import SmagorinskyLilly
from .physics.coriolis import FPlane
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


def _check_envelope(grid, advection, microphysics, coriolis, closure):
    problems = []
    if grid.topologies() != (Topology.BOUNDED, Topology.PERIODIC, Topology.PERIODIC):
        problems.append("x and y must be periodic and z bounded")
    if not (isinstance(advection, WENO) and advection.order == 5
            and not advection.bounds_preserving):
        problems.append("advection must be WENO(5) without bounds preservation")
    if coriolis is not None and not isinstance(coriolis, FPlane):
        problems.append("Coriolis must be None or FPlane")
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
    the tendency kernel's columns on the grid's device.  ``advection``
    serves momentum and scalars alike."""
    _check_envelope(grid, advection, microphysics, coriolis, closure)
    constants = constants or ThermodynamicConstants()
    if reference is None:
        reference = make_reference_state(
            grid, constants, surface_pressure=surface_pressure,
            potential_temperature=potential_temperature)
    g_acc = constants.gravitational_acceleration
    cfg = TendencyConfig(
        inv_dx=float(1.0 / grid.dx), inv_dy=float(1.0 / grid.dy),
        f_cor=None if coriolis is None else float(coriolis.f),
        closure=None if closure is None else (
            float(closure.prandtl), bool(closure.buoyancy_correction), float(g_acc)))
    return AtmosphereModel(
        grid=grid, reference=reference,
        solver=build_anelastic_poisson_solver(grid, reference.rho_c, reference.rho_f),
        constants=constants, advection=advection, microphysics=microphysics,
        coriolis=coriolis, closure=closure, forcings=tuple(forcings),
        boundary_fluxes=boundary_fluxes, p_standard=p_standard,
        tendency_config=cfg,
        tendency_columns=_tendency_columns(grid, reference, closure))


def _field(grid: Grid, val, default):
    """A full field from ``None`` (``default``), a callable of the cell
    centers ``(x, y, z)``, or anything broadcastable."""
    if val is None:
        val = default
    elif callable(val):
        val = val(*grid.xyz_c())
    t = torch.as_tensor(val, dtype=grid.dtype, device=grid.device)
    return t.expand(grid.shape).contiguous()


def initial_state(model: AtmosphereModel, u=None, v=None, w=None, theta=None,
                  qt=None) -> State:
    """A :class:`State` from specific fields (θ, qᵗ, velocities), converted
    against the reference density.  Unset θ is the reference θ; unset
    velocities are at rest.  When any velocity is given, the momenta are
    projected once onto the anelastic constraint."""
    g = model.grid
    ref = model.reference
    rho_c, rho_f = ref.rho_col, ref.rho_f_col
    rho_theta = _field(g, theta, ref.potential_temperature) * rho_c
    rho_qt = _field(g, qt, 0.0) * rho_c if model.has_moisture else None
    rho_u, rho_v, rho_w = fl.enforce_wall_normals(
        g, _field(g, u, 0.0) * rho_c, _field(g, v, 0.0) * rho_c,
        _field(g, w, 0.0) * rho_f)
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


def tendency_kernel_args(model: AtmosphereModel, state: State, aux: Aux,
                         dt: float, state0: State, alpha: float) -> tuple:
    """The arguments of :func:`~.kernels.tendency.fused_tendency` for one
    stage: the padded windows, the forcing columns and the prognostics."""
    g = model.grid
    pz = lambda a, loc: fl.pad(a, g, loc, halo=H, axes=(0, 1))
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
    fadd, fdamp = _forcing_columns(model, state, aux)
    names = _prognostic_names(model)
    return (model.tendency_config, model.tendency_columns,
            pz(aux.u, fl.CCF), pz(aux.v, fl.CFC), pz(aux.w, fl.FCC),
            scalars, pz(aux.buoyancy_force, fl.CCC), thb, fadd, fdamp,
            [getattr(state, n) for n in names],
            [getattr(state0, n) for n in names], alpha, dt)


def compute_tendencies(model: AtmosphereModel, state: State, aux: Aux,
                       dt: float, state0: State, alpha: float) -> State:
    """The fused branch of ``breeze_tpu``'s ``compute_tendencies``: the
    tendency kernel emits the blended prognostics (1−α)s⁰ + α(s + Δt·G)
    (advection, Coriolis, buoyancy, closure and forcings in G), and the
    surface-flux tendencies are added on top as +αΔt·G."""
    outs = fused_tendency(*tendency_kernel_args(model, state, aux, dt, state0, alpha))
    new = dict(zip(_prognostic_names(model), outs))
    if model.boundary_fluxes is not None:
        apply_boundary_flux_tendencies(model, aux, new, alpha * dt)
    return state.replace(**new)


def stage_update(model: AtmosphereModel, state: State, state0: State, dt: float,
                 alpha: float, aux: Aux | None = None) -> State:
    """One SSP-RK3 stage blend (before the projection)."""
    if aux is None:
        aux = diagnose(model, state)
    return compute_tendencies(model, state, aux, dt, state0, alpha)


def pressure_projection(model: AtmosphereModel, rho_u, rho_v, rho_w, dt: float):
    """Project the momenta onto ∇·(ρᵣu) = 0: solve ∇·(ρᵣ∇φ) = ∇·(ρũ)/Δt,
    then ρu ← ρu − Δt ρᵣ ∇φ.  Returns ``(rho_u, rho_v, rho_w, phi)``."""
    g = model.grid
    so = StencilOps(g, halo=1)
    rho_u, rho_v, rho_w = fl.enforce_wall_normals(g, rho_u, rho_v, rho_w)
    div = so.div_c(fl.pad(rho_u, g, fl.CCF, halo=1),
                   fl.pad(rho_v, g, fl.CFC, halo=1),
                   fl.pad(rho_w, g, fl.FCC, halo=1))
    phi = model.solver.solve(div, dt)
    phi_pad = fl.pad(phi, g, fl.CCC, halo=1)
    rho_c = model.reference.rho_col
    rho_u = rho_u - dt * rho_c * so.dx_cf(phi_pad)
    rho_v = rho_v - dt * rho_c * so.dy_cf(phi_pad)
    rho_w = rho_w - dt * model.reference.rho_f_col * so.dz_cf(phi_pad)
    rho_u, rho_v, rho_w = fl.enforce_wall_normals(g, rho_u, rho_v, rho_w)
    return rho_u, rho_v, rho_w, phi
