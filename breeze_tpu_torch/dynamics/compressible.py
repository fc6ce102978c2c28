"""The split-explicit compressible core: prognostic density, the EOS,
WS-RK3 outer stages around acoustic substeps.

Port of ``breeze_tpu/dynamics/compressible.py``: dry or moist (warm
saturation adjustment at the true density), in ρθ or ρe, flat; dry ρθ over
terrain (σ-coordinates, ``dynamics/terrain.py``):

- Wicker–Skamarock RK3 stages β = (1/3, 1/2, 1); the slow tendencies
  (WENO5 advection, Coriolis, the frozen horizontal pressure gradient and
  the vertical stage-entry imbalance) are evaluated once per stage at the
  stage-entry state U^L;
- the acoustic substeps (``kernels/acoustic.py``) advance the
  perturbations about U^L, which start each stage at Uⁿ − U^L;
- U^(k) = U^L + the perturbations;
- with moisture, ρqᵗ is repaired at step start (the fix-negative kernel)
  and advected over βΔt by the substeps' time-averaged momenta.

The slow tendencies run the momentum and scalar WENO5 kernels
(``kernels/momentum.py``, ``kernels/advection.py``) on windows padded by
``fields.pad``.  Everything else is plain PyTorch on the grid's device.

Over terrain the slow tendencies are ``terrain.terrain_slow_tendencies``,
the acoustic loop takes the eight metric factors of
:func:`terrain_metric_fields`, and the recovery sets ρw on the surface face
from the kinematic bottom.

Envelope (``make_compressible_model`` raises ``NotImplementedError``
outside it): periodic x and y, bounded z; WENO5 advection (momentum not
bounds-preserving); Coriolis ``None`` or :class:`FPlane`; no closure,
forcings or boundary fluxes; no microphysics or a warm
:class:`~..physics.microphysics.SaturationAdjustment`; the
potential-temperature or static-energy formulation; float32 or bfloat16
substep storage; no, thermal (without ``damp_vertical``) or direct
divergence damping; the proportional substep plan with N from
``acoustic_cfl``; flat or :class:`~.terrain.TerrainMetrics` terrain
(LinearDecay or SLEVE), dry and in ρθ over terrain; no sponge or an
:class:`UpperSponge`; the per-substep kernel pair K1/K2 in place of the
stage's acoustic kernel on flat terrain in ρθ with no or thermal damping
and no sponge.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .. import fields as fl
from ..advection import WENO
from ..grid import Grid, Topology
from ..kernels.acoustic import (AcousticConfig, Perturbations, TerrainFields, ZColumns,
                               acoustic_substeps)
from ..kernels.acoustic_split import acoustic_substeps_split
from ..kernels.advection import div_rho_u_c
from ..kernels.momentum import momentum_div
from ..kernels.weno import H
from ..ops import StencilOps
from ..physics.coriolis import FPlane, coriolis_terms
from ..physics.microphysics import (SaturationAdjustment, apply_negative_moisture_correction,
                                    density_saturation_adjust,
                                    density_saturation_adjust_static_energy,
                                    density_temperature_inversion)
from ..thermo.constants import MoistureMassFractions, ThermodynamicConstants
from ..thermo.reference import ExnerReferenceState, make_exner_reference_state
from ..thermo.states import static_energy, theta_li_from_temperature
from .terrain import (TerrainMetrics, contravariant_rho_w, kinematic_bottom_rho_w,
                      terrain_slow_tendencies)

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NoDivergenceDamping:
    """No acoustic divergence damping."""


@dataclasses.dataclass(frozen=True)
class ThermalDivergenceDamping:
    """Klemp, Skamarock & Ha (2018) divergence damping with δτ(ρθ)/θᴸ as
    the divergence proxy.  ``damp_vertical`` (ignored by the reference) is
    not ported."""

    coefficient: float = 0.1
    damp_vertical: bool = False


@dataclasses.dataclass(frozen=True)
class DirectDivergenceDamping:
    """KSH18 eq. 36: the damping from δ = ∂x(θᴸₓρu′) + ∂y(θᴸᵧρv′) of the
    new perturbation momenta, +αΔx ∂xδ/θᴸₓ with no 1/Δτ."""

    coefficient: float = 0.1


def _ramp_profile(kind: str, z, top: float, depth: float):
    """Sponge ramp in [0, 1] over the top ``depth`` of the domain:
    ``linear``, ``sin2`` or ``cubic`` in s = (z − (top − depth))/depth."""
    s = torch.clamp((z - (top - depth)) / depth, 0.0, 1.0)
    if kind == "linear":
        return s
    if kind == "sin2":
        return torch.sin(0.5 * math.pi * s) ** 2
    if kind == "cubic":
        return s * s * (3.0 - 2.0 * s)
    raise ValueError(f"unknown ramp {kind!r}")


@dataclasses.dataclass(frozen=True)
class UpperSponge:
    """Implicit upper Rayleigh sponge on ρw′ inside the acoustic column
    solve (Klemp, Dudhia & Hassiotis 2008), Crank-Nicolson weighted:
    ωΔτ·rate·ramp on the diagonal, (1−ω)Δτ·rate·ramp·ρw′ on the explicit
    right-hand side.  ``damp_full`` (the default) also damps the stage-entry
    ρwᴸ (the contravariant ρw̃ᴸ over terrain), KDH08's full-field form;
    ``damp_full=False`` damps the perturbation only."""

    damping_rate: float = 0.2
    depth: float = 5.0e3
    ramp: str = "cubic"     # "cubic" | "sin2" | "linear"
    damp_full: bool = True


@dataclasses.dataclass(frozen=True)
class SplitExplicitTimeDiscretization:
    """Split-explicit (HEVI) controls (``breeze_tpu``'s): ``acoustic_cfl``
    sizes the substep count N from Δt; ``forward_weight`` is the CN
    off-centring ω; ``damping`` the divergence-damping strategy, or by
    default thermal damping of ``damping_coefficient`` (0 for none);
    ``substep_floattype`` ``None`` (float32 carries) or ``"bfloat16"``;
    ``sponge`` an optional :class:`UpperSponge`.  ``substeps`` and
    ``substep_distribution`` exist for the reference's signature; the port
    takes only their defaults (the ``proportional`` substep plan).

    ``per_substep_kernels`` runs each substep through the kernel pair K1/K2
    (``kernels/acoustic_split.py``) in place of the stage's acoustic kernel:
    the counterpart of the reference's ``BREEZE_TPU_PALLAS_ACOUSTIC_SPLIT``
    switch, as an argument.  The pair covers flat terrain, the
    potential-temperature formulation, no or thermal damping and no sponge;
    the model refuses it elsewhere, where the reference falls back to its
    jnp loop."""

    substeps: int | None = None
    acoustic_cfl: float = 0.5
    forward_weight: float = 0.65
    damping_coefficient: float = 0.1
    reference_sound_temperature: float = 300.0
    substep_floattype: str | None = None
    damping: Any = None
    sponge: Any = None
    substep_distribution: str = "proportional"
    per_substep_kernels: bool = False

    def damping_strategy(self):
        if self.damping is not None:
            return self.damping
        if self.damping_coefficient:
            return ThermalDivergenceDamping(self.damping_coefficient)
        return NoDivergenceDamping()


@dataclasses.dataclass(frozen=True)
class CompressibleState:
    """Prognostics: density ρ, momenta on their faces, the thermodynamic
    density ρχ at centers (ρθ, or ρe under the static-energy formulation),
    and with moisture ρqᵗ."""

    rho: torch.Tensor
    rho_u: torch.Tensor
    rho_v: torch.Tensor
    rho_w: torch.Tensor
    rho_theta: torch.Tensor
    rho_qt: torch.Tensor | None = None
    time: float = 0.0

    def replace(self, **kw) -> "CompressibleState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CompressibleModel:
    grid: Grid
    reference: ExnerReferenceState
    constants: ThermodynamicConstants
    momentum_advection: WENO
    scalar_advection: WENO
    coriolis: Any
    time_discretization: SplitExplicitTimeDiscretization
    p_standard: float
    acoustic_config: AcousticConfig
    z_columns: ZColumns
    terrain: TerrainMetrics | None = None
    #: the acoustic loop's metric factors over terrain (``None`` when flat)
    acoustic_metrics: TerrainFields | None = None
    microphysics: SaturationAdjustment | None = None
    formulation: str = "potential_temperature"
    #: the acoustic carries' storage type (``None``: the grid's dtype)
    substep_dtype: torch.dtype | None = None

    @property
    def has_moisture(self) -> bool:
        return self.microphysics is not None


def _check_envelope(grid, momentum_advection, scalar_advection, coriolis, td,
                    terrain, formulation, microphysics, **excluded):
    if formulation not in ("potential_temperature", "static_energy"):
        raise ValueError(f"unknown formulation {formulation!r}")
    problems = [f"{name} is not ported" for name, val in excluded.items()
                if val not in (None, ())]
    if microphysics is not None and not isinstance(microphysics, SaturationAdjustment):
        problems.append("microphysics must be None or a SaturationAdjustment")
    if terrain is not None:
        if not isinstance(terrain, TerrainMetrics):
            problems.append("terrain must be a TerrainMetrics from dynamics.terrain.make_terrain")
        if formulation == "static_energy":
            problems.append("the static_energy formulation over terrain is not ported "
                            "(nor wired in the reference)")
        if microphysics is not None:
            problems.append("moisture over terrain is not ported (its scalar transport "
                            "needs the terrain branch of the scalar advection)")
    if grid.topologies() != (Topology.BOUNDED, Topology.PERIODIC, Topology.PERIODIC):
        problems.append("x and y must be periodic and z bounded")
    if not (isinstance(momentum_advection, WENO) and momentum_advection.order == 5
            and not momentum_advection.bounds_preserving):
        problems.append("momentum advection must be WENO(5) without bounds preservation")
    if not (isinstance(scalar_advection, WENO) and scalar_advection.order == 5):
        problems.append("scalar advection must be WENO(5)")
    if coriolis is not None and not isinstance(coriolis, FPlane):
        problems.append("Coriolis must be None or FPlane")
    if not isinstance(td, SplitExplicitTimeDiscretization):
        problems.append("only the split-explicit time discretization is ported")
    else:
        if td.substeps is not None:
            problems.append("a fixed substep count is not ported (acoustic_cfl sizes it)")
        strategy = td.damping_strategy()
        if not isinstance(strategy, (NoDivergenceDamping, ThermalDivergenceDamping,
                                     DirectDivergenceDamping)):
            problems.append("the damping must be no, thermal or direct divergence damping")
        elif getattr(strategy, "damp_vertical", False):
            problems.append("ThermalDivergenceDamping(damp_vertical=True) is not ported")
        if td.substep_distribution != "proportional":
            problems.append("only the proportional substep plan is ported")
        if td.substep_floattype not in (None, "bfloat16"):
            problems.append("substep_floattype must be None or 'bfloat16'")
        if td.sponge is not None and not isinstance(td.sponge, UpperSponge):
            problems.append("the sponge must be an UpperSponge")
        if td.per_substep_kernels:
            # the K1/K2 pair's envelope (acoustic.py:904-949 with the switch set)
            pair = {"terrain": terrain is not None, "an UpperSponge": td.sponge is not None,
                    "the static_energy formulation": formulation == "static_energy",
                    "DirectDivergenceDamping": isinstance(strategy, DirectDivergenceDamping)}
            problems += [f"per_substep_kernels with {what} is not ported (the K1/K2 pair "
                         "has no such branch)" for what, on in pair.items() if on]
    if problems:
        raise NotImplementedError("outside the ported envelope: " + "; ".join(problems))


def make_compressible_model(grid: Grid, constants: ThermodynamicConstants | None = None,
                            reference: ExnerReferenceState | None = None,
                            advection=None, momentum_advection=None,
                            scalar_advection=None, coriolis=None, closure=None,
                            forcings=(), boundary_fluxes=None,
                            time_discretization=None, microphysics=None,
                            terrain=None, formulation: str = "potential_temperature",
                            surface_pressure: float = 101325.0,
                            reference_potential_temperature=300.0,
                            reference_vapor_mass_fraction=None,
                            p_standard: float = 1.0e5) -> CompressibleModel:
    """Model factory (``breeze_tpu``'s signature): builds the discretely
    balanced reference column and the kernels' columns on the grid's
    device.  ``advection`` serves momentum and scalars unless they are
    given apart."""
    if advection is not None:
        momentum_advection = momentum_advection or advection
        scalar_advection = scalar_advection or advection
    scalar_advection = scalar_advection or momentum_advection
    td = time_discretization or SplitExplicitTimeDiscretization()
    _check_envelope(grid, momentum_advection, scalar_advection, coriolis, td,
                    terrain, formulation, microphysics, closure=closure,
                    forcings=tuple(forcings), boundary_fluxes=boundary_fluxes,
                    reference_vapor_mass_fraction=reference_vapor_mass_fraction)
    constants = constants or ThermodynamicConstants()
    if reference is None:
        reference = make_exner_reference_state(
            grid, constants, surface_pressure=surface_pressure,
            potential_temperature=reference_potential_temperature,
            standard_pressure=p_standard)
    strategy = td.damping_strategy()
    nz = grid.nz
    # 1/Δz from the float64 spacings, as the TPU kernels take them
    inv = lambda dz: torch.tensor([1.0 / d for d in dz], dtype=grid.dtype,
                                  device=grid.device)
    sponge = None
    if td.sponge is not None:
        sp = td.sponge
        sponge = sp.damping_rate * _ramp_profile(sp.ramp, grid.z_f[:nz],
                                                 grid.z0 + grid.Lz, sp.depth)
    return CompressibleModel(
        grid=grid, reference=reference, constants=constants,
        momentum_advection=momentum_advection, scalar_advection=scalar_advection,
        coriolis=coriolis, time_discretization=td, p_standard=p_standard,
        acoustic_config=AcousticConfig(
            dx=float(grid.dx), dy=float(grid.dy), omega=float(td.forward_weight),
            g_acc=float(constants.gravitational_acceleration),
            damping=float(getattr(strategy, "coefficient", 0.0)),
            damping_mode="direct" if isinstance(strategy, DirectDivergenceDamping)
            else "thermal", per_substep_kernels=td.per_substep_kernels),
        z_columns=ZColumns(dz_c=grid.dz_c, dz_f=grid.dz_f[:nz],
                           inv_dzc=inv(grid.dz_c_meta), inv_dzf=inv(grid.dz_f_meta[:nz]),
                           sponge=sponge),
        terrain=terrain,
        acoustic_metrics=None if terrain is None else terrain_metric_fields(terrain),
        microphysics=microphysics, formulation=formulation,
        substep_dtype=None if td.substep_floattype is None else torch.bfloat16)


def compressible_initial_state(model: CompressibleModel, theta=None, u=None,
                               v=None, w=None, rho=None, qt=None,
                               pressure_balanced: bool = True) -> CompressibleState:
    """The state from θ (and optional velocities, density, and qᵗ with
    moisture) against the reference column.  By default the density is
    pressure-balanced, ρ = ρᵣθᵣ/θ, so that ρθ, and with it the dry EOS
    pressure, is the reference's and a θ perturbation raises no acoustic
    noise.  Under the static-energy formulation ρe follows from θ at the
    true density: T from the fixed-partition inversion (all moisture
    vapor), e = cᵖᵐT + gz."""
    g = model.grid
    ref = model.reference
    theta_arr = fl.full(g, theta, ref.theta_col)
    if rho is not None:
        rho_arr = fl.full(g, rho, 0.0)
    elif pressure_balanced:
        rho_arr = ref.rho_col * ref.theta_col / theta_arr
    else:
        rho_arr = fl.full(g, ref.rho_col, 0.0)
    rho_f = 0.5 * (rho_arr + torch.cat([rho_arr[:1], rho_arr[:-1]], 0))
    rho_u, rho_v, rho_w = fl.enforce_wall_normals(
        g, rho_arr * fl.full(g, u, 0.0), rho_arr * fl.full(g, v, 0.0),
        rho_f * fl.full(g, w, 0.0))
    rho_qt = rho_arr * fl.full(g, qt, 0.0) if model.has_moisture else None
    rho_chi = rho_arr * theta_arr
    if model.formulation == "static_energy":
        q0 = MoistureMassFractions.vapor_only(
            torch.zeros_like(rho_arr) if rho_qt is None else rho_qt / rho_arr)
        T0, _ = density_temperature_inversion(theta_arr, rho_arr, q0, model.constants,
                                              model.p_standard)
        rho_chi = rho_arr * static_energy(T0, g.z_c_col, q0, model.constants)
    return CompressibleState(rho=rho_arr, rho_u=rho_u, rho_v=rho_v, rho_w=rho_w,
                             rho_theta=rho_chi, rho_qt=rho_qt)


# ---------------------------------------------------------------------------
# EOS and diagnostics
# ---------------------------------------------------------------------------

def eos_pressure(model: CompressibleModel, rho_theta):
    """Dry EOS in closed form: p = pˢᵗ (Rᵈ ρθ / pˢᵗ)^γ."""
    c = model.constants
    cpd = c.dry_air.heat_capacity
    gamma = cpd / (cpd - c.Rd)
    p_st = model.p_standard
    return p_st * (c.Rd * rho_theta / p_st) ** gamma


class CompAux(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    theta: torch.Tensor
    p: torch.Tensor
    T: torch.Tensor
    q: MoistureMassFractions | None = None
    qt: torch.Tensor | None = None


def compressible_diagnose(model: CompressibleModel,
                          state: CompressibleState) -> CompAux:
    """u = ρu/ρ̄ᶠ (ρ averaged to each face), and the thermodynamics: in ρθ,
    θ = ρθ/ρ and, dry, p from the EOS and T = p/(Rᵈρ), moist, (T, q, p)
    from the saturation adjustment at the true density; in ρe, see
    :func:`_compressible_diagnose_static_energy`."""
    g = model.grid
    so = StencilOps(g, halo=1)
    rho_pad = fl.pad(state.rho, g, fl.CCC, halo=1)
    rho_c = so.v(rho_pad)
    u = state.rho_u / (0.5 * (rho_c + so.v(rho_pad, dx=-1)))
    v = state.rho_v / (0.5 * (rho_c + so.v(rho_pad, dy=-1)))
    w = state.rho_w / (0.5 * (rho_c + so.v(rho_pad, dz=-1)))
    if model.formulation == "static_energy":
        return _compressible_diagnose_static_energy(model, state, u, v, w)
    theta = state.rho_theta / state.rho
    if model.has_moisture:
        qt = state.rho_qt / state.rho
        T, q, p = density_saturation_adjust(theta, state.rho, qt, model.constants,
                                            model.microphysics, model.p_standard)
        return CompAux(u=u, v=v, w=w, theta=theta, p=p, T=T, q=q, qt=qt)
    p = eos_pressure(model, state.rho_theta)
    return CompAux(u=u, v=v, w=w, theta=theta, p=p, T=p / (model.constants.Rd * state.rho))


def reference_static_energy_col(model: CompressibleModel):
    """The dry reference column's static energy eᵣ = cᵖᵈTᵣ + gz, by the
    arithmetic of the ρe initial state, so that a dry rest state has
    ρe = ρᵣeᵣ and T = Tᵣ exactly."""
    ref = model.reference
    q0 = MoistureMassFractions.vapor_only(torch.zeros_like(ref.T_col))
    return static_energy(ref.T_col, model.grid.z_c_col, q0, model.constants)


def _compressible_diagnose_static_energy(model: CompressibleModel,
                                         state: CompressibleState, u, v, w) -> CompAux:
    """ρe diagnostics: moist, (T, q, p) from the saturation adjustment on e
    at the true density; dry, T in perturbation form against the reference
    column, T = Tᵣ + (e − eᵣ)/cᵖᵈ, and p = ρRᵈT.  θ = θˡⁱ(T, q, p)."""
    c = model.constants
    e = state.rho_theta / state.rho
    if model.has_moisture:
        qt = state.rho_qt / state.rho
        T, q, p = density_saturation_adjust_static_energy(
            e, model.grid.z_c_col, state.rho, qt, c, model.microphysics)
        theta = theta_li_from_temperature(T, q, p, c, model.p_standard)
        return CompAux(u=u, v=v, w=w, theta=theta, p=p, T=T, q=q, qt=qt)
    T = model.reference.T_col + (e - reference_static_energy_col(model)) / c.dry_air.heat_capacity
    p = state.rho * c.Rd * T
    zero = torch.zeros_like(e)
    theta = theta_li_from_temperature(T, MoistureMassFractions(zero, zero, zero), p, c,
                                      model.p_standard)
    return CompAux(u=u, v=v, w=w, theta=theta, p=p, T=T)


# ---------------------------------------------------------------------------
# Slow tendencies
# ---------------------------------------------------------------------------

class SlowTendencies(NamedTuple):
    rho: torch.Tensor
    rho_u: torch.Tensor
    rho_v: torch.Tensor
    rho_w: torch.Tensor
    rho_theta: torch.Tensor
    #: the slow non-advective moisture sources (zero: no closure, fluxes or
    #: forcings), or ``None`` without moisture
    rho_qt: torch.Tensor | None = None


def slow_tendencies(model: CompressibleModel, state: CompressibleState,
                    aux: CompAux) -> SlowTendencies:
    """Gˢ at the stage-entry state: advection (the two WENO5 kernels),
    Coriolis, the frozen horizontal ∇p^L, and for ρw the stage-entry
    imbalance −∂z(p^L − pᵣ) − g(ρ^L − ρᵣ) with the reference's own discrete
    face operator.  No acoustic pressure gradient or buoyancy: those are
    the fast part.  The scalar advected in the thermodynamic slot is χ = θ,
    or e = ρe/ρ under the static-energy formulation, whose budget also
    gains the buoyancy-flux source −ℑᶻ(w · imbalance).  With moisture,
    G.rho_qt holds the slow non-advective sources (zero here); ρqᵗ is
    advected in :func:`advance_scalars`."""
    g = model.grid
    ref = model.reference
    so = StencilOps(g, halo=1)
    inv_dx, inv_dy = float(1.0 / g.dx), float(1.0 / g.dy)
    pz = lambda a, loc: fl.pad(a, g, loc, halo=H, axes=(0, 1))
    p1 = lambda a, loc: fl.pad(a, g, loc, halo=1)
    pzu, pzv, pzw = pz(aux.u, fl.CCF), pz(aux.v, fl.CFC), pz(aux.w, fl.FCC)

    adv_u, adv_v, adv_w = momentum_div(
        pz(state.rho_u, fl.CCF), pz(state.rho_v, fl.CFC), pz(state.rho_w, fl.FCC),
        pzu, pzv, pzw, model.z_columns.inv_dzc, model.z_columns.inv_dzf, inv_dx, inv_dy)
    rho_u_pad = p1(state.rho_u, fl.CCF)
    rho_v_pad = p1(state.rho_v, fl.CFC)
    rho_w_pad = p1(state.rho_w, fl.FCC)
    cor_x, cor_y, cor_z = coriolis_terms(model.coriolis, so, rho_u_pad, rho_v_pad,
                                         rho_w_pad)
    G_rho = -so.div_c(rho_u_pad, rho_v_pad, rho_w_pad)
    chi = state.rho_theta / state.rho if model.formulation == "static_energy" else aux.theta
    G_rho_theta = div_rho_u_c(pz(chi, fl.CCC), pzu, pzv, pzw,
                              pz(state.rho, fl.CCC), model.z_columns.inv_dzc, inv_dx, inv_dy,
                              bounds=model.scalar_advection.bounds_preserving)

    # frozen horizontal PGF (pᵣ depends on z alone, so ∂x p^L = ∂x(p^L − pᵣ))
    p_pad = p1(aux.p, fl.CCC)
    G_rho_u = -adv_u - cor_x - so.dx_cf(p_pad)
    G_rho_v = -adv_v - cor_y - so.dy_cf(p_pad)
    pp_pad = p1(aux.p - ref.p_col, fl.CCC)
    rp_pad = p1(state.rho - ref.rho_col, fl.CCC)
    imbalance = (-so.dz_cf(pp_pad)
                 - model.constants.gravitational_acceleration * so.iz_cf(rp_pad))
    G_rho_w = -adv_w - cor_z + imbalance
    if model.formulation == "static_energy":
        G_rho_theta = G_rho_theta - so.iz_fc(p1(aux.w * imbalance, fl.FCC))
    return SlowTendencies(rho=G_rho, rho_u=G_rho_u, rho_v=G_rho_v,
                          rho_w=G_rho_w, rho_theta=G_rho_theta,
                          rho_qt=None if state.rho_qt is None else torch.zeros_like(G_rho))


# ---------------------------------------------------------------------------
# The fast part
# ---------------------------------------------------------------------------

def sound_speed(model: CompressibleModel) -> float:
    c = model.constants
    cpd = c.dry_air.heat_capacity
    gamma = cpd / (cpd - c.Rd)
    return math.sqrt(gamma * c.Rd * model.time_discretization.reference_sound_temperature)


def substep_count(model: CompressibleModel, dt: float) -> int:
    """N ≈ ⌈Δt c_s / (CFL · Δx_min)⌉."""
    td = model.time_discretization
    g = model.grid
    return max(1, math.ceil(dt * sound_speed(model) / (td.acoustic_cfl * min(g.dx, g.dy))))


class StageCaches(NamedTuple):
    """Per-stage linearization p′ = Cᴸ(ρχ)′ + C_ρρ′: χᴸ (θᴸ or eᴸ) at
    centers and z-faces, Cᴸ = ∂p/∂(ρχ) (γRᵐΠᴸ, or Rᵐ/cᵖᵐ in ρe) and
    C_ρ = ∂p/∂ρ at fixed ρχ (``None`` in ρθ; (Rᵐ/cᵖᵐ)(ℒˡqˡ + ℒⁱqⁱ − gz)
    in ρe, exact at the stage's frozen q)."""

    theta_L: torch.Tensor
    theta_L_zf: torch.Tensor
    C_L: torch.Tensor
    C_rho: torch.Tensor | None = None


def stage_caches(model: CompressibleModel, state: CompressibleState,
                 aux: CompAux) -> StageCaches:
    c = model.constants
    if aux.q is not None:
        Rm, cpm = c.mixture_gas_constant(aux.q), c.mixture_heat_capacity(aux.q)
    else:
        Rm, cpm = c.Rd, c.dry_air.heat_capacity
    if model.formulation == "static_energy":
        e = state.rho_theta / state.rho
        Ce = (Rm / cpm) * torch.ones_like(e)
        lq = (0.0 if aux.q is None else c.liquid.reference_latent_heat * aux.q.liquid
              + c.ice.reference_latent_heat * aux.q.ice)
        C_rho = Ce * (lq - c.gravitational_acceleration * model.grid.z_c_col)
        e_zf = 0.5 * (e + torch.cat([e[:1], e[:-1]], 0))
        return StageCaches(theta_L=e, theta_L_zf=e_zf, C_L=Ce, C_rho=C_rho)
    gamma = cpm / (cpm - Rm)
    kappa = Rm / cpm
    Pi_L = (aux.p / model.p_standard) ** kappa
    th = aux.theta
    th_zf = 0.5 * (th + torch.cat([th[:1], th[:-1]], 0))
    return StageCaches(theta_L=th, theta_L_zf=th_zf, C_L=gamma * Rm * Pi_L)


WS_RK3_BETAS = (1.0 / 3.0, 1.0 / 2.0, 1.0)


def stage_substep_plan(N: int, dt: float):
    """Per-stage ``(n_tau, dtau)`` of the ``proportional`` plan:
    Nτ = ⌈βN⌉, Δτ = βΔt/Nτ."""
    plan = []
    for beta in WS_RK3_BETAS:
        n_tau = max(1, math.ceil(beta * N - 1e-9))
        plan.append((n_tau, beta * dt / n_tau))
    return tuple(plan)


def stage_perturbations(state_n: CompressibleState, state: CompressibleState,
                        store: torch.dtype | None = None) -> Perturbations:
    """The stage rewind: perturbations Uⁿ − U^L, rounded to the carries'
    storage type ``store`` (``None``: kept), sums zero."""
    zero = torch.zeros_like(state.rho)
    cast = (lambda a: a) if store is None else (lambda a: a.to(store))
    return Perturbations(
        rho=cast(state_n.rho - state.rho), rho_u=cast(state_n.rho_u - state.rho_u),
        rho_v=cast(state_n.rho_v - state.rho_v), rho_w=cast(state_n.rho_w - state.rho_w),
        rho_theta=cast(state_n.rho_theta - state.rho_theta),
        sum_rho_u=zero, sum_rho_v=zero, sum_rho_w=zero)


def terrain_metric_fields(terrain: TerrainMetrics) -> TerrainFields:
    """The eight metric factors of the acoustic loop over terrain: 1/J at
    ζ-centers and ζ-faces, J at x- and y-faces (z-extent 1 for LinearDecay,
    nz for SLEVE), the z-face slopes moved to the x- and y-centers, and the
    ζ-center slopes at the x- and y-faces."""
    sx_zf = terrain.slope_x(at_zface=True)
    sy_zf = terrain.slope_y(at_zface=True)
    return TerrainFields(
        inv_jac_c=1.0 / terrain.jac_c3, inv_jac_f=1.0 / terrain.jac_cf3,
        jac_xf=terrain.jac_xf3, jac_yf=terrain.jac_yf3,
        sx_c_zf=0.5 * (sx_zf + torch.roll(sx_zf, -1, 2)),
        sy_c_zf=0.5 * (sy_zf + torch.roll(sy_zf, -1, 1)),
        sx_cf=terrain.slope_x(at_zface=False), sy_cf=terrain.slope_y(at_zface=False))


def recover(model: CompressibleModel, state: CompressibleState,
            pert: Perturbations) -> CompressibleState:
    """U^(k) = U^L + the perturbations, ρw on the surface face from the
    bottom condition: 0 on a flat wall, the kinematic bottom over terrain."""
    if model.terrain is not None:
        rho_u, rho_v = state.rho_u + pert.rho_u, state.rho_v + pert.rho_v
        rho_w = state.rho_w + pert.rho_w
        rho_w[0] = kinematic_bottom_rho_w(model.terrain, rho_u, rho_v)
    else:
        rho_u, rho_v, rho_w = fl.enforce_wall_normals(
            model.grid, state.rho_u + pert.rho_u, state.rho_v + pert.rho_v,
            state.rho_w + pert.rho_w)
    return state.replace(rho=state.rho + pert.rho, rho_u=rho_u, rho_v=rho_v,
                         rho_w=rho_w, rho_theta=state.rho_theta + pert.rho_theta)


def stage_slow_tendencies(model: CompressibleModel, state: CompressibleState,
                          aux: CompAux) -> SlowTendencies:
    """The stage's slow tendencies, flat or over terrain."""
    if model.terrain is not None:
        return terrain_slow_tendencies(model, model.terrain, state, aux)
    return slow_tendencies(model, state, aux)


def sponge_rho_w_L(model: CompressibleModel, state: CompressibleState):
    """The stage-entry ρwᴸ that a full-field sponge damps (the
    contravariant ρw̃ᴸ over terrain, whose perturbation the fast system
    carries), or ``None`` without one."""
    sponge = model.time_discretization.sponge
    if sponge is None or not sponge.damp_full:
        return None
    if model.terrain is None:
        return state.rho_w
    g = model.grid
    return contravariant_rho_w(model.terrain, StencilOps(g, halo=1),
                               fl.pad(state.rho_u, g, fl.CCF, halo=1),
                               fl.pad(state.rho_v, g, fl.CFC, halo=1), state.rho_w)


def advance_scalars(model: CompressibleModel, state_n: CompressibleState,
                    state_L: CompressibleState, new_state: CompressibleState,
                    pert: Perturbations, n_tau: int, beta_dt: float,
                    G: SlowTendencies) -> CompressibleState:
    """ρqᵗ over the stage's βΔt, flux form: the scalar kernel on qᵗ = ρqᵗ/ρᴸ
    carried by the substeps' time-averaged momenta ρuᴸ + Σρu′/Nτ over ρᴸ
    (windows padded as in :func:`slow_tendencies`), plus the slow sources,
    from the step-start ρqᵗ."""
    g = model.grid
    pz = lambda a, loc: fl.pad(a, g, loc, halo=H, axes=(0, 1))
    rho_safe = torch.clamp(state_L.rho, min=1e-30)
    inv_n = 1.0 / n_tau
    Gq = div_rho_u_c(pz(state_L.rho_qt / state_L.rho, fl.CCC),
                     pz((state_L.rho_u + pert.sum_rho_u * inv_n) / rho_safe, fl.CCF),
                     pz((state_L.rho_v + pert.sum_rho_v * inv_n) / rho_safe, fl.CFC),
                     pz((state_L.rho_w + pert.sum_rho_w * inv_n) / rho_safe, fl.FCC),
                     pz(state_L.rho, fl.CCC), model.z_columns.inv_dzc,
                     float(1.0 / g.dx), float(1.0 / g.dy),
                     bounds=model.scalar_advection.bounds_preserving)
    return new_state.replace(rho_qt=state_n.rho_qt + beta_dt * (Gq + G.rho_qt))


def acoustic_stage(model: CompressibleModel, state: CompressibleState,
                   state_n: CompressibleState, caches: StageCaches, G: SlowTendencies,
                   n_tau: int, dtau: float) -> Perturbations:
    """A stage's ``n_tau`` substeps from the rewind Uⁿ − U^L, the first
    substep's pressure gradient gated when there is more than one, the
    carries stored in the model's substep type: through the acoustic
    kernel, or with ``per_substep_kernels`` through the pair K1/K2."""
    cfg = model.acoustic_config
    pert = stage_perturbations(state_n, state, model.substep_dtype)
    if cfg.per_substep_kernels:
        return acoustic_substeps_split(cfg, model.z_columns, caches, G, pert, dtau, n_tau,
                                       gate_first=n_tau > 1)
    return acoustic_substeps(cfg, model.z_columns, caches, G, pert, dtau, n_tau,
                             gate_first=n_tau > 1, metrics=model.acoustic_metrics,
                             rho_w_L=sponge_rho_w_L(model, state))


def acoustic_rk3_step(model: CompressibleModel, state: CompressibleState,
                      dt: float) -> CompressibleState:
    """One Δt of WS-RK3 with acoustic substeps (``breeze_tpu``'s
    ``acoustic_rk3_step`` without tracers or implicit diffusion).  With
    moisture, the negative-moisture repair first.  Each stage: diagnose,
    caches, slow tendencies (over terrain if the model has it), the
    substeps (:func:`acoustic_stage`), the recovery, and with moisture the
    scalar transport."""
    dt = float(dt)
    plan = stage_substep_plan(substep_count(model, dt), dt)
    if model.has_moisture:
        state = apply_negative_moisture_correction(model, state)
    state_n = state
    for beta, (n_tau, dtau) in zip(WS_RK3_BETAS, plan):
        aux = compressible_diagnose(model, state)
        caches = stage_caches(model, state, aux)
        G = stage_slow_tendencies(model, state, aux)
        pert = acoustic_stage(model, state, state_n, caches, G, n_tau, dtau)
        new_state = recover(model, state, pert)
        if model.has_moisture:
            new_state = advance_scalars(model, state_n, state, new_state, pert, n_tau,
                                        beta * dt, G)
        state = new_state
    return state.replace(time=state.time + dt)
