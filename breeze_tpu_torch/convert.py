"""State and reference data across the package boundary, as numpy.

The port and the JAX reference package share no arrays: a test draws its
inputs with numpy, builds a state in one package, and carries it to the other
through these converters (for example ``{k: np.asarray(getattr(jax_state,
k)) for k in ...}``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dynamics.compressible import CompressibleState
from .dynamics.terrain import TerrainMetrics
from .model import State
from .thermo.reference import ExnerReferenceState, ReferenceState

PROGNOSTICS = ("rho_u", "rho_v", "rho_w", "rho_theta", "rho_qt")
REFERENCE_PROFILES = ("p_c", "rho_c", "T_c", "rho_f", "qv_c", "ql_c", "qi_c")
COMPRESSIBLE_PROGNOSTICS = ("rho", "rho_u", "rho_v", "rho_w", "rho_theta")
EXNER_PROFILES = ("p_c", "rho_c", "T_c", "theta_c", "exner_c", "rho_f", "qv_c")
#: The tensor fields of :class:`TerrainMetrics` (``None`` where unused).
TERRAIN_FIELDS = tuple(f.name for f in dataclasses.fields(TerrainMetrics)
                       if f.name != "height")


def state_from_numpy(arrays: dict, *, dtype: torch.dtype, device) -> State:
    """A :class:`State` from numpy arrays keyed by prognostic name
    (``rho_qt`` optional), plus optional ``time`` and ``T_warm``."""
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    diagnostics = {}
    if arrays.get("T_warm") is not None:
        diagnostics["T_warm"] = as_t(arrays["T_warm"])
    return State(
        rho_u=as_t(arrays["rho_u"]), rho_v=as_t(arrays["rho_v"]),
        rho_w=as_t(arrays["rho_w"]), rho_theta=as_t(arrays["rho_theta"]),
        rho_qt=None if arrays.get("rho_qt") is None else as_t(arrays["rho_qt"]),
        time=float(arrays.get("time", 0.0)), diagnostics=diagnostics)


def state_to_numpy(state: State) -> dict:
    """The state's prognostics (and ``T_warm``, ``time``) as numpy arrays."""
    out = {k: getattr(state, k).detach().cpu().numpy()
           for k in PROGNOSTICS if getattr(state, k) is not None}
    if "T_warm" in state.diagnostics:
        out["T_warm"] = state.diagnostics["T_warm"].detach().cpu().numpy()
    out["time"] = np.asarray(state.time)
    return out


def reference_from_numpy(arrays: dict, *, surface_pressure: float,
                         potential_temperature: float, standard_pressure: float,
                         dtype: torch.dtype, device) -> ReferenceState:
    """A :class:`ReferenceState` from numpy profiles (``p_c``, ``rho_c``,
    ``T_c``, ``rho_f``, ``qv_c``, ``ql_c``, ``qi_c``), to pin the port's
    reference columns to another package's."""
    return ReferenceState(
        surface_pressure=float(surface_pressure),
        potential_temperature=float(potential_temperature),
        standard_pressure=float(standard_pressure),
        **{k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
           for k in REFERENCE_PROFILES})


def compressible_state_from_numpy(arrays: dict, *, dtype: torch.dtype,
                                  device) -> CompressibleState:
    """A :class:`CompressibleState` from numpy arrays keyed by prognostic
    name (``rho``, ``rho_u``, ``rho_v``, ``rho_w``, ``rho_theta``, and
    ``rho_qt`` for a moist state), plus an optional ``time``."""
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return CompressibleState(
        **{k: as_t(arrays[k]) for k in COMPRESSIBLE_PROGNOSTICS},
        rho_qt=None if arrays.get("rho_qt") is None else as_t(arrays["rho_qt"]),
        time=float(arrays.get("time", 0.0)))


def compressible_state_to_numpy(state: CompressibleState) -> dict:
    """The state's prognostics (``rho_qt`` when moist) and ``time`` as numpy
    arrays."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in COMPRESSIBLE_PROGNOSTICS}
    if state.rho_qt is not None:
        out["rho_qt"] = state.rho_qt.detach().cpu().numpy()
    out["time"] = np.asarray(state.time)
    return out


def exner_reference_from_numpy(arrays: dict, *, surface_pressure: float,
                               surface_potential_temperature: float,
                               standard_pressure: float, dtype: torch.dtype,
                               device) -> ExnerReferenceState:
    """An :class:`ExnerReferenceState` from numpy profiles (``p_c``,
    ``rho_c``, ``T_c``, ``theta_c``, ``exner_c``, ``rho_f``, ``qv_c``), to pin
    the port's reference columns to another package's."""
    return ExnerReferenceState(
        surface_pressure=float(surface_pressure),
        surface_potential_temperature=float(surface_potential_temperature),
        standard_pressure=float(standard_pressure),
        **{k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
           for k in EXNER_PROFILES})


def terrain_from_numpy(arrays: dict, *, height: float, dtype: torch.dtype,
                       device) -> TerrainMetrics:
    """:class:`TerrainMetrics` from numpy arrays keyed by
    :data:`TERRAIN_FIELDS` (a missing or ``None`` SLEVE field stays
    ``None``), to feed the port another package's metrics and reference."""
    as_t = lambda a: None if a is None else torch.tensor(np.asarray(a), dtype=dtype,
                                                         device=device)
    return TerrainMetrics(height=float(height),
                          **{k: as_t(arrays.get(k)) for k in TERRAIN_FIELDS})


def terrain_to_numpy(terrain: TerrainMetrics) -> dict:
    """The terrain's tensor fields as numpy arrays (``None`` kept)."""
    return {k: None if getattr(terrain, k) is None
            else getattr(terrain, k).detach().cpu().numpy() for k in TERRAIN_FIELDS}
