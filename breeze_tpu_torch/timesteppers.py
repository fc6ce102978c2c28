"""SSP-RK3 with a pressure projection after each stage.

Port of ``breeze_tpu/timesteppers.py::ssp_rk3_step``.  The step is an eager
Python function; every stage diagnoses the state, runs the fused tendency
kernel (which also blends the stage) and projects the momenta over αΔt.
"""

from __future__ import annotations

from . import model as M
from .physics.microphysics import apply_negative_moisture_correction

SSP_RK3_ALPHAS = (1.0, 0.25, 2.0 / 3.0)


def ssp_rk3_step(model: M.AtmosphereModel, state: M.State, dt: float) -> M.State:
    """Advance one Δt.  The negative-moisture correction runs at step start;
    the saturation adjustment's warm start chains from the previous step's
    converged T (``diagnostics["T_warm"]``) through the three stages."""
    if state.rho_qt is not None:
        state = apply_negative_moisture_correction(model, state)
    state0 = state
    prev_T = state.diagnostics.get("T_warm")
    for alpha in SSP_RK3_ALPHAS:
        aux = M.diagnose(model, state, T_guess=prev_T)
        prev_T = aux.T
        ns = M.stage_update(model, state, state0, dt, alpha, aux=aux)
        rho_u, rho_v, rho_w, _ = M.pressure_projection(
            model, ns.rho_u, ns.rho_v, ns.rho_w, alpha * dt)
        state = ns.replace(rho_u=rho_u, rho_v=rho_v, rho_w=rho_w)
    if "T_warm" in state.diagnostics:
        state = state.replace(diagnostics={**state.diagnostics, "T_warm": prev_T})
    return state.replace(time=state.time + dt)
