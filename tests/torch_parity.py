"""Shared set-up for the parity tests of ``breeze_tpu_torch`` against
``breeze_tpu``: the BOMEX configuration built through the JAX package (as
``bench.py::_build_bomex`` builds it) and state carried across as numpy."""

import jax.numpy as jnp
import numpy as np

import breeze_tpu as bz
from breeze_tpu.physics.closures import SmagorinskyLilly
from breeze_tpu.physics.forcings import (DrySubsidenceTendency,
                                         GeostrophicForcing,
                                         SubsidenceForcing, UpperSponge)
from breeze_tpu.physics.surface import PrescribedSurfaceFluxes

F_COR = 3.76e-5
PROGNOSTICS = ("rho_u", "rho_v", "rho_w", "rho_theta", "rho_qt")


def jax_bomex_model(size, dtype):
    grid = bz.make_grid(size=size, extent=(6_400.0, 6_400.0, 3_000.0),
                        topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                        halo=3, dtype=dtype)
    return bz.make_model(
        grid, advection=bz.WENO(5), potential_temperature=298.7,
        surface_pressure=101_500.0,
        microphysics=bz.SaturationAdjustment(equilibrium=bz.WarmPhaseEquilibrium()),
        closure=SmagorinskyLilly(), coriolis=bz.FPlane(f=F_COR),
        boundary_fluxes=PrescribedSurfaceFluxes(
            theta_flux=8.0e-3, qt_flux=5.2e-5, friction_velocity=0.28),
        forcings=(
            GeostrophicForcing(f=F_COR, u_g=lambda z: -10.0 + 1.8e-3 * z, v_g=0.0),
            SubsidenceForcing(w_profile=lambda z: jnp.where(
                z < 1500.0, -0.0065 * z / 1500.0,
                jnp.where(z < 2100.0, -0.0065 * (1 - (z - 1500.0) / 600.0), 0.0))),
            DrySubsidenceTendency(tendency_profile=lambda z: jnp.where(
                z < 300.0, -1.2e-8,
                jnp.where(z < 500.0, -1.2e-8 * (1 - (z - 300.0) / 200.0), 0.0))),
            UpperSponge(rate=0.05, bottom=2400.0),
        ))


def jax_bomex_state(model, noise):
    """bench.py's BOMEX initial state, with ``noise`` (numpy) in place of
    its jax.random draw."""
    def theta0(x, y, z):
        return jnp.where(z < 520.0, 298.7,
               jnp.where(z < 1480.0, 298.7 + (z - 520.0) * (302.4 - 298.7) / 960.0,
               jnp.where(z < 2000.0, 302.4 + (z - 1480.0) * (308.2 - 302.4) / 520.0,
                         308.2 + (z - 2000.0) * 3.65e-3)))

    def qt0(x, y, z):
        return jnp.where(z < 520.0, 17.0e-3 + z * (16.3e-3 - 17.0e-3) / 520.0,
               jnp.where(z < 1480.0, 16.3e-3 + (z - 520.0) * (10.7e-3 - 16.3e-3) / 960.0,
               jnp.where(z < 2000.0, 10.7e-3 + (z - 1480.0) * (4.2e-3 - 10.7e-3) / 520.0,
                         jnp.maximum(4.2e-3 - (z - 2000.0) * 1.2e-6, 1e-4))))

    def u0(x, y, z):
        return jnp.where(z < 700.0, -8.75, -8.75 + (z - 700.0) * 1.8e-3)

    g = model.grid
    state = bz.initial_state(model, theta=theta0, qt=qt0, u=u0)
    damp = jnp.exp(-g.z_c_col / 500.0)
    return state.replace(rho_theta=state.rho_theta
                         + model.reference.rho_col * jnp.asarray(noise, g.dtype) * damp)


def noise(shape, seed=1):
    nz, ny, nx = shape
    return 0.1 * np.random.default_rng(seed).standard_normal((nz, ny, nx))


def to_numpy(state):
    """A JAX ``State`` as the dict ``breeze_tpu_torch.convert`` takes."""
    out = {k: np.asarray(getattr(state, k)) for k in PROGNOSTICS
           if getattr(state, k) is not None}
    if "T_warm" in state.diagnostics:
        out["T_warm"] = np.asarray(state.diagnostics["T_warm"])
    out["time"] = float(state.time)
    return out


def max_rel_err(got, ref, skip_w0=False):
    """max|got − ref| / max|ref| (the state-relative error)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if skip_w0:
        got, ref = got[1:], ref[1:]
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
