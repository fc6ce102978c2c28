"""The port's whole step against ``breeze_tpu`` in float64, and its
contracts: rest state exact, ∫ρθ and ∫ρqᵗ conserved, no JAX import."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from breeze_tpu.timesteppers import ssp_rk3_step as jax_step
import breeze_tpu_torch as bt
from breeze_tpu_torch import bomex, convert

F64 = torch.float64
SIZE = (32, 16, 24)


@pytest.fixture(scope="module")
def two_bomex_steps():
    """Two SSP-RK3 steps of BOMEX at (nx, ny, nz) = (32, 16, 24) through
    both packages from the same state (carried across by ``convert``)."""
    jm = tp.jax_bomex_model(SIZE, jnp.float64)
    js = tp.jax_bomex_state(jm, tp.noise(jm.grid.shape))
    tm = bomex.bomex_model(SIZE, dtype=F64, device="cpu")
    ts = convert.state_from_numpy(tp.to_numpy(js), dtype=F64, device="cpu")
    for _ in range(2):
        js = jax_step(jm, js, 1.0)
        ts = bt.ssp_rk3_step(tm, ts, 1.0)
    return ts, js


@pytest.mark.parametrize("name", tp.PROGNOSTICS + ("T_warm",))
def test_bomex_two_steps_match_jax(two_bomex_steps, name):
    ts, js = two_bomex_steps
    if name == "T_warm":
        got, ref = ts.diagnostics[name], js.diagnostics[name]
    else:
        got, ref = getattr(ts, name), getattr(js, name)
    err = tp.max_rel_err(got.numpy(), ref)
    # float64 roundoff through six stages and projections; ρv and ρw are
    # small fields, so their relative error reads ~1e-12
    assert err < 1e-9, f"{name}: relative error {err:.2e}"
    assert ts.time == float(js.time) == 2.0


def test_bomex_state_matches_jax():
    """``bomex.bomex_state`` builds bench.py's initial state (with numpy
    noise) bitwise as the JAX package does."""
    jm = tp.jax_bomex_model(SIZE, jnp.float64)
    js = tp.jax_bomex_state(jm, tp.noise(jm.grid.shape))
    tm = bomex.bomex_model(SIZE, dtype=F64, device="cpu")
    ts = bomex.bomex_state(tm, tp.noise(tm.grid.shape))
    for name in tp.PROGNOSTICS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    np.testing.assert_array_equal(ts.diagnostics["T_warm"].numpy(),
                                  np.asarray(js.diagnostics["T_warm"]))


def _moist_model(size=(8, 8, 12)):
    g = bt.make_grid(size, extent=(800.0, 800.0, 1200.0), dtype=F64, device="cpu")
    return bt.make_model(g, advection=bt.WENO(5), potential_temperature=300.0,
                         microphysics=bt.SaturationAdjustment(),
                         closure=bt.SmagorinskyLilly(), coriolis=bt.FPlane(1e-4))


def test_rest_state_exact():
    """θ = θᵣ, qᵗ uniform, at rest: stays at rest over 5 steps."""
    model = _moist_model()
    state = bt.initial_state(model, qt=5e-3)
    theta0 = state.rho_theta.clone()
    for _ in range(5):
        state = bt.ssp_rk3_step(model, state, 10.0)
    for name in ("rho_u", "rho_v", "rho_w"):
        assert float(getattr(state, name).abs().max()) < 1e-12, name
    assert float((state.rho_theta - theta0).abs().max()) < 1e-10


def test_conservation():
    """Flux-form advection, the closure's diffusive fluxes and the projection
    conserve ∫ρθ dV (1e-13) and ∫ρqᵗ dV (1e-12, through the borrowing too)."""
    model = _moist_model((16, 8, 16))
    g = model.grid
    state = bt.initial_state(
        model,
        theta=lambda x, y, z: 300.0 + 2.0 * torch.exp(-((x - 400.0) ** 2 + (z - 300.0) ** 2)
                                                        / 200.0 ** 2) + 0.0 * y,
        qt=lambda x, y, z: 0.012 * torch.exp(-z / 800.0) + 0.0 * x + 0.0 * y,
        u=lambda x, y, z: 2.0 + 0.5 * torch.sin(2 * np.pi * y / 800.0) + 0.0 * x * z)
    dz = g.dz_c_col
    totals = lambda s: (float((s.rho_theta * dz).sum()), float((s.rho_qt * dz).sum()))
    t0, q0 = totals(state)
    for _ in range(5):
        state = bt.ssp_rk3_step(model, state, 5.0)
    t1, q1 = totals(state)
    np.testing.assert_allclose(t1, t0, rtol=1e-13)
    np.testing.assert_allclose(q1, q0, rtol=1e-12)
    assert float(state.rho_w.abs().max()) > 1e-3, "the case must move"


def test_port_imports_no_jax():
    """A process in which JAX and the JAX package cannot be imported builds
    a model and runs one step of the port."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["breeze_tpu"] = None
        import torch
        import breeze_tpu_torch as bt
        from breeze_tpu_torch import bomex
        model = bomex.bomex_model((8, 8, 8), dtype=torch.float32, device="cpu")
        state = bt.ssp_rk3_step(model, bomex.bomex_state(model, 0.0), 1.0)
        assert bool(torch.isfinite(state.rho_theta).all())
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "breeze_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
