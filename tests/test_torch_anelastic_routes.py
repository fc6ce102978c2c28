"""The anelastic routes outside the fused tendency kernel, against the JAX
package.

- the column-momentum kernel (``kernels.momentum.momentum_div_cols``), the
  projection kernels (``kernels.projection``) and the closure kernel
  (``kernels.closure``): their plain versions against
  ``momentum_div_pallas_cols``, ``divergence_pallas`` /
  ``gradient_correct_pallas`` and ``closure_tendencies_pallas`` in
  interpret mode, in float32, at the reference tests' sizes and limits;
- the closure kernel's plain version, the β-plane Coriolis and the
  pressure projection (through the projection kernels' plain versions)
  against ``breeze_tpu``'s jnp forms, and two SSP-RK3 steps of BOMEX on
  the β-plane (the unfused route) against ``breeze_tpu``'s jnp route, in
  float64;
- the envelope ``make_model`` keeps.

The CUDA kernels against their plain versions are in ``test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breeze_tpu as bz
import torch_parity as tp
from breeze_tpu import fields as jfl
from breeze_tpu import model as JM
from breeze_tpu.ops import StencilOps as JStencilOps
from breeze_tpu.pallas_kernels import advection as padv
from breeze_tpu.physics.closures import SmagorinskyLilly as JSmag
from breeze_tpu.physics.closures import closure_tendencies as jax_closure_tendencies
from breeze_tpu.physics.coriolis import coriolis_terms as jax_coriolis_terms
from breeze_tpu.model import pressure_projection as jax_pressure_projection
from breeze_tpu.timesteppers import ssp_rk3_step as jax_step
import breeze_tpu_torch as bt
from breeze_tpu_torch import bomex, convert
from breeze_tpu_torch import fields as tfl
from breeze_tpu_torch import model as TM
from breeze_tpu_torch.kernels import closure, momentum, projection
from breeze_tpu_torch.ops import StencilOps
from breeze_tpu_torch.physics.coriolis import coriolis_terms

F32, F64 = torch.float32, torch.float64
BETA = bomex.BETA_PLANE
JAX_BETA = bz.BetaPlane(f0=BETA.f0, beta=BETA.beta, y0=BETA.y0)


def _grids(size, extent, dtype, z=None):
    """The same (nx, ny, nz) grid in both packages, z uniform over
    ``extent`` or at the face heights ``z``."""
    kw = dict(x=(0.0, extent[0]), y=(0.0, extent[1]),
              z=(0.0, extent[2]) if z is None else z)
    jg = bz.make_grid(size=size, topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED), halo=3,
                      dtype=jnp.float32 if dtype == F32 else jnp.float64, **kw)
    return jg, bt.make_grid(size, dtype=dtype, device="cpu", **kw)


def _stretched_z(nz, top):
    return np.asarray(bz.piecewise_stretched_z(nz, surface_layer_height=0.25 * top,
                                               surface_layer_spacing=top / (2 * nz), top=top))


def _window(tg, a, loc):
    return tfl.pad(torch.tensor(np.asarray(a)), tg, getattr(tfl, loc), halo=3, axes=(0, 1))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# ---------------------------------------------------------------------------
# The column-momentum kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stretched", [False, True], ids=["uniform", "stretched"])
def test_momentum_div_cols_plain_matches_pallas_interpret(stretched):
    """``TestFusedMomentum.test_cols_variant_matches_jnp_path``'s case, each
    package forming ρᵣ(z)·u from its own padded reference columns."""
    from breeze_tpu.pallas_kernels import momentum as pmom
    size, extent = (128, 32, 8), (1000.0, 500.0, 300.0)
    jg, tg = _grids(size, extent, F32, _stretched_z(8, 300.0) if stretched else None)
    jm = bz.make_model(jg, advection=bz.WENO(5), potential_temperature=300.0)
    tm = bt.make_model(tg, advection=bt.WENO(5), potential_temperature=300.0)
    rng = np.random.default_rng(0)
    u, v, w = (rng.normal(0.0, sd, jg.shape).astype(np.float32) for sd in (2.0, 2.0, 1.0))
    w[0] = 0.0
    pz = lambda a, loc: padv.pad_zy(jnp.asarray(a), jg, getattr(jfl, loc))
    colc, colf = JM._padded_reference_columns(jm, halo=pmom.H)
    ref = pmom.momentum_div_pallas_cols(jg, pz(u, "CCF"), pz(v, "CFC"), pz(w, "FCC"),
                                        colc, colf, interpret=True)
    cols = tm.tendency_columns
    np.testing.assert_allclose(cols.colf.numpy(), np.asarray(colf).reshape(-1), rtol=1e-6)
    got = momentum.momentum_div_cols(
        _window(tg, u, "CCF"), _window(tg, v, "CFC"), _window(tg, w, "FCC"),
        cols.colc, cols.colf, cols.invdzc, cols.invdzf, 1.0 / tg.dx, 1.0 / tg.dy)
    for name, a, b in zip("uvw", got, ref):
        a, b = a.numpy(), np.asarray(b)
        if name == "w":
            a, b = a[1:], b[1:]     # wall row k = 0 is overwritten by the stepper
        # TestFusedMomentum's limit
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# The projection kernels
# ---------------------------------------------------------------------------

def _projection_case(stretched, dtype=F32):
    """``TestFusedProjection``'s (128, 16, 16) grid and model, uniform or
    stretched in z, with N(0, 1) momenta (ρw off the bottom face) and φ."""
    z = _stretched_z(16, 1600.0) if stretched else None
    jg, tg = _grids((128, 16, 16), (12800.0, 1600.0, 1600.0), dtype, z)
    jm = bz.make_model(jg, advection=bz.WENO(5), potential_temperature=300.0)
    tm = bt.make_model(tg, advection=bt.WENO(5), potential_temperature=300.0)
    rng = np.random.default_rng(2 if stretched else 1)
    npdt = np.float32 if dtype == F32 else np.float64
    ru, rv, rw, phi = (rng.normal(size=jg.shape).astype(npdt) for _ in range(4))
    rw[0] = 0.0
    return jg, jm, tm, ru, rv, rw, phi


@pytest.mark.parametrize("stretched", [False, True], ids=["uniform", "stretched"])
def test_divergence_plain_matches_pallas_interpret(stretched):
    from breeze_tpu.pallas_kernels.projection import divergence_pallas
    jg, _, tm, ru, rv, rw, _ = _projection_case(stretched)
    ref = np.asarray(divergence_pallas(jg, jnp.asarray(ru), jnp.asarray(rv), jnp.asarray(rw),
                                       interpret=True))
    t = torch.from_numpy
    got = projection.divergence(t(ru), t(rv), t(rw), tm.tendency_columns.invdzc,
                                tm.tendency_config.inv_dx, tm.tendency_config.inv_dy).numpy()
    # TestFusedProjection's limits (the stretched case's atol is its own)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4 if stretched else 1e-5)


@pytest.mark.parametrize("stretched", [False, True], ids=["uniform", "stretched"])
def test_gradient_correct_plain_matches_pallas_interpret(stretched):
    from breeze_tpu.pallas_kernels.projection import gradient_correct_pallas
    jg, jm, tm, ru, rv, rw, phi = _projection_case(stretched)
    dt = 0.5
    ref = gradient_correct_pallas(jg, *(jnp.asarray(a) for a in (phi, ru, rv, rw)),
                                  jm.reference.rho_col[:, 0, 0],
                                  jm.reference.rho_f_col[: jg.nz, 0, 0], dt, interpret=True)
    t = torch.from_numpy
    nz = tm.grid.nz
    got = projection.gradient_correct(t(phi), t(ru), t(rv), t(rw), tm.reference.rho_c,
                                      tm.reference.rho_f[:nz], tm.tendency_columns.invdzf,
                                      tm.tendency_config.inv_dx, tm.tendency_config.inv_dy, dt)
    for name, a, b in zip(("rho_u", "rho_v", "rho_w"), got, ref):
        # TestFusedProjection's limit; the bottom face of ρw is pinned in both
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5, err_msg=name)
    assert not got[2][0].any()


@pytest.mark.parametrize("stretched", [False, True], ids=["uniform", "stretched"])
def test_pressure_projection_matches_jnp_f64(stretched):
    """The model's projection (wall normals, the divergence kernel, the
    Poisson solve, the gradient kernel) against ``breeze_tpu``'s jnp
    projection, in float64; ρw arrives noisy on its bottom face."""
    jg, jm, tm, ru, rv, rw, _ = _projection_case(stretched, F64)
    rw[0] = 1.0
    ref = jax_pressure_projection(jm, *(jnp.asarray(a) for a in (ru, rv, rw)), 0.75)
    got = TM.pressure_projection(tm, *(torch.from_numpy(a) for a in (ru, rv, rw)), 0.75)
    for name, a, b in zip(("rho_u", "rho_v", "rho_w", "phi"), got, ref):
        # float64 roundoff: the kernels multiply by 1/Δz where the jnp
        # stencils divide by Δz
        assert tp.max_rel_err(a.numpy(), np.asarray(b)) < 1e-10, name
    assert not got[2][0].any()


# ---------------------------------------------------------------------------
# The closure kernel
# ---------------------------------------------------------------------------

def _closure_case(moist, dtype):
    """``TestClosureKernel._setup``'s (128, 32, 16) state through the JAX
    package, the port's model on the same grid, and the JAX diagnostics."""
    jg, tg = _grids((128, 32, 16), (12800.0, 3200.0, 1600.0), dtype)
    jmicro = bz.SaturationAdjustment(equilibrium=bz.WarmPhaseEquilibrium()) if moist else None
    jm = bz.make_model(jg, advection=bz.WENO(5), potential_temperature=300.0,
                       closure=JSmag(), microphysics=jmicro)
    tm = bt.make_model(tg, advection=bt.WENO(5), potential_temperature=300.0,
                       closure=bt.SmagorinskyLilly(),
                       microphysics=bt.SaturationAdjustment() if moist else None)
    state = bz.initial_state(
        jm, theta=lambda x, y, z: 300.0 + 1.0 * jnp.exp(
            -((x - 6400.0) ** 2 / 1500.0 ** 2 + (z - 800.0) ** 2 / 300.0 ** 2)),
        qt=(lambda x, y, z: 0.012 * jnp.exp(-z / 800.0)) if moist else None,
        u=lambda x, y, z: 3.0 + 0.5 * jnp.sin(2 * jnp.pi * y / 3200.0)
        + 0.3 * jnp.sin(2 * jnp.pi * z / 1600.0),
        w=lambda x, y, z: 0.2 * jnp.sin(2 * jnp.pi * x / 12800.0) * jnp.sin(jnp.pi * z / 1600.0),
        enforce_mass_conservation=False)
    return jg, jm, tm, JM.diagnose(jm, state)


def _thb(model, aux):
    c = model.constants
    return aux.theta * (1.0 + (c.Rv / c.Rd - 1.0) * aux.q.vapor - aux.q.liquid - aux.q.ice)


def _port_closure_windows(tm, aux, moist):
    """The closure kernel's windows in the port from the JAX diagnostics."""
    tg = tm.grid
    scalars = [_window(tg, aux.theta, "CCC")]
    if moist:
        scalars.append(_window(tg, aux.qt, "CCC"))
    thb = _window(tg, _thb(tm, aux), "CCC") if moist else scalars[0]
    return (_window(tg, aux.u, "CCF"), _window(tg, aux.v, "CFC"), _window(tg, aux.w, "FCC"),
            thb, scalars)


@pytest.mark.parametrize("moist", [False, True], ids=["dry", "moist"])
def test_closure_plain_matches_pallas_interpret(moist):
    from breeze_tpu.pallas_kernels import closure as pclo
    jg, jm, tm, aux = _closure_case(moist, F32)
    pz = lambda a, loc: padv.pad_zy(a, jg, getattr(jfl, loc))
    ref = pclo.closure_tendencies_pallas(
        jm, pz(aux.u, "CCF"), pz(aux.v, "CFC"), pz(aux.w, "FCC"), pz(aux.theta, "CCC"),
        pz(aux.qt, "CCC") if moist else None, pz(_thb(jm, aux), "CCC") if moist else None,
        interpret=True)
    got = closure.closure_tendencies(tm.tendency_config, tm.tendency_columns,
                                     *_port_closure_windows(tm, aux, moist))
    assert len(got) == (5 if moist else 4)
    for name, a, b in zip(("G_u", "G_v", "G_w", "G_theta", "G_qt"), got, ref):
        a, b = a.numpy(), np.asarray(b)
        if name == "G_w":
            a, b = a[1:], b[1:]     # row 0 is overwritten by the wall condition
        # TestClosureKernel's limit: 2e-4 of each output's largest value
        assert _rel(a, b) < 2e-4, f"{name}: {_rel(a, b):.2e}"


@pytest.mark.parametrize("moist", [False, True], ids=["dry", "moist"])
def test_closure_tendencies_match_jnp_f64(moist):
    """The closure kernel's plain version, which the unfused route runs on
    CPU tensors, against ``breeze_tpu``'s jnp closure, which the
    reference's unfused route runs, in float64."""
    jg, jm, tm, aux = _closure_case(moist, F64)
    ref = jax_closure_tendencies(jm, jm.stencil_ops(), aux, jfl.pad(aux.u, jg, jfl.CCF),
                                 jfl.pad(aux.v, jg, jfl.CFC), jfl.pad(aux.w, jg, jfl.FCC))
    kern = closure.closure_tendencies_plain(tm.tendency_config, tm.tendency_columns,
                                            *_port_closure_windows(tm, aux, moist))
    names = ("G_u", "G_v", "G_w", "G_theta") + (("G_qt",) if moist else ())
    for k, name in enumerate(names):
        r, kn = np.asarray(getattr(ref, name)), kern[k].numpy()
        if name == "G_w":
            r, kn = r[1:], kn[1:]   # row 0 is overwritten by the wall condition
        # float64 roundoff
        assert _rel(kn, r) < 1e-10, f"{name}: {_rel(kn, r):.2e}"


def test_beta_plane_coriolis_matches_jnp_f64():
    jg, tg = _grids((16, 12, 8), bomex.EXTENT, F64)
    rng = np.random.default_rng(4)
    ru, rv, rw = (rng.normal(size=jg.shape) for _ in range(3))
    jso, so = JStencilOps(jg), StencilOps(tg, halo=1)
    ref = jax_coriolis_terms(JAX_BETA, jso, *(jfl.pad(jnp.asarray(a), jg, loc) for a, loc in
                                             ((ru, jfl.CCF), (rv, jfl.CFC), (rw, jfl.FCC))), jg)
    got = coriolis_terms(BETA, so, *(tfl.pad(torch.from_numpy(a), tg, loc, halo=1)
                                     for a, loc in ((ru, tfl.CCF), (rv, tfl.CFC),
                                                    (rw, tfl.FCC))), tg)
    for a, b in zip(got[:2], ref[:2]):
        assert _rel(a.numpy(), b) < 1e-14
    assert got[2] == ref[2] == 0.0


# ---------------------------------------------------------------------------
# BOMEX on the β-plane: the unfused route, two steps, float64
# ---------------------------------------------------------------------------

SIZE = (32, 16, 24)


@pytest.fixture(scope="module")
def two_beta_steps():
    """Two SSP-RK3 steps of BOMEX on the β-plane through both packages from
    the same state; the JAX side eagerly (compiling its step dominates)."""
    jm = dataclasses.replace(tp.jax_bomex_model(SIZE, jnp.float64), coriolis=JAX_BETA)
    tm = bomex.bomex_model(SIZE, dtype=F64, device="cpu", coriolis=BETA)
    assert not tm.fused
    with jax.disable_jit():
        js = tp.jax_bomex_state(jm, tp.noise(jm.grid.shape))
        ts = convert.state_from_numpy(tp.to_numpy(js), dtype=F64, device="cpu")
        for _ in range(2):
            js = jax_step(jm, js, 1.0)
            ts = bt.ssp_rk3_step(tm, ts, 1.0)
    return ts, js


@pytest.mark.parametrize("name", tp.PROGNOSTICS + ("T_warm",))
def test_beta_plane_bomex_two_steps_match_jax(two_beta_steps, name):
    ts, js = two_beta_steps
    if name == "T_warm":
        got, ref = ts.diagnostics[name], js.diagnostics[name]
    else:
        got, ref = getattr(ts, name), getattr(js, name)
    err = tp.max_rel_err(got.numpy(), ref)
    # test_torch_slice's limit: float64 roundoff through six stages and
    # projections, ρv and ρw small fields
    assert err < 1e-9, f"{name}: relative error {err:.2e}"


def test_beta_plane_differs_from_fplane():
    """β·(y − y₀) reaches 7e-8 s⁻¹ at the domain's edges: the β-plane step
    must move ρv off the f-plane step by more than roundoff."""
    noise = tp.noise((12, 8, 16))
    states = []
    for coriolis in (None, BETA):
        m = bomex.bomex_model((16, 8, 12), dtype=F64, device="cpu", coriolis=coriolis)
        states.append(bt.ssp_rk3_step(m, bomex.bomex_state(m, noise), 1.0))
    assert tp.max_rel_err(states[1].rho_v.numpy(), states[0].rho_v.numpy()) > 1e-8


# ---------------------------------------------------------------------------
# The envelope, the wrappers, the defaults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(advection=bt.WENO(5, bounds_preserving=True)), "WENO"),
    (dict(coriolis=object()), "Coriolis"),
    (dict(coriolis=BETA, closure=object()), "closure"),
    (dict(coriolis=BETA, microphysics=object()), "microphysics")],
    ids=["bounds_preserving", "other_coriolis", "other_closure_off_the_fused_route",
         "other_microphysics_off_the_fused_route"])
def test_make_model_refuses_outside_the_envelope(kw, match):
    g = bt.make_grid((8, 8, 8), extent=bomex.EXTENT, dtype=F64, device="cpu")
    kw = {"advection": bt.WENO(5), **kw}
    with pytest.raises(NotImplementedError, match=match):
        bt.make_model(g, **kw)


def test_routes_are_selected_by_the_envelopes():
    g = bt.make_grid((8, 8, 8), extent=bomex.EXTENT, dtype=F64, device="cpu")
    for coriolis, fused in ((None, True), (bt.FPlane(1e-4), True), (BETA, False)):
        assert bt.make_model(g, advection=bt.WENO(5), coriolis=coriolis).fused is fused
    assert TM.momentum_supported(g, bt.WENO(5))
    assert TM.scalar_supported(g, bt.WENO(5, bounds_preserving=True))
    assert not TM.momentum_supported(g, bt.WENO(5, bounds_preserving=True))
    assert not TM.fused_supported(g, bt.WENO(5), bt.WENO(5), BETA)


def test_new_kernels_refuse_other_devices():
    """Only CPU tensors take the plain versions; any other device must
    launch the kernel or raise."""
    model = bomex.bomex_model((8, 8, 8), device="cpu")
    cfg, cols = model.tendency_config, model.tendency_columns
    meta = lambda *shape: torch.empty(shape, device="meta")
    win, f, col = meta(14, 14, 8), meta(8, 8, 8), meta(8)
    with pytest.raises(ValueError, match="CUDA"):
        momentum.momentum_div_cols(win, win, win, cols.colc, cols.colf, cols.invdzc,
                                   cols.invdzf, cfg.inv_dx, cfg.inv_dy)
    with pytest.raises(ValueError, match="CUDA"):
        projection.divergence(f, f, f, col, 1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        projection.gradient_correct(f, f, f, f, col, col, col, 1.0, 1.0, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        closure.closure_tendencies(cfg, cols, win, win, win, win, [win, win])


def test_bomex_model_defaults_to_float32():
    model = bomex.bomex_model((8, 8, 8), device="cpu")
    assert model.grid.dtype == F32 and model.fused
    assert isinstance(model.coriolis, bt.FPlane)
