"""The port's substrate against ``breeze_tpu`` in float64: grid metadata,
halo padding, stencil operators, the reference state, the scalar solvers,
the saturation adjustment (cold and warm start), ``diagnose`` and the
state converters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breeze_tpu as bz
import torch_parity as tp
from breeze_tpu import fields as jfl
from breeze_tpu import model as JM
from breeze_tpu.ops import StencilOps as JOps
from breeze_tpu.physics import microphysics as jmp
from breeze_tpu.thermo import reference as jref
from breeze_tpu.thermo import solvers as jsol
import breeze_tpu_torch as bt
from breeze_tpu_torch import bomex, convert
from breeze_tpu_torch import fields as tfl
from breeze_tpu_torch import model as TM
from breeze_tpu_torch.ops import StencilOps as TOps
from breeze_tpu_torch.physics import microphysics as tmp
from breeze_tpu_torch.thermo import reference as tref
from breeze_tpu_torch.thermo import solvers as tsol

F64 = torch.float64
STRETCHED_Z = np.concatenate([[0.0], np.cumsum(40.0 * 1.08 ** np.arange(10))])


def _grids(z=(0.0, 1000.0)):
    size = (8, 6, 10)
    jg = bz.make_grid(size=size, x=(0.0, 800.0), y=(0.0, 600.0), z=z,
                      topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED), dtype=jnp.float64)
    tg = bt.make_grid(size, x=(0.0, 800.0), y=(0.0, 600.0), z=z, dtype=F64, device="cpu")
    return jg, tg


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("z", [(0.0, 1000.0), STRETCHED_Z], ids=["uniform", "stretched"])
def test_grid_metadata(z):
    jg, tg = _grids(z)
    for name in ("z_c", "z_f", "dz_c", "dz_f"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    assert tg.dz_c_meta == jg.dz_c_meta and tg.dz_f_meta == jg.dz_f_meta
    assert (tg.dx, tg.dy, tg.Lz) == (jg.dx, jg.dy, jg.Lz)


@pytest.mark.parametrize("loc", ["CCC", "CCF", "CFC", "FCC"])
@pytest.mark.parametrize("halo", [1, 3])
def test_pad_matches(loc, halo):
    jg, tg = _grids()
    a = _field(tg.shape, 0)
    got = tfl.pad(torch.from_numpy(a), tg, getattr(tfl, loc), halo=halo)
    ref = jfl.pad(jnp.asarray(a), jg, getattr(jfl, loc), halo=halo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_enforce_wall_normals():
    jg, tg = _grids()
    a = _field(tg.shape, 1)
    got = tfl.enforce_wall_normals(tg, *(torch.from_numpy(a) for _ in range(3)))
    ref = jfl.enforce_wall_normals(jg, *(jnp.asarray(a) for _ in range(3)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert float(got[2][0].abs().max()) == 0.0


@pytest.mark.parametrize("op", ["dx_cf", "dy_cf", "dz_cf", "iz_cf", "div_c"])
def test_stencil_ops(op):
    jg, tg = _grids(STRETCHED_Z)
    arrays = [_field(tg.shape, s) for s in range(3)]
    locs = ("CCF", "CFC", "FCC") if op == "div_c" else ("CCC",) * 3
    tp_ = [tfl.pad(torch.from_numpy(a), tg, getattr(tfl, l), halo=3)
           for a, l in zip(arrays, locs)]
    jp_ = [jfl.pad(jnp.asarray(a), jg, getattr(jfl, l)) for a, l in zip(arrays, locs)]
    n = 3 if op == "div_c" else 1
    got = getattr(TOps(tg, halo=3), op)(*tp_[:n])
    ref = getattr(JOps(jg), op)(*jp_[:n])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("z", [(0.0, 1000.0), STRETCHED_Z], ids=["uniform", "stretched"])
@pytest.mark.parametrize("theta", [298.7, 300.0])
def test_reference_state(theta, z):
    jg, tg = _grids(z)
    c_j, c_t = bz.ThermodynamicConstants(), bt.ThermodynamicConstants()
    ref = jref.make_reference_state(jg, c_j, surface_pressure=101_500.0,
                                    potential_temperature=theta)
    got = tref.make_reference_state(tg, c_t, surface_pressure=101_500.0,
                                    potential_temperature=theta)
    for name in ("p_c", "rho_c", "T_c", "rho_f"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-14)
    assert got.potential_temperature == ref.potential_temperature


def test_solvers():
    """Newton (analytic and forward-mode slope) and secant on x³ = a."""
    a = np.linspace(1.0, 8.0, 7)
    tres = lambda x: x ** 3 - torch.from_numpy(a)
    jres = lambda x: x ** 3 - jnp.asarray(a)
    x0 = np.full(7, 2.0)
    for t_solver, j_solver in ((tsol.NewtonSolver(6), jsol.NewtonSolver(6)),
                               (tsol.SecantSolver(8), jsol.SecantSolver(8))):
        got = tsol.solve(tres, torch.from_numpy(x0), t_solver)
        ref = jsol.solve(jres, jnp.asarray(x0), j_solver)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)
    got = tsol.newton_solve(tres, torch.from_numpy(x0), 6,
                            derivative=lambda x: 3 * x ** 2)
    np.testing.assert_allclose(got.numpy(), np.cbrt(a), rtol=1e-12)


def _thermo_case(seed=7):
    """θ, qᵗ on BOMEX pressures: saturated and unsaturated points."""
    jm = tp.jax_bomex_model((6, 5, 24), jnp.float64)
    shape = jm.grid.shape
    rng = np.random.default_rng(seed)
    theta = 298.7 + 3e-3 * np.asarray(jm.grid.z_c)[:, None, None] + rng.normal(0, 0.5, shape)
    # saturated aloft, unsaturated near the surface
    qt = 0.018 * (1.0 + 0.1 * rng.normal(0, 1, shape))
    return jm, theta, qt


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm_start"])
def test_saturation_adjust(warm):
    jm, theta, qt = _thermo_case()
    p = jm.reference.p_col
    c_j, c_t = jm.constants, bt.ThermodynamicConstants()
    T_guess = (np.asarray(jmp.saturation_adjust(
        jnp.asarray(theta), jnp.asarray(qt), p, c_j, jm.microphysics)[0]) - 0.05
        if warm else None)
    T_ref, q_ref = jmp.saturation_adjust(
        jnp.asarray(theta), jnp.asarray(qt), p, c_j, jm.microphysics,
        T_guess=None if T_guess is None else jnp.asarray(T_guess))
    T_got, q_got = tmp.saturation_adjust(
        torch.from_numpy(theta), torch.from_numpy(qt), torch.tensor(np.asarray(p)),
        c_t, bt.SaturationAdjustment(),
        T_guess=None if T_guess is None else torch.from_numpy(T_guess))
    assert float(np.asarray(q_ref.liquid).max()) > 0, "the case must condense somewhere"
    np.testing.assert_allclose(T_got.numpy(), np.asarray(T_ref), rtol=1e-14)
    for g, r in zip(q_got, q_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-18)


def test_diagnose():
    size = (12, 8, 16)
    jm = tp.jax_bomex_model(size, jnp.float64)
    js = tp.jax_bomex_state(jm, tp.noise(jm.grid.shape))
    tm = bomex.bomex_model(size, dtype=F64, device="cpu")
    ts = convert.state_from_numpy(tp.to_numpy(js), dtype=F64, device="cpu")
    T_warm = js.diagnostics["T_warm"]
    ref = JM.diagnose(jm, js, T_guess=T_warm)
    got = TM.diagnose(tm, ts, T_guess=ts.diagnostics["T_warm"])
    for name in ("u", "v", "w", "theta", "qt", "T", "buoyancy_force"):
        err = tp.max_rel_err(getattr(got, name).numpy(), getattr(ref, name))
        # the buoyancy is a small residual of two O(1) terms: roundoff is
        # relative to those, not to it
        assert err < (1e-9 if name == "buoyancy_force" else 1e-13), name


def test_species_borrow():
    rng = np.random.default_rng(3)
    chain = [rng.normal(0, 1e-3, (4, 3, 5)) for _ in range(2)]
    vapor = rng.normal(1e-3, 1e-3, (4, 3, 5))
    got_chain, got_v = tmp.species_borrow([torch.from_numpy(c) for c in chain],
                                          torch.from_numpy(vapor))
    ref_chain, ref_v = jmp.species_borrow([jnp.asarray(c) for c in chain],
                                          jnp.asarray(vapor))
    for g, r in zip(got_chain + [got_v], list(ref_chain) + [ref_v]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_convert_roundtrip_and_pinned_reference():
    size = (8, 4, 10)
    jm = tp.jax_bomex_model(size, jnp.float64)
    js = tp.jax_bomex_state(jm, tp.noise(jm.grid.shape))
    arrays = tp.to_numpy(js)
    back = convert.state_to_numpy(convert.state_from_numpy(arrays, dtype=F64, device="cpu"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    r = jm.reference
    pinned = convert.reference_from_numpy(
        {k: np.asarray(getattr(r, k)) for k in convert.REFERENCE_PROFILES},
        surface_pressure=r.surface_pressure, potential_temperature=r.potential_temperature,
        standard_pressure=r.standard_pressure, dtype=F64, device="cpu")
    tm = bomex.bomex_model(size, dtype=F64, device="cpu")
    tm_pinned = TM.make_model(tm.grid, reference=pinned, advection=bt.WENO(5))
    np.testing.assert_array_equal(tm_pinned.reference.rho_c.numpy(), np.asarray(r.rho_c))
    np.testing.assert_array_equal(tm.reference.rho_f.numpy(), np.asarray(r.rho_f))


def test_outside_the_envelope_raises():
    g = bt.make_grid((8, 8, 8), extent=(1.0, 1.0, 1.0),
                     topology=(bt.BOUNDED, bt.PERIODIC, bt.BOUNDED), dtype=F64, device="cpu")
    with pytest.raises(NotImplementedError, match="periodic"):
        bt.make_model(g, advection=bt.WENO(5))
    g = bt.make_grid((8, 8, 8), extent=(1.0, 1.0, 1.0), dtype=F64, device="cpu")
    with pytest.raises(NotImplementedError, match="WENO"):
        bt.make_model(g, advection=bt.WENO(5, bounds_preserving=True))
