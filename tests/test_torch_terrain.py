"""The port's compressible core over terrain against ``breeze_tpu``, on the
CPU: the σ-coordinate metrics and reference, the slow tendencies over
terrain, the acoustic loop's terrain and sponge branches (the plain version
of the CUDA kernel) and two ridge steps, in float64 to roundoff; the plain
loop against the Pallas kernel in interpret mode in float32.

The JAX reference runs under ``jax.disable_jit()``: its acoustic substep
loop is a ``fori_loop`` whose XLA:CPU compile has crashed test workers, and
eager execution gives the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breeze_tpu as bz
from breeze_tpu import fields as jfl
from breeze_tpu.dynamics import compressible as JC
from breeze_tpu.dynamics import terrain as JT
import torch_parity as tp
import breeze_tpu_torch as bt
from breeze_tpu_torch import convert, ridge
from breeze_tpu_torch import fields as tfl
from breeze_tpu_torch.dynamics import compressible as TC
from breeze_tpu_torch.dynamics import terrain as TT
from breeze_tpu_torch.kernels import acoustic
from breeze_tpu_torch.ops import StencilOps

NAMES = ("rho", "rho_u", "rho_v", "rho_w", "rho_theta")
#: (32, 16, 16) over 1600 × 800 × 800 m: Δx = 50 m, so N = 7 substeps at
#: Δt = 0.5 s, as at 256 × 256 × 128 over 12.8 km
SIZE, EXTENT, DT = (32, 16, 16), (1600.0, 800.0, 800.0), 0.5
#: the SLEVE decay heights, the reference test's (800, 400 m over 1.6 km)
#: scaled to this 800 m domain
SLEVE = dict(large_scale_height=400.0, small_scale_height=200.0)
SPONGE = dict(damping_rate=0.2, depth=300.0, ramp="cubic")


def hill(x, y):
    """A ridge that varies in y (so that every y-slope term acts), as the
    reference's terrain kernel test makes its own."""
    return (60.0 / (1.0 + ((x - 800.0) / 200.0) ** 2)
            * (1.0 + 0.3 * np.sin(2.0 * np.pi * y / EXTENT[1])))


def _z_faces(stretched):
    if not stretched:
        return (0.0, EXTENT[2])
    dz = 30.0 * 1.06 ** np.arange(SIZE[2])
    return np.concatenate([[0.0], np.cumsum(dz)])


def _models(kind="linear", sponge=None, damping=0.1, stretched=False):
    """The hill configuration through both packages, float64.  ``kind``:
    ``linear`` (LinearDecay) or ``sleve``; ``sponge``: None or the
    ``damp_full`` flag of an upper sponge."""
    x, y, z = (0.0, EXTENT[0]), (0.0, EXTENT[1]), _z_faces(stretched)
    kw = SLEVE if kind == "sleve" else {}
    jg = bz.make_grid(size=SIZE, x=x, y=y, z=z,
                      topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED), halo=3,
                      dtype=jnp.float64)
    jm = JC.make_compressible_model(
        jg, advection=bz.WENO(5), coriolis=bz.FPlane(1e-4),
        terrain=JT.make_terrain(jg, bz.ThermodynamicConstants(), hill, **kw),
        time_discretization=JC.SplitExplicitTimeDiscretization(
            acoustic_cfl=0.5, damping_coefficient=damping,
            sponge=None if sponge is None else JC.UpperSponge(**SPONGE, damp_full=sponge)))
    tg = bt.make_grid(SIZE, x=x, y=y, z=z, dtype=torch.float64, device="cpu")
    tm = TC.make_compressible_model(
        tg, advection=bt.WENO(5), coriolis=bt.FPlane(1e-4),
        terrain=TT.make_terrain(tg, bt.ThermodynamicConstants(), hill, **kw),
        time_discretization=TC.SplitExplicitTimeDiscretization(
            acoustic_cfl=0.5, damping_coefficient=damping,
            sponge=None if sponge is None else TC.UpperSponge(**SPONGE, damp_full=sponge)))
    return jm, tm


def _noisy_state(jm, seed=4):
    """The bubble over the hill with noise on the momenta and ρθ, ρw on
    the surface face from the kinematic bottom."""
    cx, cy, cz = 0.5 * EXTENT[0], 0.5 * EXTENT[1], 0.25 * EXTENT[2]
    js = JC.compressible_initial_state(jm, theta=lambda x, y, z: 300.0 + 0.5 * jnp.exp(
        -((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / 500.0 ** 2))
    rng = np.random.default_rng(seed)
    noise = lambda sd: jnp.asarray(rng.normal(0.0, sd, jm.grid.shape))
    rho_u, rho_v = js.rho_u + noise(0.5), js.rho_v + noise(0.5)
    rho_w = (js.rho_w + noise(0.2)).at[0].set(
        JT.kinematic_bottom_rho_w(jm.terrain, jm.stencil_ops(), rho_u, rho_v))
    return js.replace(rho_u=rho_u, rho_v=rho_v, rho_w=rho_w,
                      rho_theta=js.rho_theta + noise(0.05))


def _to_torch(js):
    return convert.compressible_state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in NAMES}, dtype=torch.float64, device="cpu")


def _rel(got, ref, skip_w0=False):
    return tp.max_rel_err(got.numpy() if isinstance(got, torch.Tensor) else got,
                          np.asarray(ref), skip_w0=skip_w0)


@pytest.mark.parametrize("kind,smoothing", [("linear", 0), ("linear", 3), ("sleve", 0)],
                         ids=["linear", "linear_smoothed", "sleve"])
def test_make_terrain_matches(kind, smoothing):
    """Every metric field and the per-column hydrostatic reference."""
    x, y, z = (0.0, EXTENT[0]), (0.0, EXTENT[1]), _z_faces(True)
    kw = dict(SLEVE if kind == "sleve" else {}, smoothing_passes=smoothing)
    jg = bz.make_grid(size=SIZE, x=x, y=y, z=z, halo=3, dtype=jnp.float64)
    tg = bt.make_grid(SIZE, x=x, y=y, z=z, dtype=torch.float64, device="cpu")
    jt = JT.make_terrain(jg, bz.ThermodynamicConstants(), hill, **kw)
    tt = TT.make_terrain(tg, bt.ThermodynamicConstants(), hill, **kw)
    assert tt.height == jt.height
    for name, got in convert.terrain_to_numpy(tt).items():
        ref = getattr(jt, name)
        if ref is None:
            assert got is None and kind == "linear", name
            continue
        assert got.shape == ref.shape, name
        assert _rel(got, ref) < 1e-13, name
    for name in ("jac_c3", "jac_xf3", "jac_yf3", "jac_cf3", "h_total"):
        assert _rel(getattr(tt, name), getattr(jt, name)) < 1e-13, name
    for at_zface in (False, True):
        assert _rel(tt.slope_x(at_zface), jt.slope_x(at_zface)) < 1e-13
        assert _rel(tt.slope_y(at_zface), jt.slope_y(at_zface)) < 1e-13


def test_make_terrain_refuses_latlon():
    """The port's grids are Cartesian; lat-lon terrain is not ported."""
    import types
    with pytest.raises(NotImplementedError):
        TT.make_terrain(types.SimpleNamespace(is_latlon=True), bt.ThermodynamicConstants(), hill)


def test_make_terrain_refuses_folded_levels():
    tg = bt.make_grid(SIZE, extent=EXTENT, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="fold"):
        TT.make_terrain(tg, bt.ThermodynamicConstants(), lambda x, y: 5.0 * hill(x, y),
                        large_scale_height=100.0, small_scale_height=50.0)


@pytest.mark.parametrize("kind", ["linear", "sleve"])
def test_terrain_helpers_match(kind):
    """ρw̃, the kinematic bottom, the slope-corrected gradients and the
    acoustic loop's metric factors."""
    jm, tm = _models(kind, stretched=True)
    js = _noisy_state(jm)
    ts = _to_torch(js)
    jso, tso = jm.stencil_ops(), StencilOps(tm.grid, halo=1)
    jrw = JT.contravariant_rho_w(jm.terrain, jso, jfl.pad(js.rho_u, jm.grid, jfl.CCF),
                                 jfl.pad(js.rho_v, jm.grid, jfl.CFC), js.rho_w)
    trw = TT.contravariant_rho_w(tm.terrain, tso, tfl.pad(ts.rho_u, tm.grid, tfl.CCF, 1),
                                 tfl.pad(ts.rho_v, tm.grid, tfl.CFC, 1), ts.rho_w)
    assert _rel(trw, jrw) < 1e-13
    assert _rel(TT.kinematic_bottom_rho_w(tm.terrain, ts.rho_u, ts.rho_v),
                JT.kinematic_bottom_rho_w(jm.terrain, jso, js.rho_u, js.rho_v)) < 1e-13
    p = JC.eos_pressure(jm, js.rho_theta) - jm.terrain.p_ref
    jg = JT.terrain_pressure_gradients(jm.terrain, jso, jfl.pad(p, jm.grid, jfl.CCC))
    tg = TT.terrain_pressure_gradients(tm.terrain, tso,
                                       tfl.pad(torch.tensor(np.asarray(p)), tm.grid, tfl.CCC, 1))
    for got, ref in zip(tg, jg):
        assert _rel(got, ref) < 1e-13
    for got, ref in zip(tm.acoustic_metrics, JC.terrain_metric_fields(jm.terrain)):
        assert got.shape == ref.shape
        assert _rel(got, ref) < 1e-13


@pytest.mark.parametrize("kind", ["linear", "sleve"])
def test_terrain_slow_tendencies_match(kind):
    """The momentum and scalar kernels' plain versions on the J-weighted
    fluxes and ρw̃, Coriolis, the slope-corrected frozen PGF and the
    imbalance against the 3-D reference, against the jnp path."""
    jm, tm = _models(kind, stretched=True)
    js = _noisy_state(jm)
    ts = _to_torch(js)
    jG = JT.terrain_slow_tendencies(jm, jm.terrain, js, JC.compressible_diagnose(jm, js))
    tG = TC.stage_slow_tendencies(tm, ts, TC.compressible_diagnose(tm, ts))
    for name in NAMES:
        # row 0 of ρw is the kinematic bottom's in the substeps; float64
        # roundoff, amplified in the WENO weights of the small momenta
        err = _rel(getattr(tG, name), getattr(jG, name), skip_w0=name == "rho_w")
        assert err < 1e-11, f"{name}: {err:.2e}"


@pytest.mark.parametrize("kind,sponge,damping,gate_first", [
    ("linear", None, 0.1, True), ("sleve", None, 0.1, True),
    ("linear", True, 0.1, True), ("sleve", False, 0.1, False),
    ("linear", None, 0.0, False)],
    ids=["linear", "sleve", "linear_sponge_full", "sleve_sponge_perturbation",
         "linear_no_damping"])
def test_terrain_acoustic_stage_matches_jnp_loop(kind, sponge, damping, gate_first):
    """One stage of 7 plain substeps against ``acoustic_substep_loop`` with
    terrain (and a sponge, damping the contravariant ρw̃ᴸ too or the
    perturbation only), noise on the five perturbations."""
    jm, tm = _models(kind, sponge=sponge, damping=damping, stretched=True)
    js = _noisy_state(jm)
    ts = _to_torch(js)
    rng = np.random.default_rng(7)
    pj = JC.Perturbations(*(jnp.asarray(rng.normal(0.0, 1e-3, jm.grid.shape))
                            for _ in range(5)), *(jnp.zeros(jm.grid.shape),) * 3)
    aux = JC.compressible_diagnose(jm, js)
    rho_w_L = None
    if sponge:
        rho_w_L = JT.contravariant_rho_w(jm.terrain, jm.stencil_ops(),
                                         jfl.pad(js.rho_u, jm.grid, jfl.CCF),
                                         jfl.pad(js.rho_v, jm.grid, jfl.CFC), js.rho_w)
    with jax.disable_jit():
        ref = JC.acoustic_substep_loop(
            jm, JC.stage_caches(jm, js, aux),
            JT.terrain_slow_tendencies(jm, jm.terrain, js, aux), pj, DT / 7, 7,
            gate_first=gate_first, terrain=jm.terrain, rho_w_L=rho_w_L)
    taux = TC.compressible_diagnose(tm, ts)
    t_rho_w_L = TC.sponge_rho_w_L(tm, ts)
    assert (t_rho_w_L is None) == (rho_w_L is None)
    got = acoustic.acoustic_substeps(
        tm.acoustic_config, tm.z_columns, TC.stage_caches(tm, ts, taux),
        TC.stage_slow_tendencies(tm, ts, taux),
        acoustic.Perturbations(*(torch.tensor(np.asarray(a)) for a in pj)),
        DT / 7, 7, gate_first, metrics=tm.acoustic_metrics, rho_w_L=t_rho_w_L)
    for name in acoustic.Perturbations._fields:
        err = _rel(getattr(got, name), getattr(ref, name))
        assert err < 1e-10, f"{name}: {err:.2e}"


def _pallas_stage(terrain, sponge=None):
    """``TestFusedAcousticSubstep.setup``'s (128, 8, 16) float32 stage over
    its y-varying terrain (with an upper sponge of 600 m when ``sponge``):
    the JAX model, caches, slow tendencies, noisy perturbations and the
    stage-entry ρw̃ᴸ."""
    ny = 8
    g = bz.make_grid(size=(128, ny, 16), extent=(12800.0, 100.0 * ny, 1600.0),
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED), halo=3,
                     dtype=jnp.float32)
    kw = {"large_scale_height": 800.0, "small_scale_height": 400.0} if terrain == "sleve" else {}
    terr = JT.make_terrain(g, bz.ThermodynamicConstants(),
                           lambda x, y: 120.0 / (1.0 + ((x - 6400.0) / 1500.0) ** 2)
                           * (1.0 + 0.3 * np.sin(2 * np.pi * y / (100.0 * ny))), **kw)
    model = JC.make_compressible_model(
        g, advection=bz.Centered(2), terrain=terr,
        time_discretization=JC.SplitExplicitTimeDiscretization(
            substeps=4, sponge=JC.UpperSponge(depth=600.0) if sponge else None))
    state = JC.compressible_initial_state(
        model, theta=lambda x, y, z: 300.0 + 1.0 * jnp.exp(
            -((x - 6400.0) ** 2 / 1500.0 ** 2 + (z - 800.0) ** 2 / 300.0 ** 2)),
        u=lambda x, y, z: 3.0 + 0 * x, pressure_balanced=False)
    aux = JC.compressible_diagnose(model, state)
    rng = np.random.default_rng(0)
    pert = [(rng.normal(size=g.shape) * 1e-3).astype(np.float32) for _ in range(5)]
    pert[3][0] = 0.0
    zero = np.zeros(g.shape, np.float32)
    rho_w_L = JT.contravariant_rho_w(terr, model.stencil_ops(), jfl.pad(state.rho_u, g, jfl.CCF),
                                     jfl.pad(state.rho_v, g, jfl.CFC), state.rho_w)
    return (model, JC.stage_caches(model, state, aux), JC.slow_tendencies(model, state, aux),
            JC.Perturbations(*(jnp.asarray(a) for a in pert + [zero] * 3)), rho_w_L)


@pytest.mark.parametrize("terrain,sponge", [(True, False), ("sleve", False), (True, True)],
                         ids=["linear", "sleve", "linear_sponge_full"])
def test_terrain_plain_matches_pallas_interpret(terrain, sponge):
    """The plain loop against K3's terrain branch in interpret mode, in
    float32, on the reference test's two terrain cases, and on terrain with
    the full-field upper sponge, which the reference's own tests leave out:
    the same caches, G, metrics and ρw̃ᴸ go through the converters."""
    from breeze_tpu.pallas_kernels.acoustic import acoustic_substep_loop_pallas
    model, caches, G, pert, rho_w_L = _pallas_stage(terrain, sponge)
    rho_w_L = rho_w_L if sponge else None
    ref = acoustic_substep_loop_pallas(model, caches, G, pert, 0.5, 3, gate_first=True,
                                       interpret=True, rho_w_L=rho_w_L)
    g = model.grid
    tg = bt.make_grid((g.nx, g.ny, g.nz), extent=(g.Lx, g.Ly, g.Lz), dtype=torch.float32,
                      device="cpu")
    tm = bt.make_compressible_model(
        tg, advection=bt.WENO(5), time_discretization=bt.SplitExplicitTimeDiscretization(
            sponge=TC.UpperSponge(depth=600.0) if sponge else None))
    terr = convert.terrain_from_numpy(
        {k: None if getattr(model.terrain, k) is None else np.asarray(getattr(model.terrain, k))
         for k in convert.TERRAIN_FIELDS},
        height=model.terrain.height, dtype=torch.float32, device="cpu")
    t = lambda a: None if a is None else torch.tensor(np.asarray(a))   # C_rho, rho_qt
    got = acoustic.acoustic_substeps(
        tm.acoustic_config, tm.z_columns,
        TC.StageCaches(*(t(getattr(caches, k)) for k in TC.StageCaches._fields)),
        TC.SlowTendencies(*(t(getattr(G, k)) for k in TC.SlowTendencies._fields)),
        acoustic.Perturbations(*(t(a) for a in pert)), 0.5, 3, True,
        metrics=TC.terrain_metric_fields(terr),
        rho_w_L=None if rho_w_L is None else t(rho_w_L))
    for name in acoustic.Perturbations._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        # TestFusedAcousticSubstep's limit: float32, the Pallas kernel
        # divides twice in the sweep where the plain loop multiplies by 1/den
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-10)
        assert err < 5e-5, f"{name}: {err:.2e}"


@pytest.fixture(scope="module")
def two_ridge_steps():
    """Two WS-RK3 steps of the ridge (made y-varying) from the bubble, in
    both packages, float64."""
    tm = ridge.ridge_model(SIZE, dtype=torch.float64, device="cpu", extent=EXTENT,
                           y_amplitude=0.3)
    jg = bz.make_grid(size=SIZE, extent=EXTENT,
                      topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED), halo=3,
                      dtype=jnp.float64)
    g = tm.grid
    jm = JC.make_compressible_model(
        jg, advection=bz.WENO(5), coriolis=bz.FPlane(1e-4),
        terrain=JT.make_terrain(jg, bz.ThermodynamicConstants(),
                                ridge.ridge_elevation(g.x0, g.Lx, g.Lz, g.y0, g.Ly, 0.3)),
        time_discretization=JC.SplitExplicitTimeDiscretization(acoustic_cfl=0.5))
    cx, cy, cz = 0.5 * EXTENT[0], 0.5 * EXTENT[1], 0.25 * EXTENT[2]
    js = JC.compressible_initial_state(jm, theta=lambda x, y, z: 300.0 + 0.5 * jnp.exp(
        -((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / 500.0 ** 2))
    with jax.disable_jit():
        for _ in range(2):
            js = JC.acoustic_rk3_step(jm, js, DT)
    ts0 = ridge.ridge_state(tm)
    ts = ts0
    for _ in range(2):
        ts = bt.acoustic_rk3_step(tm, ts, DT)
    return tm, ts0, ts, js


@pytest.mark.parametrize("name", NAMES)
def test_two_ridge_steps_match(two_ridge_steps, name):
    """The slice: two WS-RK3 steps (3 + 4 + 7 substeps each) of the ridge,
    ρw's surface face from the kinematic bottom included."""
    _, _, ts, js = two_ridge_steps
    err = _rel(getattr(ts, name), getattr(js, name))
    assert err < 1e-10, f"{name}: {err:.2e}"
    assert ts.time == pytest.approx(2 * DT)


def _totals(terrain, grid, state):
    """∫Jρ dV and ∫Jρθ dV, the totals σ-coordinates conserve (per unit
    horizontal area of a cell)."""
    w = np.asarray(terrain.jac_c3) * np.asarray(grid.dz_c_col)
    return np.array([float((np.asarray(getattr(state, k)) * w).sum())
                     for k in ("rho", "rho_theta")])


def test_ridge_conserves_mass_and_theta():
    """Flux form, periodic x and y, ρw̃ = 0 on the top and bottom faces:
    without divergence damping two ridge steps move ∫Jρ dV and ∫Jρθ dV by
    float64 roundoff."""
    tm = ridge.ridge_model(SIZE, dtype=torch.float64, device="cpu", extent=EXTENT,
                           y_amplitude=0.3)
    tm = TC.make_compressible_model(
        tm.grid, constants=tm.constants, advection=bt.WENO(5), coriolis=bt.FPlane(1e-4),
        terrain=tm.terrain,
        time_discretization=TC.SplitExplicitTimeDiscretization(damping_coefficient=0.0))
    ts0 = ridge.ridge_state(tm)
    ts = ts0
    for _ in range(2):
        ts = bt.acoustic_rk3_step(tm, ts, DT)
    before, after = _totals(tm.terrain, tm.grid, ts0), _totals(tm.terrain, tm.grid, ts)
    assert np.all(np.abs(after - before) / before < 1e-14), after / before - 1
    assert float(ts.rho_w.abs().max()) > 1e-3   # the flow over the ridge is not at rest


def test_damped_ridge_drift_is_the_references(two_ridge_steps):
    """With the thermal divergence damping of the benchmark the totals
    drift (3.0e-8 here): E damps ρu′ after C has set the bottom face's
    ρw′ = S′, so the next substep's ρw̃′ on that face is not 0 and mass
    crosses it.  ``breeze_tpu`` drifts by the same amount."""
    tm, ts0, ts, js = two_ridge_steps
    before = _totals(tm.terrain, tm.grid, ts0)
    got = _totals(tm.terrain, tm.grid, ts) / before - 1.0
    ref = _totals(tm.terrain, tm.grid, js) / before - 1.0
    assert np.all(np.abs(got) > 1e-9)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_ridge_is_the_benchmark_ridge():
    """At the benchmark's extent the ridge is ``bench.py --terrain``'s h(x)."""
    h = ridge.ridge_elevation(0.0, *ridge.EXTENT[::2])
    x = np.linspace(0.0, 12_800.0, 257)[None, :]
    ref = (250.0 * np.exp(-((x - 6400.0) / 5000.0) ** 2)
           * np.cos(np.pi * (x - 6400.0) / 4000.0) ** 2)
    np.testing.assert_allclose(h(x, np.zeros((3, 1))), np.broadcast_to(ref, (3, 257)),
                               rtol=1e-15, atol=1e-12)
    m = ridge.ridge_model((16, 8, 8), dtype=torch.float64, device="cpu")
    assert m.terrain.jac_c.dim() == 2 and m.terrain.jac_cf is None   # LinearDecay
    assert float(m.terrain.sy_yf.abs().max()) == 0.0                 # uniform in y


def test_terrain_initial_state_matches():
    jm, tm = _models("sleve")
    theta = lambda x, y, z: 300.0 + 0.01 * z
    js = JT.terrain_initial_state(jm, jm.terrain, theta=theta, u=lambda x, y, z: 5.0 + 1e-3 * z)
    ts = TT.terrain_initial_state(tm, tm.terrain, theta=theta, u=lambda x, y, z: 5.0 + 1e-3 * z)
    for name in NAMES:
        assert _rel(getattr(ts, name), getattr(js, name)) < 1e-14, name
    assert float(ts.rho_w[0].abs().max()) > 0.0


def test_terrain_converters_round_trip():
    _, tm = _models("sleve")
    back = convert.terrain_from_numpy(convert.terrain_to_numpy(tm.terrain),
                                      height=tm.terrain.height, dtype=torch.float64,
                                      device="cpu")
    for name in convert.TERRAIN_FIELDS:
        assert torch.equal(getattr(back, name), getattr(tm.terrain, name)), name
    _, tm = _models("linear")
    back = convert.terrain_from_numpy(convert.terrain_to_numpy(tm.terrain),
                                      height=tm.terrain.height, dtype=torch.float64,
                                      device="cpu")
    assert back.jac_cf is None and back.h2_c is None


@pytest.mark.parametrize("kind", ["linear", "sin2", "cubic"])
def test_sponge_ramp_matches(kind):
    z = torch.linspace(0.0, 800.0, 33, dtype=torch.float64)
    got = TC._ramp_profile(kind, z, 800.0, 300.0)
    ref = JC._ramp_profile(kind, jnp.asarray(z.numpy()), 800.0, 300.0)
    assert _rel(got, ref) < 1e-15
    with pytest.raises(ValueError):
        TC._ramp_profile("step", z, 800.0, 300.0)


@pytest.mark.parametrize("kw", [
    dict(formulation="static_energy"), dict(closure=object()),
    dict(forcings=(object(),)), dict(terrain="ridge"),
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(sponge="sponge"))],
    ids=["static_energy", "closure", "forcings", "not_metrics", "not_a_sponge"])
def test_terrain_outside_the_envelope_raises(kw):
    tg = bt.make_grid((8, 8, 8), extent=(400.0, 400.0, 400.0), dtype=torch.float64,
                      device="cpu")
    kw = {"advection": bt.WENO(5), **kw}
    kw.setdefault("terrain", TT.make_terrain(tg, bt.ThermodynamicConstants(),
                                             lambda x, y: 10.0 + 0 * x))
    with pytest.raises(NotImplementedError):
        TC.make_compressible_model(tg, **kw)
