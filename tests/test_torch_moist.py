"""The port's moist and static-energy compressible core against
``breeze_tpu``, on the CPU: the density saturation adjustments, the ρe
initial state, diagnose and caches, the acoustic loop's C_ρ, direct-damping
and bfloat16 branches (the plain version of the CUDA kernel) and two steps
of the moist bubble in ρθ and in ρe with direct damping, in float64 to
roundoff; the plain loop against the Pallas kernel in interpret mode in
float32.

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
from breeze_tpu.dynamics import compressible as JC
from breeze_tpu.physics import microphysics as JM
from breeze_tpu.thermo import states as JS
import torch_parity as tp
import breeze_tpu_torch as bt
from breeze_tpu_torch import bubble, convert
from breeze_tpu_torch.dynamics import compressible as TC
from breeze_tpu_torch.dynamics import terrain as TT
from breeze_tpu_torch.kernels import acoustic
from breeze_tpu_torch.physics import microphysics as TM
from breeze_tpu_torch.thermo.constants import MoistureMassFractions
from breeze_tpu_torch.thermo import states as TS

NAMES = ("rho", "rho_u", "rho_v", "rho_w", "rho_theta", "rho_qt")
#: (32, 16, 16) over 1600 × 800 × 800 m: Δx = 50 m, so N = 7 substeps at
#: Δt = 0.5 s, as at 256 × 256 × 128 over 12.8 km
SIZE, EXTENT, DT = (32, 16, 16), (1600.0, 800.0, 800.0), 0.5
JCONST, TCONST = bz.ThermodynamicConstants(), bt.ThermodynamicConstants()
#: the branches of the acoustic loop this slice adds, as (formulation,
#: direct damping, bfloat16 carries)
BRANCHES = {"rhoe_thermal": ("static_energy", False, False),
            "theta_direct": ("potential_temperature", True, False),
            "rhoe_direct": ("static_energy", True, False),
            "bf16": ("potential_temperature", False, True)}


def _rel(got, ref, skip_w0=False):
    if isinstance(got, torch.Tensor):
        got = got.double().numpy()
    return tp.max_rel_err(got, np.asarray(ref), skip_w0=skip_w0)


def _models(formulation="potential_temperature", direct=False, bf16=False, moist=True):
    """The bubble configuration through both packages, float64, z
    stretched; ``direct``: the direct divergence damping in place of the
    thermal."""
    dz = 30.0 * 1.06 ** np.arange(SIZE[2])
    x, y, z = (0.0, EXTENT[0]), (0.0, EXTENT[1]), np.concatenate([[0.0], np.cumsum(dz)])
    store = "bfloat16" if bf16 else None
    jg = bz.make_grid(size=SIZE, x=x, y=y, z=z,
                      topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED), halo=3,
                      dtype=jnp.float64)
    jm = JC.make_compressible_model(
        jg, advection=bz.WENO(5), coriolis=bz.FPlane(1e-4), formulation=formulation,
        microphysics=bz.SaturationAdjustment(equilibrium=bz.WarmPhaseEquilibrium())
        if moist else None,
        time_discretization=JC.SplitExplicitTimeDiscretization(
            acoustic_cfl=0.5, substep_floattype=store,
            damping=JC.DirectDivergenceDamping(0.1) if direct else None))
    tg = bt.make_grid(SIZE, x=x, y=y, z=z, dtype=torch.float64, device="cpu")
    tm = TC.make_compressible_model(
        tg, advection=bt.WENO(5), coriolis=bt.FPlane(1e-4), formulation=formulation,
        microphysics=bt.SaturationAdjustment() if moist else None,
        time_discretization=TC.SplitExplicitTimeDiscretization(
            acoustic_cfl=0.5, substep_floattype=store,
            damping=TC.DirectDivergenceDamping(0.1) if direct else None))
    return jm, tm


def _theta_qt(xp):
    """The bubble in θ, and qᵗ: the benchmark's 0.008·exp(−z/1500 m) plus a
    blob of 0.02 about the bubble, saturated in its core, so that the
    condensate branches act."""
    cx, cy, cz = 0.5 * EXTENT[0], 0.5 * EXTENT[1], 0.25 * EXTENT[2]
    r2 = lambda x, y, z: ((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / 300.0 ** 2
    theta = lambda x, y, z: 300.0 + 0.5 * xp.exp(-r2(x, y, z) * (300.0 / 500.0) ** 2)
    qt = lambda x, y, z: 0.008 * xp.exp(-z / 1500.0) + 0.02 * xp.exp(-r2(x, y, z))
    return theta, qt


def _states(jm, tm, noise_seed=None):
    """The moist bubble through both packages (the JAX one converted, so
    that both start from the same numbers); with ``noise_seed``, noise on
    the momenta and the thermodynamic slot."""
    theta, qt = _theta_qt(jnp)
    js = JC.compressible_initial_state(jm, theta=theta, qt=qt if jm.has_moisture else None)
    if noise_seed is not None:
        rng = np.random.default_rng(noise_seed)
        noise = lambda sd: jnp.asarray(rng.normal(0.0, sd, jm.grid.shape))
        # 0.05 in ρθ is 50 in ρe for the same pressure noise, about
        scale = 1e3 if jm.formulation == "static_energy" else 1.0
        js = js.replace(rho_u=js.rho_u + noise(0.5), rho_v=js.rho_v + noise(0.5),
                        rho_w=js.rho_w.at[1:].add(noise(0.2)[1:]),
                        rho_theta=js.rho_theta + noise(0.05 * scale))
    arrays = {k: None if getattr(js, k) is None else np.asarray(getattr(js, k))
              for k in NAMES}
    return js, convert.compressible_state_from_numpy(arrays, dtype=torch.float64,
                                                      device="cpu")


def _physics_inputs(seed=3):
    """θ, ρ, qᵗ over 400 points from 260 to 310 K and qᵗ up to 0.03:
    saturated and unsaturated cells alike."""
    rng = np.random.default_rng(seed)
    n = 400
    theta = rng.uniform(285.0, 315.0, n)
    rho = rng.uniform(0.7, 1.2, n)
    qt = rng.uniform(0.0, 0.03, n)
    z = rng.uniform(0.0, 3000.0, n)
    return theta, rho, qt, z


def test_state_relations_match():
    theta, rho, qt, z = _physics_inputs()
    T = theta - 0.0098 * z
    p = rho * 287.0 * T
    qj = bz.MoistureMassFractions(jnp.asarray(qt * 0.7), jnp.asarray(qt * 0.3),
                                  jnp.zeros_like(jnp.asarray(qt)))
    qtt = MoistureMassFractions(torch.tensor(qt * 0.7), torch.tensor(qt * 0.3),
                                torch.zeros(len(qt), dtype=torch.float64))
    cases = [
        (TS.theta_li_from_temperature(torch.tensor(T), qtt, torch.tensor(p), TCONST),
         JS.theta_li_from_temperature(jnp.asarray(T), qj, jnp.asarray(p), JCONST)),
        (TS.static_energy(torch.tensor(T), torch.tensor(z), qtt, TCONST),
         JS.static_energy(jnp.asarray(T), jnp.asarray(z), qj, JCONST)),
        (TS.temperature_from_static_energy(torch.tensor(3e5 + 0 * T), torch.tensor(z), qtt,
                                           TCONST),
         JS.temperature_from_static_energy(jnp.asarray(3e5 + 0 * T), jnp.asarray(z), qj,
                                           JCONST))]
    for got, ref in cases:
        assert _rel(got, ref) < 1e-15


def test_density_saturation_adjust_matches():
    theta, rho, qt, _ = _physics_inputs()
    T, q, p = TM.density_saturation_adjust(torch.tensor(theta), torch.tensor(rho),
                                           torch.tensor(qt), TCONST, bt.SaturationAdjustment())
    jT, jq, jp = JM.density_saturation_adjust(jnp.asarray(theta), jnp.asarray(rho),
                                              jnp.asarray(qt), JCONST, bz.SaturationAdjustment())
    assert float(q.liquid.max()) > 1e-3 and float((q.liquid == 0).sum()) > 10
    for got, ref in ((T, jT), (p, jp), (q.vapor, jq.vapor), (q.liquid, jq.liquid)):
        assert _rel(got, ref) < 1e-13


def test_density_saturation_adjust_static_energy_matches():
    theta, rho, qt, z = _physics_inputs()
    e = 1005.0 * (theta - 0.0098 * z) + 9.81 * z
    args = (e, z, rho, qt)
    T, q, p = TM.density_saturation_adjust_static_energy(
        *(torch.tensor(a) for a in args), TCONST, bt.SaturationAdjustment())
    jT, jq, jp = JM.density_saturation_adjust_static_energy(
        *(jnp.asarray(a) for a in args), JCONST, bz.SaturationAdjustment())
    assert float(q.liquid.max()) > 1e-3 and float((q.liquid == 0).sum()) > 10
    for got, ref in ((T, jT), (p, jp), (q.vapor, jq.vapor), (q.liquid, jq.liquid)):
        assert _rel(got, ref) < 1e-13


def test_density_temperature_inversion_matches():
    theta, rho, qt, _ = _physics_inputs()
    T, p = TM.density_temperature_inversion(
        torch.tensor(theta), torch.tensor(rho),
        MoistureMassFractions.vapor_only(torch.tensor(qt)), TCONST)
    jT, jp = JM.density_temperature_inversion(
        jnp.asarray(theta), jnp.asarray(rho),
        bz.MoistureMassFractions.vapor_only(jnp.asarray(qt)), JCONST)
    assert _rel(T, jT) < 1e-14 and _rel(p, jp) < 1e-14


@pytest.mark.parametrize("formulation,moist", [
    ("potential_temperature", True), ("static_energy", True), ("static_energy", False)],
    ids=["theta_moist", "rhoe_moist", "rhoe_dry"])
def test_initial_state_diagnose_and_caches_match(formulation, moist):
    """The initial state (the ρe inversion at the true density), then
    diagnose and caches on it with noise, C_ρ included."""
    jm, tm = _models(formulation, moist=moist)
    theta, qt = _theta_qt(torch)
    ts = TC.compressible_initial_state(tm, theta=theta, qt=qt if moist else None)
    js, _ = _states(jm, tm)
    for name in NAMES:
        if getattr(js, name) is None:
            assert getattr(ts, name) is None, name
            continue
        assert _rel(getattr(ts, name), getattr(js, name)) < 1e-14, name
    js, ts = _states(jm, tm, noise_seed=5)
    jaux, taux = JC.compressible_diagnose(jm, js), TC.compressible_diagnose(tm, ts)
    for name in ("u", "v", "w", "theta", "p", "T") + (("qt",) if moist else ()):
        assert _rel(getattr(taux, name), getattr(jaux, name)) < 1e-13, name
    if moist:
        assert float(taux.q.liquid.max()) > 1e-4
        for name in ("vapor", "liquid"):
            assert _rel(getattr(taux.q, name), getattr(jaux.q, name)) < 1e-12, name
    jc, tc = JC.stage_caches(jm, js, jaux), TC.stage_caches(tm, ts, taux)
    for name in ("theta_L", "theta_L_zf", "C_L", "C_rho"):
        if getattr(jc, name) is None:
            assert getattr(tc, name) is None, name
            continue
        assert _rel(getattr(tc, name), getattr(jc, name)) < 1e-13, name


@pytest.mark.parametrize("formulation", ["potential_temperature", "static_energy"],
                         ids=["theta", "rhoe"])
def test_moist_slow_tendencies_match(formulation):
    """χ = e and the buoyancy-flux source in ρe; G.rho_qt."""
    jm, tm = _models(formulation)
    js, ts = _states(jm, tm, noise_seed=6)
    jG = JC.slow_tendencies(jm, js, JC.compressible_diagnose(jm, js))
    tG = TC.slow_tendencies(tm, ts, TC.compressible_diagnose(tm, ts))
    for name in NAMES:
        err = _rel(getattr(tG, name), getattr(jG, name), skip_w0=name == "rho_w")
        assert err < 1e-11, f"{name}: {err:.2e}"


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_acoustic_stage_matches_jnp_loop(branch):
    """One stage of 7 plain substeps against ``acoustic_substep_loop`` on
    each new branch, moist, with noise on the five perturbations."""
    formulation, direct, bf16 = BRANCHES[branch]
    jm, tm = _models(formulation, direct, bf16)
    js, ts = _states(jm, tm, noise_seed=4)
    rng = np.random.default_rng(7)
    pj = JC.Perturbations(*(jnp.asarray(rng.normal(0.0, 1e-3, jm.grid.shape))
                            for _ in range(5)), *(jnp.zeros(jm.grid.shape),) * 3)
    pj = pj._replace(rho_w=pj.rho_w.at[0].set(0.0))
    aux = JC.compressible_diagnose(jm, js)
    with jax.disable_jit():
        ref = JC.acoustic_substep_loop(jm, JC.stage_caches(jm, js, aux),
                                       JC.slow_tendencies(jm, js, aux), pj, DT / 7, 7,
                                       gate_first=True)
    taux = TC.compressible_diagnose(tm, ts)
    pt = [torch.tensor(np.asarray(a)) for a in pj]
    if bf16:
        pt[:5] = [a.to(torch.bfloat16) for a in pt[:5]]
    got = acoustic.acoustic_substeps(
        tm.acoustic_config, tm.z_columns, TC.stage_caches(tm, ts, taux),
        TC.slow_tendencies(tm, ts, taux), acoustic.Perturbations(*pt), DT / 7, 7, True)
    assert got.rho.dtype == (torch.bfloat16 if bf16 else torch.float64)
    for name in acoustic.Perturbations._fields:
        err = _rel(getattr(got, name), getattr(ref, name))
        assert err < 1e-10, f"{name}: {err:.2e}"


def _pallas_stage(formulation, direct, bf16, substeps=4):
    """``TestFusedAcousticSubstep.setup``'s (128, 8, 16) float32 stage in
    the given branch: the JAX model, caches, slow tendencies and noisy
    perturbations."""
    g = bz.make_grid(size=(128, 8, 16), extent=(12800.0, 800.0, 1600.0),
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED), halo=3,
                     dtype=jnp.float32)
    td = JC.SplitExplicitTimeDiscretization(
        substeps=substeps, substep_floattype="bfloat16" if bf16 else None,
        damping=JC.DirectDivergenceDamping(0.15 if formulation == "static_energy" else 0.1)
        if direct else None, damping_coefficient=0.0 if direct else 0.1)
    model = JC.make_compressible_model(g, advection=bz.Centered(2), time_discretization=td,
                                       formulation=formulation)
    state = JC.compressible_initial_state(
        model, theta=lambda x, y, z: 300.0 + 1.0 * jnp.exp(
            -((x - 6400.0) ** 2 / 1500.0 ** 2 + (z - 800.0) ** 2 / 300.0 ** 2)),
        u=lambda x, y, z: 3.0 + 0 * x, pressure_balanced=False)
    aux = JC.compressible_diagnose(model, state)
    rng = np.random.default_rng(0)
    pert = [(rng.normal(size=g.shape) * 1e-3).astype(np.float32) for _ in range(5)]
    pert[3][0] = 0.0
    zero = np.zeros(g.shape, np.float32)
    return (model, JC.stage_caches(model, state, aux), JC.slow_tendencies(model, state, aux),
            JC.Perturbations(*(jnp.asarray(a) for a in pert + [zero] * 3)))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_plain_matches_pallas_interpret(branch):
    """The plain loop against K3 in interpret mode, in float32, on the
    reference's own cases (``TestFusedAcousticSubstep``: direct damping,
    ρe, ρe + direct over 4 substeps, bfloat16 carries)."""
    from breeze_tpu.pallas_kernels.acoustic import acoustic_substep_loop_pallas, supported
    formulation, direct, bf16 = BRANCHES[branch]
    n_tau = 4 if formulation == "static_energy" and direct else 3
    model, caches, G, pert = _pallas_stage(formulation, direct, bf16)
    assert supported(model)
    ref = acoustic_substep_loop_pallas(model, caches, G, pert, 0.5, n_tau, gate_first=True,
                                       interpret=True)
    g, td = model.grid, model.time_discretization
    tg = bt.make_grid((g.nx, g.ny, g.nz), extent=(g.Lx, g.Ly, g.Lz), dtype=torch.float32,
                      device="cpu")
    tm = bt.make_compressible_model(
        tg, advection=bt.WENO(5), formulation=formulation,
        time_discretization=bt.SplitExplicitTimeDiscretization(
            substep_floattype=td.substep_floattype, damping_coefficient=td.damping_coefficient,
            damping=None if td.damping is None else TC.DirectDivergenceDamping(
                td.damping.coefficient)))
    t = lambda a: None if a is None else torch.tensor(np.asarray(a))
    pt = [t(a) for a in pert]
    if bf16:
        pt[:5] = [a.to(torch.bfloat16) for a in pt[:5]]
    got = acoustic.acoustic_substeps(
        tm.acoustic_config, tm.z_columns,
        TC.StageCaches(*(t(getattr(caches, k)) for k in TC.StageCaches._fields)),
        TC.SlowTendencies(*(t(getattr(G, k)) for k in TC.SlowTendencies._fields)),
        acoustic.Perturbations(*pt), 0.5, n_tau, True)
    for name in acoustic.Perturbations._fields:
        a = getattr(got, name).double().numpy()
        b = np.asarray(getattr(ref, name), np.float64)
        # TestFusedAcousticSubstep's limits: float32, the Pallas kernel
        # divides twice in the sweep where the plain loop multiplies by
        # 1/den; bfloat16 carries rounded at other places (3e-2)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-10)
        assert err < (3e-2 if bf16 else 5e-5), f"{name}: {err:.2e}"


def _two_steps(formulation, direct):
    jm, tm = _models(formulation, direct)
    js, ts = _states(jm, tm)
    ts0 = ts
    with jax.disable_jit():
        for _ in range(2):
            js = JC.acoustic_rk3_step(jm, js, DT)
    for _ in range(2):
        ts = bt.acoustic_rk3_step(tm, ts, DT)
    return tm, ts0, ts, js


@pytest.fixture(scope="module")
def moist_theta_steps():
    return _two_steps("potential_temperature", False)


@pytest.fixture(scope="module")
def moist_rhoe_direct_steps():
    return _two_steps("static_energy", True)


@pytest.mark.parametrize("case", ["theta", "rhoe_direct"])
@pytest.mark.parametrize("name", NAMES)
def test_two_moist_bubble_steps_match(moist_theta_steps, moist_rhoe_direct_steps, case,
                                      name):
    """The slice: two WS-RK3 steps (3 + 4 + 7 substeps each) of the moist
    bubble, in ρθ with thermal damping and in ρe with direct damping,
    ρqᵗ's scalar transport and the step-start repair included."""
    _, _, ts, js = moist_theta_steps if case == "theta" else moist_rhoe_direct_steps
    err = _rel(getattr(ts, name), getattr(js, name))
    assert err < 1e-10, f"{name}: {err:.2e}"
    assert ts.time == pytest.approx(2 * DT)


@pytest.mark.parametrize("case", ["theta", "rhoe_direct"])
def test_moist_steps_conserve_mass_and_moisture(moist_theta_steps, moist_rhoe_direct_steps,
                                                case):
    """Flux form with periodic x and y and walls in z, and a column-
    conserving repair: ∫ρ dV and ∫ρqᵗ dV move by float64 roundoff."""
    tm, ts0, ts, _ = moist_theta_steps if case == "theta" else moist_rhoe_direct_steps
    dz = tm.grid.dz_c_col
    for name in ("rho", "rho_qt"):
        before, after = (float((getattr(s, name) * dz).sum()) for s in (ts0, ts))
        assert abs(after / before - 1.0) < 1e-14, name
    assert float(ts.rho_w.abs().max()) > 1e-3


def test_moist_state_converters_round_trip():
    tm = bubble.bubble_model((8, 6, 5), dtype=torch.float64, device="cpu", moist=True)
    ts = bubble.bubble_state(tm).replace(time=2.0)
    arrays = convert.compressible_state_to_numpy(ts)
    back = convert.compressible_state_from_numpy(arrays, dtype=torch.float64, device="cpu")
    for name in NAMES:
        assert torch.equal(getattr(back, name), getattr(ts, name)), name
    assert back.time == 2.0


def test_bubble_variants_are_the_benchmarks():
    """``bubble_model``'s options build ``bench.py``'s moist and bfloat16
    bubbles and the ρe + direct configuration; the moist state's qᵗ is
    0.008·exp(−z/1500 m)."""
    kw = dict(dtype=torch.float64, device="cpu")
    m = bubble.bubble_model((8, 6, 5), moist=True, **kw)
    s = bubble.bubble_state(m)
    np.testing.assert_allclose((s.rho_qt / s.rho).numpy(),
                               np.broadcast_to(0.008 * np.exp(-m.grid.z_c_col.numpy() / 1500.0),
                                               m.grid.shape), rtol=1e-14)
    assert isinstance(m.microphysics, bt.SaturationAdjustment)
    m = bubble.bubble_model((8, 6, 5), moist=True, formulation="static_energy",
                            damping=bt.DirectDivergenceDamping(0.1), **kw)
    assert (m.formulation, m.acoustic_config.damping_mode, m.acoustic_config.damping) == (
        "static_energy", "direct", 0.1)
    assert bubble.bubble_model((8, 6, 5), substep_floattype="bfloat16",
                               **kw).substep_dtype == torch.bfloat16
    assert bubble.bubble_state(bubble.bubble_model((8, 6, 5), **kw)).rho_qt is None


def _hill(g):
    return TT.make_terrain(g, TCONST, lambda x, y: 10.0 + 0 * x)


@pytest.mark.parametrize("kw", [
    dict(microphysics=object()), dict(terrain=_hill, microphysics=bt.SaturationAdjustment()),
    dict(terrain=_hill, formulation="static_energy"),
    dict(microphysics=bt.SaturationAdjustment(), closure=object()),
    dict(formulation="static_energy", forcings=(object(),)),
    dict(formulation="static_energy", boundary_fluxes=object()),
    dict(microphysics=bt.SaturationAdjustment(), reference_vapor_mass_fraction=0.01),
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(substep_floattype="float16")),
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(
        damping=TC.ThermalDivergenceDamping(0.1, damp_vertical=True))),
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(damping=object()))],
    ids=["prognostic_condensate", "moist_terrain", "rhoe_terrain", "moist_closure",
         "rhoe_forcings", "rhoe_fluxes", "moist_reference", "float16", "damp_vertical",
         "unknown_damping"])
def test_moist_envelope_refusals(kw):
    """What stays outside the ported envelope is still refused."""
    g = bt.make_grid((8, 8, 8), extent=(400.0, 400.0, 400.0), dtype=torch.float64,
                     device="cpu")
    kw = {"advection": bt.WENO(5), **kw}
    if callable(kw.get("terrain")):
        kw["terrain"] = kw["terrain"](g)
    with pytest.raises(NotImplementedError):
        TC.make_compressible_model(g, **kw)
