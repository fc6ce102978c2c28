"""The port's split-explicit compressible core against ``breeze_tpu``, in
float64 on the CPU (the kernels' plain versions against the jnp path).

The JAX reference runs under ``jax.disable_jit()``: its acoustic substep
loop is a ``fori_loop`` whose XLA:CPU compile has crashed test workers, and
eager execution gives the same numbers.  The float32 checks of the plain
versions against the Pallas kernels are in ``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breeze_tpu as bz
from breeze_tpu.dynamics import compressible as JC
import torch_parity as tp
import breeze_tpu_torch as bt
from breeze_tpu_torch import bubble, convert
from breeze_tpu_torch.dynamics import compressible as TC
from breeze_tpu_torch.dynamics import terrain as TT
from breeze_tpu_torch.kernels import acoustic

NAMES = ("rho", "rho_u", "rho_v", "rho_w", "rho_theta")
#: (32, 16, 16) over 1600 × 800 × 800 m: Δx = 50 m, so N = 7 substeps at
#: Δt = 0.5 s, as at 256 × 256 × 128 over 12.8 km
SIZE, EXTENT, DT = (32, 16, 16), (1600.0, 800.0, 800.0), 0.5


def _z_faces(stretched):
    if not stretched:
        return (0.0, EXTENT[2])
    dz = 30.0 * 1.06 ** np.arange(SIZE[2])
    return np.concatenate([[0.0], np.cumsum(dz)])


def _models(stretched=False, damping=0.1, scalar_bounds=False):
    """The bubble configuration through both packages, float64."""
    x, y, z = (0.0, EXTENT[0]), (0.0, EXTENT[1]), _z_faces(stretched)
    jg = bz.make_grid(size=SIZE, x=x, y=y, z=z,
                      topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                      halo=3, dtype=jnp.float64)
    jm = JC.make_compressible_model(
        jg, advection=bz.WENO(5), coriolis=bz.FPlane(1e-4),
        scalar_advection=bz.WENO(5, bounds_preserving=scalar_bounds),
        time_discretization=JC.SplitExplicitTimeDiscretization(
            acoustic_cfl=0.5, damping_coefficient=damping))
    tg = bt.make_grid(SIZE, x=x, y=y, z=z, dtype=torch.float64, device="cpu")
    tm = TC.make_compressible_model(
        tg, advection=bt.WENO(5), coriolis=bt.FPlane(1e-4),
        scalar_advection=bt.WENO(5, bounds_preserving=scalar_bounds),
        time_discretization=TC.SplitExplicitTimeDiscretization(
            acoustic_cfl=0.5, damping_coefficient=damping))
    return jm, tm


def _jax_bubble(jm):
    g = jm.grid
    cx, cy, cz = 0.5 * EXTENT[0], 0.5 * EXTENT[1], 0.25 * float(g.Lz)
    return JC.compressible_initial_state(jm, theta=lambda x, y, z: 300.0 + 0.5 * jnp.exp(
        -((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / 500.0 ** 2))


def _noisy(jm, js, seed=4):
    """The bubble with noise on the momenta and ρθ, so that every term of
    the slow tendencies and the substeps is non-trivial."""
    rng = np.random.default_rng(seed)
    noise = lambda sd: jnp.asarray(rng.normal(0.0, sd, jm.grid.shape))
    return js.replace(rho_u=js.rho_u + noise(0.5), rho_v=js.rho_v + noise(0.5),
                      rho_w=js.rho_w.at[1:].add(noise(0.2)[1:]),
                      rho_theta=js.rho_theta + noise(0.05))


def _to_torch(js):
    return convert.compressible_state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in NAMES}, dtype=torch.float64, device="cpu")


def _rel(got, ref, skip_w0=False):
    return tp.max_rel_err(got.numpy() if isinstance(got, torch.Tensor) else got,
                          np.asarray(ref), skip_w0=skip_w0)


@pytest.mark.parametrize("stretched", [False, True], ids=["uniform", "stretched"])
def test_exner_reference_matches(stretched):
    jm, tm = _models(stretched)
    for name in ("p_c", "rho_c", "T_c", "theta_c", "exner_c", "rho_f", "qv_c"):
        got, ref = getattr(tm.reference, name).numpy(), np.asarray(getattr(jm.reference, name))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12, err_msg=name)
    # the discrete balance the Newton solve aims at, on the port's columns
    ref = tm.reference
    dz_f = tm.grid.dz_f[1:tm.grid.nz]
    resid = ((ref.p_c[1:] - ref.p_c[:-1]) / dz_f
             + 9.81 * 0.5 * (ref.rho_c[1:] + ref.rho_c[:-1]))
    assert float(resid.abs().max()) < 1e-9


def test_initial_state_matches():
    jm, tm = _models()
    js, ts = _jax_bubble(jm), bubble.bubble_state(tm)
    for name in NAMES:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-14, atol=1e-14, err_msg=name)


def test_diagnose_and_caches_match():
    jm, tm = _models(stretched=True)
    js = _noisy(jm, _jax_bubble(jm))
    ts = _to_torch(js)
    jaux, taux = JC.compressible_diagnose(jm, js), TC.compressible_diagnose(tm, ts)
    for name in ("u", "v", "w", "theta", "p", "T"):
        assert _rel(getattr(taux, name), getattr(jaux, name)) < 1e-14, name
    jc, tc = JC.stage_caches(jm, js, jaux), TC.stage_caches(tm, ts, taux)
    for name in ("theta_L", "theta_L_zf", "C_L"):
        assert _rel(getattr(tc, name), getattr(jc, name)) < 1e-14, name


@pytest.mark.parametrize("stretched,bounds", [(False, False), (True, True)],
                         ids=["uniform", "stretched_bounds"])
def test_slow_tendencies_match(stretched, bounds):
    """The momentum and scalar kernels' plain versions, Coriolis, the
    frozen pressure gradient and the imbalance against the jnp path."""
    jm, tm = _models(stretched, scalar_bounds=bounds)
    js = _noisy(jm, _jax_bubble(jm))
    ts = _to_torch(js)
    jG = JC.slow_tendencies(jm, js, JC.compressible_diagnose(jm, js))
    tG = TC.slow_tendencies(tm, ts, TC.compressible_diagnose(tm, ts))
    for name in NAMES:
        # row 0 of ρw reads below-wall pad data in the kernel and zero in
        # the jnp path; the wall condition overwrites it.  float64
        # roundoff, amplified in the WENO weights of the small momenta
        err = _rel(getattr(tG, name), getattr(jG, name), skip_w0=name == "rho_w")
        assert err < 1e-11, f"{name}: {err:.2e}"


@pytest.mark.parametrize("damping,gate_first", [(0.1, True), (0.0, False)],
                         ids=["thermal_gated", "none_ungated"])
def test_acoustic_stage_matches_jnp_loop(damping, gate_first):
    """One stage of 7 plain substeps against ``acoustic_substep_loop``."""
    jm, tm = _models(stretched=True, damping=damping)
    js = _noisy(jm, _jax_bubble(jm))
    ts = _to_torch(js)
    rng = np.random.default_rng(7)
    pj = JC.Perturbations(*(jnp.asarray(rng.normal(0.0, 1e-3, jm.grid.shape))
                            for _ in range(5)), *(jnp.zeros(jm.grid.shape),) * 3)
    pj = pj._replace(rho_w=pj.rho_w.at[0].set(0.0))
    aux = JC.compressible_diagnose(jm, js)
    with jax.disable_jit():
        ref = JC.acoustic_substep_loop(jm, JC.stage_caches(jm, js, aux),
                                       JC.slow_tendencies(jm, js, aux), pj, DT / 7, 7,
                                       gate_first=gate_first)
    taux = TC.compressible_diagnose(tm, ts)
    got = acoustic.acoustic_substeps(
        tm.acoustic_config, tm.z_columns, TC.stage_caches(tm, ts, taux),
        TC.slow_tendencies(tm, ts, taux),
        acoustic.Perturbations(*(torch.tensor(np.asarray(a)) for a in pj)),
        DT / 7, 7, gate_first)
    for name in acoustic.Perturbations._fields:
        err = _rel(getattr(got, name), getattr(ref, name))
        assert err < 1e-10, f"{name}: {err:.2e}"


@pytest.fixture(scope="module")
def two_bubble_steps():
    jm, tm = _models()
    js, ts = _jax_bubble(jm), bubble.bubble_state(tm)
    with jax.disable_jit():
        for _ in range(2):
            js = JC.acoustic_rk3_step(jm, js, DT)
    for _ in range(2):
        ts = bt.acoustic_rk3_step(tm, ts, DT)
    return ts, js


@pytest.mark.parametrize("name", NAMES)
def test_two_bubble_steps_match(two_bubble_steps, name):
    """The slice: two WS-RK3 steps (3 + 4 + 7 substeps each) of the bubble."""
    ts, js = two_bubble_steps
    err = _rel(getattr(ts, name), getattr(js, name))
    # float64 roundoff through 28 substeps, relative to each field's max
    # (the momenta are O(1e-2) against O(1) density)
    assert err < 1e-10, f"{name}: {err:.2e}"
    assert ts.time == pytest.approx(2 * DT)


def test_substep_plan_and_count_match():
    jm, tm = _models()
    assert TC.substep_count(tm, DT) == JC.substep_count(jm, DT) == 7
    assert TC.stage_substep_plan(7, DT) == JC.stage_substep_plan("proportional", 7, DT)


def test_state_converters_round_trip():
    tm = bubble.bubble_model((8, 6, 5), dtype=torch.float64, device="cpu")
    ts = bubble.bubble_state(tm).replace(time=3.0)
    back = convert.compressible_state_from_numpy(
        convert.compressible_state_to_numpy(ts), dtype=torch.float64, device="cpu")
    for name in NAMES:
        assert torch.equal(getattr(back, name), getattr(ts, name))
    assert back.time == 3.0
    ref = tm.reference
    pinned = convert.exner_reference_from_numpy(
        {k: getattr(ref, k).numpy() for k in convert.EXNER_PROFILES},
        surface_pressure=ref.surface_pressure,
        surface_potential_temperature=ref.surface_potential_temperature,
        standard_pressure=ref.standard_pressure, dtype=torch.float64, device="cpu")
    for k in convert.EXNER_PROFILES:
        assert torch.equal(getattr(pinned, k), getattr(ref, k)), k


@pytest.mark.parametrize("kw", [
    dict(closure=object()), dict(forcings=(object(),)), dict(microphysics=object()),
    dict(terrain=object()), dict(formulation="static_energy", terrain="hill"),
    dict(boundary_fluxes=object()), dict(reference_vapor_mass_fraction=0.01),
    dict(advection=bt.WENO(5, bounds_preserving=True)),
    # bfloat16 carries are ported; other storage types are not
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(substep_floattype="float16")),
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(sponge=object())),
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(damping=object())),
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(substeps=6)),
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(
        substep_distribution="constant")),
    dict(time_discretization=TC.SplitExplicitTimeDiscretization(
        substep_distribution="monolithic_first")),
], ids=["closure", "forcings", "moisture", "terrain", "static_energy", "fluxes",
        "moist_reference", "bounded_momentum", "bf16", "sponge", "direct_damping",
        "fixed_substeps", "constant_plan", "monolithic_first_plan"])
def test_outside_the_envelope_raises(kw):
    g = bt.make_grid((8, 8, 8), extent=(400.0, 400.0, 400.0), dtype=torch.float64,
                     device="cpu")
    kw = {"advection": bt.WENO(5), **kw}
    if kw.get("terrain") == "hill":   # ρe over terrain (flat ρe is ported)
        kw["terrain"] = TT.make_terrain(g, bt.ThermodynamicConstants(), lambda x, y: 10.0 + 0 * x)
    with pytest.raises(NotImplementedError):
        TC.make_compressible_model(g, **kw)
