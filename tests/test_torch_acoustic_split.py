"""The per-substep acoustic kernel pair K1/K2 of the port
(``kernels/acoustic_split.py``) against ``breeze_tpu``, on the CPU.

- the plain pair against the Pallas pair (``_run_k1``, ``_run_k2``) in
  interpret mode, in float32, at ``TestFusedAcousticSubstep``'s (128, 8, 16)
  over 3 substeps, with ``BREEZE_TPU_PALLAS_ACOUSTIC_SPLIT`` set through
  monkeypatch; the Pallas pair against the jnp loop there;
- the plain pair against the jnp loop and against the port's own loop
  (K3's plain version), in float64;
- one WS-RK3 step of the dry bubble through the pair against
  ``breeze_tpu``'s step, in float64;
- the envelope ``per_substep_kernels`` keeps.

The JAX loop and step run under ``jax.disable_jit()``: the reference's
acoustic substep loop is a ``fori_loop`` whose XLA:CPU compile has crashed
test workers, and eager execution gives the same numbers.  The CUDA kernels
against their plain versions are in ``test_torch_cuda.py``.
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
from breeze_tpu_torch.kernels import acoustic, acoustic_split

FIELDS = acoustic.Perturbations._fields
#: (damping coefficient, gate_first, bfloat16 carries)
PALLAS_CASES = {"thermal_gated": (0.1, True, False), "none_ungated": (0.0, False, False),
                "bf16": (0.1, True, True)}


def _max_rel(got, ref):
    """Largest |got − ref| over the largest |ref|."""
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-10)


def _pallas_case(damping, gate, bf16):
    """``TestFusedAcousticSubstep.setup``'s float32 stage (the JAX model,
    caches, slow tendencies and ``_pert``'s perturbations) through the
    Pallas pair, and the port's acoustic config and columns on the same
    grid."""
    from breeze_tpu.pallas_kernels.acoustic import acoustic_substep_loop_pallas, supported
    g = bz.make_grid(size=(128, 8, 16), extent=(12800.0, 800.0, 1600.0),
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED), halo=3,
                     dtype=jnp.float32)
    td = JC.SplitExplicitTimeDiscretization(
        substeps=4, damping_coefficient=damping,
        substep_floattype="bfloat16" if bf16 else None)
    model = JC.make_compressible_model(g, advection=bz.Centered(2), time_discretization=td)
    state = JC.compressible_initial_state(
        model, theta=lambda x, y, z: 300.0 + 1.0 * jnp.exp(
            -((x - 6400.0) ** 2 / 1500.0 ** 2 + (z - 800.0) ** 2 / 300.0 ** 2)),
        u=lambda x, y, z: 3.0 + 0 * x, pressure_balanced=False)
    aux = JC.compressible_diagnose(model, state)
    caches, G = JC.stage_caches(model, state, aux), JC.slow_tendencies(model, state, aux)
    rng = np.random.default_rng(0)
    r = lambda: jnp.asarray(rng.normal(size=g.shape) * 1e-3, jnp.float32)
    zero = jnp.zeros(g.shape, jnp.float32)
    pert = JC.Perturbations(rho=r(), rho_u=r(), rho_v=r(), rho_w=r().at[0].set(0.0),
                            rho_theta=r(), sum_rho_u=zero, sum_rho_v=zero, sum_rho_w=zero)
    # the switch stays inside this context: no later test on the worker sees it
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BREEZE_TPU_PALLAS_ACOUSTIC_SPLIT", "1")
        assert supported(model)
        pair = acoustic_substep_loop_pallas(model, caches, G, pert, 0.5, 3, gate_first=gate,
                                            interpret=True)
    tg = bt.make_grid((g.nx, g.ny, g.nz), extent=(g.Lx, g.Ly, g.Lz), dtype=torch.float32,
                      device="cpu")
    tm = TC.make_compressible_model(tg, advection=bt.WENO(5), time_discretization=(
        TC.SplitExplicitTimeDiscretization(damping_coefficient=damping,
                                           substep_floattype=td.substep_floattype,
                                           per_substep_kernels=True)))
    return dict(model=model, caches=caches, G=G, pert=pert, pair=pair, port=tm)


@pytest.fixture(scope="module")
def pallas_cases():
    """Each case of :data:`PALLAS_CASES` through the Pallas pair, once per
    module (about 3 s each in interpret mode)."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _pallas_case(*PALLAS_CASES[case])
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_pair_matches_pallas_pair(pallas_cases, case):
    """The plain K1/K2 loop against ``_run_k1``/``_run_k2`` in interpret
    mode on the same float32 stage."""
    c = pallas_cases(case)
    _, gate, bf16 = PALLAS_CASES[case]
    t = lambda a: None if a is None else torch.tensor(np.asarray(a))
    pert = [t(a) for a in c["pert"]]
    if bf16:
        pert[:5] = [a.to(torch.bfloat16) for a in pert[:5]]
    tm = c["port"]
    got = acoustic_split.acoustic_substeps_split(
        tm.acoustic_config, tm.z_columns,
        TC.StageCaches(*(t(getattr(c["caches"], k)) for k in TC.StageCaches._fields)),
        TC.SlowTendencies(*(t(getattr(c["G"], k)) for k in TC.SlowTendencies._fields)),
        acoustic.Perturbations(*pert), 0.5, 3, gate)
    assert got.rho.dtype == (torch.bfloat16 if bf16 else torch.float32)
    for name in FIELDS:
        err = _max_rel(getattr(got, name), getattr(c["pair"], name))
        # TestFusedAcousticSubstep's limits: float32 reassociation and FMA
        # contraction, 5e-5 of each field's largest value; bfloat16 carries
        # may round the other way where the two float32 results straddle a
        # rounding boundary, 3e-2
        assert err < (3e-2 if bf16 else 5e-5), f"{name}: {err:.2e}"


@pytest.mark.parametrize("case", ["thermal_gated", "none_ungated"])
def test_pallas_pair_matches_jnp_loop(pallas_cases, case):
    """No reference test runs K1/K2: the Pallas pair against the jnp loop,
    at ``TestFusedAcousticSubstep._compare``'s 5e-5."""
    c = pallas_cases(case)
    with jax.disable_jit():
        ref = JC.acoustic_substep_loop(c["model"], c["caches"], c["G"], c["pert"], 0.5, 3,
                                       gate_first=PALLAS_CASES[case][1])
    for name in FIELDS:
        err = _max_rel(getattr(c["pair"], name), getattr(ref, name))
        assert err < 5e-5, f"{name}: {err:.2e}"


# ---------------------------------------------------------------------------
# float64 against breeze_tpu
# ---------------------------------------------------------------------------

#: (32, 16, 16) over 1600 × 800 × 800 m: Δx = 50 m, so N = 7 substeps at
#: Δt = 0.5 s, as at 256 × 256 × 128 over 12.8 km
SIZE, EXTENT, DT = (32, 16, 16), (1600.0, 800.0, 800.0), 0.5
NAMES = ("rho", "rho_u", "rho_v", "rho_w", "rho_theta")


def _models(stretched, damping, per_substep):
    """The bubble configuration through both packages, float64."""
    z = (0.0, EXTENT[2])
    if stretched:
        z = np.concatenate([[0.0], np.cumsum(30.0 * 1.06 ** np.arange(SIZE[2]))])
    x, y = (0.0, EXTENT[0]), (0.0, EXTENT[1])
    jg = bz.make_grid(size=SIZE, x=x, y=y, z=z, topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                      halo=3, dtype=jnp.float64)
    jm = JC.make_compressible_model(
        jg, advection=bz.WENO(5), coriolis=bz.FPlane(1e-4),
        time_discretization=JC.SplitExplicitTimeDiscretization(
            acoustic_cfl=0.5, damping_coefficient=damping))
    tg = bt.make_grid(SIZE, x=x, y=y, z=z, dtype=torch.float64, device="cpu")
    tm = TC.make_compressible_model(
        tg, advection=bt.WENO(5), coriolis=bt.FPlane(1e-4),
        time_discretization=TC.SplitExplicitTimeDiscretization(
            acoustic_cfl=0.5, damping_coefficient=damping, per_substep_kernels=per_substep))
    return jm, tm


def _jax_bubble(jm, noise_seed=None):
    """The bubble in θ; with ``noise_seed``, noise on the momenta and ρθ."""
    cx, cy, cz = 0.5 * EXTENT[0], 0.5 * EXTENT[1], 0.25 * float(jm.grid.Lz)
    js = JC.compressible_initial_state(jm, theta=lambda x, y, z: 300.0 + 0.5 * jnp.exp(
        -((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / 500.0 ** 2))
    if noise_seed is None:
        return js
    rng = np.random.default_rng(noise_seed)
    noise = lambda sd: jnp.asarray(rng.normal(0.0, sd, jm.grid.shape))
    return js.replace(rho_u=js.rho_u + noise(0.5), rho_v=js.rho_v + noise(0.5),
                      rho_w=js.rho_w.at[1:].add(noise(0.2)[1:]),
                      rho_theta=js.rho_theta + noise(0.05))


def _to_torch(js):
    return convert.compressible_state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in NAMES}, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("damping,gate_first", [(0.1, True), (0.0, False)],
                         ids=["thermal_gated", "none_ungated"])
def test_plain_pair_matches_jnp_loop_f64(damping, gate_first):
    """One stage of 7 substeps of the plain pair against
    ``acoustic_substep_loop`` and against the port's own plain loop, on
    the noisy bubble over stretched z with noise on the five
    perturbations, in float64."""
    jm, tm = _models(True, damping, True)
    js = _jax_bubble(jm, noise_seed=4)
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
    args = (tm.acoustic_config, tm.z_columns, TC.stage_caches(tm, ts, taux),
            TC.slow_tendencies(tm, ts, taux),
            acoustic.Perturbations(*(torch.tensor(np.asarray(a)) for a in pj)), DT / 7, 7,
            gate_first)
    got = acoustic_split.acoustic_substeps_split(*args)
    own = acoustic.acoustic_substeps_plain(*args)
    for name in FIELDS:
        # float64 roundoff: the pair multiplies by 1/Δz and divides by the
        # sweep's pivot where the jnp loop divides by Δz and the port's
        # loop multiplies by 1/pivot
        err = tp.max_rel_err(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
        assert err < 1e-10, f"{name} against the jnp loop: {err:.2e}"
        err = _max_rel(getattr(got, name), getattr(own, name))
        assert err < 1e-10, f"{name} against acoustic_substeps_plain: {err:.2e}"


@pytest.fixture(scope="module")
def split_bubble_step():
    """One WS-RK3 step (3 + 4 + 7 substeps) of the dry bubble through the
    pair, and ``breeze_tpu``'s step from the same state."""
    jm, tm = _models(False, 0.1, True)
    js = _jax_bubble(jm)
    ts = bt.acoustic_rk3_step(tm, bubble.bubble_state(tm), DT)
    with jax.disable_jit():
        js = JC.acoustic_rk3_step(jm, js, DT)
    return ts, js


@pytest.mark.parametrize("name", NAMES)
def test_split_bubble_step_matches(split_bubble_step, name):
    """The split slice: the bubble's step through the pair, field by field."""
    ts, js = split_bubble_step
    err = tp.max_rel_err(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    # float64 roundoff through 14 substeps, relative to each field's max
    assert err < 1e-10, f"{name}: {err:.2e}"
    assert ts.time == pytest.approx(DT)


def test_split_route_is_selected_by_the_model(monkeypatch):
    """``per_substep_kernels`` reaches the acoustic config, and the step
    takes the pair (moist ρθ included) and not the stage kernel's loop."""
    calls = []

    def fail(*args, **kwargs):
        raise AssertionError("the stage kernel's loop ran on the split route")
    monkeypatch.setattr(TC, "acoustic_substeps", fail)
    monkeypatch.setattr(TC, "acoustic_substeps_split",
                        lambda *a, **k: calls.append(1) or acoustic_split.acoustic_substeps_split(
                            *a, **k))
    model = bubble.bubble_model((8, 8, 6), dtype=torch.float64, device="cpu",
                                extent=(400.0, 400.0, 300.0), moist=True,
                                per_substep_kernels=True)
    assert model.acoustic_config.per_substep_kernels
    state = bt.acoustic_rk3_step(model, bubble.bubble_state(model), 0.5)
    assert len(calls) == 3
    for name in NAMES + ("rho_qt",):
        assert bool(torch.isfinite(getattr(state, name)).all()), name
    assert not bubble.bubble_model((8, 8, 6), dtype=torch.float64,
                                   device="cpu").acoustic_config.per_substep_kernels


def _hill(g):
    return TT.make_terrain(g, bt.ThermodynamicConstants(), lambda x, y: 10.0 + 0 * x)


@pytest.mark.parametrize("kw", [
    dict(terrain=_hill), dict(sponge=TC.UpperSponge()), dict(formulation="static_energy"),
    dict(damping=TC.DirectDivergenceDamping(0.1))],
    ids=["terrain", "sponge", "static_energy", "direct_damping"])
def test_per_substep_kernels_outside_the_pair_envelope_raises(kw):
    """The pair covers flat ρθ with no or thermal damping and no sponge;
    the reference falls back to its jnp loop elsewhere, the port refuses."""
    g = bt.make_grid((8, 8, 8), extent=(400.0, 400.0, 400.0), dtype=torch.float64,
                     device="cpu")
    td = TC.SplitExplicitTimeDiscretization(
        per_substep_kernels=True, sponge=kw.pop("sponge", None),
        damping=kw.pop("damping", None))
    if "terrain" in kw:
        kw["terrain"] = kw["terrain"](g)
    with pytest.raises(NotImplementedError, match="per_substep_kernels"):
        TC.make_compressible_model(g, advection=bt.WENO(5), time_discretization=td, **kw)
    # the same configuration without the pair is in the ported envelope
    TC.make_compressible_model(g, advection=bt.WENO(5), time_discretization=(
        TC.SplitExplicitTimeDiscretization(sponge=td.sponge, damping=td.damping)), **kw)
