"""The port's kernels against the JAX package.

- ``kernels.tendency``: the port's plain version (through ``stage_update``)
  against ``breeze_tpu``'s fused Pallas kernel in interpret mode in float32,
  and against the jnp path in float64;
- ``kernels.columnar``: the plain version against
  ``fix_negative_moisture_pallas(..., interpret=True)`` and the jnp closed
  form;
- ``kernels.momentum``, ``kernels.advection``, ``kernels.acoustic``: the
  plain versions against ``momentum_div_pallas``, ``div_rho_u_c_pallas``
  and ``acoustic_substep_loop_pallas`` in interpret mode, in float32 (the
  float64 checks against the jnp path are in ``test_torch_compressible.py``);

The CUDA kernels against their plain versions are in ``test_torch_cuda.py``.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breeze_tpu as bz
import torch_parity as tp
from breeze_tpu import fields as jfl
from breeze_tpu import model as JM
from breeze_tpu.pallas_kernels import advection as padv
from breeze_tpu.pallas_kernels import columnar as pcol
from breeze_tpu.physics.closures import SmagorinskyLilly as JSmag
from breeze_tpu.physics.microphysics import fix_negative_moisture as jax_fix_negative
import breeze_tpu_torch as bt
from breeze_tpu_torch import bomex, convert
from breeze_tpu_torch import fields as tfl
from breeze_tpu_torch import model as TM
from breeze_tpu_torch.dynamics import compressible as TC
from breeze_tpu_torch.kernels import acoustic, advection, columnar, momentum, tendency
from breeze_tpu_torch.physics.microphysics import fix_negative_moisture

ALPHA, DT = 0.25, 0.5


def _perturbed(jax_model, seed=3):
    """A BOMEX-like JAX state with noise on every prognostic, and a distinct
    stage-0 state (so the (1−α) branch of the blend is exercised)."""
    g = jax_model.grid
    shape = g.shape
    rng = np.random.default_rng(seed)
    rc = np.asarray(jax_model.reference.rho_col, np.float64)
    as_j = lambda a: jnp.asarray(a, g.dtype)
    js = tp.jax_bomex_state(jax_model, tp.noise(shape))
    js = js.replace(
        rho_u=js.rho_u + as_j(rc * rng.normal(0.0, 1.0, shape)),
        rho_v=js.rho_v + as_j(rc * rng.normal(0.0, 1.0, shape)),
        rho_w=js.rho_w + as_j(rc * rng.normal(0.0, 0.5, shape)),
        rho_qt=js.rho_qt * as_j(1.0 + 0.05 * rng.normal(0.0, 1.0, shape)))
    js0 = js.replace(rho_u=js.rho_u + 0.1, rho_theta=js.rho_theta * 1.001)
    return js, js0


def _stage_pair(jax_model, torch_model, dtype, interpret):
    js, js0 = _perturbed(jax_model)
    ts = convert.state_from_numpy(tp.to_numpy(js), dtype=dtype, device="cpu")
    ts0 = convert.state_from_numpy(tp.to_numpy(js0), dtype=dtype, device="cpu")
    aux = JM.diagnose(jax_model, js, T_guess=js.diagnostics.get("T_warm"))
    # monkeypatch puts back whatever the variable held before, so that no
    # later test on the same worker sees this one's setting
    with pytest.MonkeyPatch.context() as mp:
        if interpret:
            mp.setenv("BREEZE_TPU_PALLAS_INTERPRET", "1")
        ref = JM.stage_update(jax_model, js, js0, DT, ALPHA, aux=aux)
    taux = TM.diagnose(torch_model, ts, T_guess=ts.diagnostics.get("T_warm"))
    got = TM.stage_update(torch_model, ts, ts0, DT, ALPHA, aux=taux)
    return got, ref


@pytest.fixture(scope="module")
def f32_stage():
    """One BOMEX stage at (nx, ny, nz) = (128, 16, 16) in float32: the port's
    plain fused tendency vs the Pallas kernel in interpret mode (one
    interpret run for the module)."""
    size = (128, 16, 16)
    return _stage_pair(tp.jax_bomex_model(size, jnp.float32),
                       bomex.bomex_model(size, dtype=torch.float32, device="cpu"),
                       torch.float32, interpret=True)


@pytest.mark.parametrize("name", tp.PROGNOSTICS)
def test_fused_tendency_plain_matches_pallas_interpret(f32_stage, name):
    got, ref = f32_stage
    err = tp.max_rel_err(getattr(got, name).numpy(), getattr(ref, name),
                         skip_w0=name == "rho_w")
    # state-relative 1e-5, the tolerance of TestFusedSubstep's moist closure
    # stage: G enters at O(αΔt·G) against O(1) state values, so float32
    # reassociation in the WENO and closure arithmetic stays far below it
    assert err < 1e-5, f"{name}: state-relative error {err:.2e}"


def _dry_fplane(size, dtype, package):
    kw = dict(extent=(6_400.0, 3_200.0, 2_000.0), halo=3)
    if package == "jax":
        g = bz.make_grid(size=size, topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=dtype, **kw)
        return bz.make_model(g, advection=bz.WENO(5), potential_temperature=300.0,
                             coriolis=bz.FPlane(1e-4))
    g = bt.make_grid(size, extent=kw["extent"], dtype=dtype, device="cpu")
    return bt.make_model(g, advection=bt.WENO(5), potential_temperature=300.0,
                         coriolis=bt.FPlane(1e-4))


def _moist_closure(size, dtype, package):
    kw = dict(extent=(6_400.0, 3_200.0, 2_000.0), halo=3)
    if package == "jax":
        g = bz.make_grid(size=size, topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=dtype, **kw)
        return bz.make_model(
            g, advection=bz.WENO(5), potential_temperature=300.0,
            microphysics=bz.SaturationAdjustment(equilibrium=bz.WarmPhaseEquilibrium()),
            closure=JSmag())
    g = bt.make_grid(size, extent=kw["extent"], dtype=dtype, device="cpu")
    return bt.make_model(g, advection=bt.WENO(5), potential_temperature=300.0,
                         microphysics=bt.SaturationAdjustment(),
                         closure=bt.SmagorinskyLilly())


def _bomex(size, dtype, package):
    if package == "jax":
        return tp.jax_bomex_model(size, dtype)
    return bomex.bomex_model(size, dtype=dtype, device="cpu")


@pytest.mark.parametrize("config", [_dry_fplane, _moist_closure, _bomex],
                         ids=["dry_fplane", "moist_closure", "bomex"])
def test_fused_tendency_plain_matches_jnp_f64(config):
    """In float64 the plain version equals the jnp path (unfused advection,
    jnp closure, forcings and blend) to roundoff."""
    size = (16, 8, 12)
    jm = config(size, jnp.float64, "jax")
    tm = config(size, torch.float64, "torch")
    if not jm.has_moisture:
        # the dry configs carry no ρqᵗ: build their states directly
        js = bz.initial_state(jm, theta=lambda x, y, z: 300.0 + 0.01 * z,
                              u=lambda x, y, z: 3.0 + 0.0 * z,
                              enforce_mass_conservation=False)
        rng = np.random.default_rng(5)
        js = js.replace(**{k: getattr(js, k) + jnp.asarray(
            rng.normal(0.0, 0.5, jm.grid.shape)) for k in ("rho_u", "rho_v", "rho_w")})
        js0 = js.replace(rho_u=js.rho_u + 0.1)
        ts = convert.state_from_numpy(tp.to_numpy(js), dtype=torch.float64, device="cpu")
        ts0 = convert.state_from_numpy(tp.to_numpy(js0), dtype=torch.float64, device="cpu")
        ref = JM.stage_update(jm, js, js0, DT, ALPHA)
        got = TM.stage_update(tm, ts, ts0, DT, ALPHA)
    else:
        got, ref = _stage_pair(jm, tm, torch.float64, interpret=False)
    for name in tp.PROGNOSTICS:
        if getattr(ref, name) is None:
            continue
        err = tp.max_rel_err(getattr(got, name).numpy(), getattr(ref, name),
                             skip_w0=name == "rho_w")
        # float64 roundoff, amplified by O(10) in the small ρv/ρw fields
        assert err < 1e-11, f"{name}: state-relative error {err:.2e}"


def test_fused_tendency_refuses_other_devices():
    """Only CPU tensors take the plain version; any other device must
    launch the kernel or raise."""
    model = bomex.bomex_model((8, 8, 8), dtype=torch.float32, device="cpu")
    meta = lambda t: torch.empty_like(t, device="meta")
    win = meta(torch.zeros(14, 14, 8))
    cur = [meta(torch.zeros(8, 8, 8))] * 5
    with pytest.raises(ValueError, match="CUDA"):
        tendency.fused_tendency(model.tendency_config, model.tendency_columns,
                                win, win, win, [win, win], win, None,
                                [None] * 5, [None] * 5, cur, cur, ALPHA, DT)
    with pytest.raises(ValueError, match="CUDA"):
        columnar.fix_negative(meta(torch.zeros(8, 8, 8)), meta(torch.ones(8)))


def _negative_moisture_case(nz, ny, nx, seed, stretch, dtype):
    rng = np.random.default_rng(seed)
    # mostly positive with scattered negatives, and columns driven negative
    rq = rng.normal(2e-3, 3e-3, (nz, ny, nx)).astype(dtype)
    rq[:, 0, :2] = -np.abs(rq[:, 0, :2]) - 1e-3
    dz = (20.0 * 1.04 ** np.arange(nz) if stretch else np.full(nz, 25.0)).astype(dtype)
    return rq, dz


@pytest.mark.parametrize("stretch", [False, True], ids=["uniform", "stretched"])
def test_fix_negative_plain_matches_pallas_interpret(stretch):
    rq, dz = _negative_moisture_case(12, 8, 128, 1, stretch, np.float32)
    ref = np.asarray(pcol.fix_negative_moisture_pallas(
        jnp.asarray(rq), jnp.asarray(dz).reshape(-1, 1, 1), interpret=True))
    got = columnar.fix_negative(torch.from_numpy(rq), torch.from_numpy(dz)).numpy()
    # the Pallas kernel multiplies by 1/Δz where the port divides, and sums
    # by suffix scans where the port runs the recurrence: last-ulp rounding
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-8)
    # conservation of the column integral of ρq·Δz
    np.testing.assert_allclose((got * dz[:, None, None]).sum(0),
                               (rq * dz[:, None, None]).sum(0), rtol=1e-5, atol=1e-7)
    # every level above the bottom ends non-negative; only the bottom keeps
    # what level 1 could not cover
    assert (got[1:] >= 0).all()


@pytest.mark.parametrize("stretch", [False, True, None],
                         ids=["uniform", "stretched", "no_dz"])
def test_fix_negative_plain_matches_jnp_f64(stretch):
    rq, dz = _negative_moisture_case(10, 6, 7, 2, bool(stretch), np.float64)
    # no_dz: the reference's uniform-spacing default against unit Δz
    dz_j = None if stretch is None else jnp.asarray(dz).reshape(-1, 1, 1)
    dz_t = torch.from_numpy(np.ones_like(dz) if stretch is None else dz).reshape(-1, 1, 1)
    ref = np.asarray(jax_fix_negative(jnp.asarray(rq), dz_j))
    got = fix_negative_moisture(torch.from_numpy(rq), dz_t).numpy()
    # the closed form (cumsum/cummax) and the recurrence agree to roundoff
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-17)


# ---------------------------------------------------------------------------
# The compressible core's kernels, float32, against the Pallas kernels
# ---------------------------------------------------------------------------

def _grids(size, stretched):
    """The same (nx, ny, nz) grid in both packages, float32."""
    nz = size[2]
    z = ((0.0, 300.0) if not stretched
         else np.concatenate([[0.0], np.cumsum(10.0 * 1.08 ** np.arange(nz))]))
    x, y = (0.0, 1000.0), (0.0, 500.0)
    jg = bz.make_grid(size=size, x=x, y=y, z=z,
                      topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                      halo=3, dtype=jnp.float32)
    return jg, bt.make_grid(size, x=x, y=y, z=z, dtype=torch.float32, device="cpu")


def _fields(shape, seed, **sds):
    """Named float32 fields N(mean, sd), as (mean, sd) pairs; ρw-like
    entries (``w*``) vanish on the bottom face."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (mean, sd) in sds.items():
        a = rng.normal(mean, sd, shape).astype(np.float32)
        if name.startswith(("w", "rw")):
            a[0] = 0.0
        out[name] = a
    return out


def _windows(jg, tg, arrays, locs):
    """Each array padded for both kernels: the Pallas pre-pad (z by 3, y by
    4) and the port's (z and y by 3)."""
    jw = [padv.pad_zy(jnp.asarray(arrays[k]), jg, getattr(jfl, loc)) for k, loc in locs]
    tw = [tfl.pad(torch.from_numpy(arrays[k]), tg, getattr(tfl, loc), halo=3, axes=(0, 1))
          for k, loc in locs]
    return jw, tw


def _inv_dz(tg):
    inv = lambda dz: torch.tensor([1.0 / d for d in dz], dtype=torch.float32)
    return inv(tg.dz_c_meta), inv(tg.dz_f_meta[: tg.nz])


@pytest.mark.parametrize("stretched", [False, True], ids=["uniform", "stretched"])
def test_momentum_div_plain_matches_pallas_interpret(stretched):
    from breeze_tpu.pallas_kernels import momentum as pmom
    jg, tg = _grids((128, 16, 16), stretched)
    arrays = _fields(jg.shape, 3, ru=(0.0, 1.0), rv=(0.0, 1.0), rw=(0.0, 1.0),
                     u=(0.0, 2.0), v=(0.0, 2.0), w=(0.0, 1.0))
    locs = [("ru", "CCF"), ("rv", "CFC"), ("rw", "FCC"),
            ("u", "CCF"), ("v", "CFC"), ("w", "FCC")]
    jw, tw = _windows(jg, tg, arrays, locs)
    ref = pmom.momentum_div_pallas(jg, *jw, interpret=True)
    got = momentum.momentum_div(*tw, *_inv_dz(tg), float(1.0 / tg.dx), float(1.0 / tg.dy))
    for name, a, b in zip("uvw", got, ref):
        a, b = a.numpy(), np.asarray(b)
        # both read the same below-wall pad data in row 0 of dw.  float32
        # reassociation in the WENO weights: 1e-5 of the largest value
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < 1e-5, f"d{name}: {err:.2e}"


@pytest.mark.parametrize("stretched,bounds", [(False, False), (False, True),
                                              (True, False), (True, True)],
                         ids=["uniform", "uniform_bounds", "stretched",
                              "stretched_bounds"])
def test_div_rho_u_c_plain_matches_pallas_interpret(stretched, bounds):
    jg, tg = _grids((128, 16, 16), stretched)
    arrays = _fields(jg.shape, 5, c=(300.0, 1.0), u=(0.0, 2.0), v=(0.0, 2.0),
                     w=(0.0, 1.0), rho=(1.0, 0.1))
    locs = [("c", "CCC"), ("u", "CCF"), ("v", "CFC"), ("w", "FCC"), ("rho", "CCC")]
    jw, tw = _windows(jg, tg, arrays, locs)
    ref = np.asarray(padv.div_rho_u_c_pallas(jg, *jw, bounds=bounds, interpret=True))
    got = advection.div_rho_u_c(*tw, _inv_dz(tg)[0], float(1.0 / tg.dx),
                                float(1.0 / tg.dy), bounds=bounds).numpy()
    # the Pallas kernel normalizes the weights with an approximate
    # reciprocal, whose scale cancels; the rest is float32 reassociation
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-5, f"{err:.2e}"


def _acoustic_stage(damping, substeps=4, ny=8):
    """``TestFusedAcousticSubstep.setup``'s (128, 8, 16) stage: the JAX
    model, caches and slow tendencies, and noise on the perturbations."""
    from breeze_tpu.dynamics import compressible as JC
    g = bz.make_grid(size=(128, ny, 16), extent=(12800.0, 100.0 * ny, 1600.0),
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                     halo=3, dtype=jnp.float32)
    td = JC.SplitExplicitTimeDiscretization(substeps=substeps,
                                            damping_coefficient=damping)
    model = JC.make_compressible_model(g, advection=bz.Centered(2), time_discretization=td)
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


@pytest.mark.parametrize("damping,gate_first", [(0.1, True), (0.0, False)],
                         ids=["thermal_gated", "none_ungated"])
def test_acoustic_plain_matches_pallas_interpret(damping, gate_first):
    from breeze_tpu.pallas_kernels.acoustic import acoustic_substep_loop_pallas
    model, caches, G, pert = _acoustic_stage(damping)
    ref = acoustic_substep_loop_pallas(model, caches, G, pert, 0.5, 3,
                                       gate_first=gate_first, interpret=True)
    g = model.grid
    tg = bt.make_grid((g.nx, g.ny, g.nz), extent=(g.Lx, g.Ly, g.Lz),
                      dtype=torch.float32, device="cpu")
    tm = bt.make_compressible_model(
        tg, advection=bt.WENO(5),
        time_discretization=bt.SplitExplicitTimeDiscretization(
            damping_coefficient=damping))
    t = lambda a: None if a is None else torch.tensor(np.asarray(a))   # C_rho, rho_qt
    got = acoustic.acoustic_substeps(
        tm.acoustic_config, tm.z_columns,
        TC.StageCaches(*(t(getattr(caches, k)) for k in TC.StageCaches._fields)),
        TC.SlowTendencies(*(t(getattr(G, k)) for k in TC.SlowTendencies._fields)),
        acoustic.Perturbations(*(t(a) for a in pert)), 0.5, 3, gate_first)
    for name in acoustic.Perturbations._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        # TestFusedAcousticSubstep's limit: float32, the Pallas kernel
        # divides twice in the sweep where the plain loop multiplies by 1/den
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-10)
        assert err < 5e-5, f"{name}: {err:.2e}"
