"""The CUDA kernels of ``breeze_tpu_torch`` against their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
module imports no JAX, so that it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import breeze_tpu_torch as bt
from breeze_tpu_torch import bomex, bubble, ridge, ssp_rk3_step
from breeze_tpu_torch import fields as fl
from breeze_tpu_torch import model as TM
from breeze_tpu_torch.dynamics import compressible as TC
from breeze_tpu_torch.dynamics import terrain as TT
from breeze_tpu_torch.kernels import (acoustic, acoustic_split, advection, closure, columnar,
                                      momentum, projection, tendency)

NAMES = ("rho_u", "rho_v", "rho_w", "rho_theta", "rho_qt")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _noise(shape, seed=1):
    return 0.1 * np.random.default_rng(seed).standard_normal(shape)


def _rel_to_max(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


#: bfloat16 carries of the kernel and of the plain loop differ only where
#: their float32 values straddle a rounding boundary: at most this share of
#: the points (a carry rounded twice makes a fifth to nine tenths differ)
BF16_MISMATCH_SHARE = 0.1


def _mismatch_share(got, ref):
    return float((got != ref).double().mean())


def _perturbed(model, state, seed=2):
    """Noise on every prognostic and a distinct stage-0 state, so that all
    the momentum WENO, closure and blend terms are non-trivial."""
    g = model.grid
    rng = np.random.default_rng(seed)
    gauss = lambda sd: torch.as_tensor(rng.normal(0.0, sd, g.shape),
                                       dtype=g.dtype, device=g.device)
    rho = model.reference.rho_col
    s = state.replace(rho_u=state.rho_u + rho * gauss(1.0),
                      rho_v=state.rho_v + rho * gauss(1.0),
                      rho_w=state.rho_w + rho * gauss(0.5),
                      rho_qt=state.rho_qt * (1.0 + gauss(0.05)))
    return s, s.replace(rho_u=s.rho_u + 0.1, rho_theta=s.rho_theta * 1.001)


#: The fused tendency kernel's cases: (nx, ny, nz) and BOMEX as it is
#: (forcings included), or an ``_anelastic`` model (z stretched, moist,
#: closure, FPlane).  Beyond BOMEX's blocks and ragged sizes, the tile's
#: edges: nz over two z chunks and not a multiple of one, nx and ny not
#: multiples of the 32 × 16 tile; nx below the tile's width (its x halo
#: wraps at both sides); K = 1 with θ's window for Lilly's correction; no
#: closure; no Coriolis; the z carries across a chunk start with varying
#: 1/Δz.
FUSED_CASES = {
    "blocks": ((64, 32, 32), "bomex"),
    "ragged": ((36, 20, 12), "bomex"),
    "z_chunks": ((40, 12, 2 * tendency.Z_CHUNK + 7), "bomex"),
    "narrow_x": ((12, 20, 40), "bomex"),
    "dry": ((36, 20, 13), dict(stretched=True, moist=False, closure=True, coriolis=True)),
    "no_closure": ((40, 16, 24), dict(stretched=False, moist=True, closure=False,
                                      coriolis=True)),
    "no_coriolis": ((36, 20, 13), dict(stretched=False, moist=True, closure=True,
                                       coriolis=False)),
    "stretched": ((36, 12, tendency.Z_CHUNK + 9), dict(stretched=True, moist=True,
                                                       closure=True, coriolis=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FUSED_CASES))
@pytest.mark.parametrize("what", ["G", "increment"])
def test_cuda_fused_tendency_matches_plain(cuda_device, case, what):
    """``G``: zero current and stage-0 fields with α = Δt = 1 make the
    output the tendency alone; ``increment``: out − ((1−α)s⁰ + α·s) = αΔt·G
    at α = 2/3, Δt = 3, where αΔt·G stands well above the float32 rounding
    of the state it is added to.  Each against its own largest value."""
    size, kind = FUSED_CASES[case]
    if kind == "bomex":
        model = bomex.bomex_model(size, dtype=torch.float32, device=cuda_device)
        state, state0 = _perturbed(model, bomex.bomex_state(model, _noise(model.grid.shape)))
    else:
        model, state, _ = _anelastic(size, kind["stretched"], cuda_device, kind["moist"],
                                     closure=kind["closure"], coriolis=kind["coriolis"])
        state0 = state.replace(rho_u=state.rho_u + 0.1, rho_theta=state.rho_theta * 1.001)
    args = TM.tendency_kernel_args(model, state, TM.diagnose(model, state), 3.0, state0,
                                   2.0 / 3.0)
    cfg = args[0]
    assert model.fused
    assert (cfg.closure is not None) == (kind == "bomex" or kind["closure"])
    assert (cfg.f_cor is not None) == (kind == "bomex" or kind["coriolis"])
    cur, prev, alpha, _ = args[10:]
    if what == "G":
        zeros = [torch.zeros_like(c) for c in cur]
        args = args[:10] + (zeros, zeros, 1.0, 1.0)
    before = tendency.launches
    got = tendency.fused_tendency(*args)
    torch.cuda.synchronize()
    assert tendency.launches == before + 1
    ref = tendency.fused_tendency_plain(*args)
    if what == "increment":
        base = [(1.0 - alpha) * p.double() + alpha * c.double() for c, p in zip(cur, prev)]
        got = [g.double() - b for g, b in zip(got, base)]
        ref = [r.double() - b for r, b in zip(ref, base)]
    for name, g, r in zip(NAMES, got, ref):
        if name == "rho_w":
            g, r = g[1:], r[1:]
        # 1e-5 of the field's largest value: float32 reassociation and FMA
        # contraction between the kernel and the plain version
        assert _rel_to_max(g, r) < 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 32, 96), (7, 5, 130)], ids=["blocks", "ragged"])
def test_cuda_fix_negative_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(4)
    rq = rng.normal(2e-3, 3e-3, shape).astype(np.float32)
    rq[:, 0, :2] = -np.abs(rq[:, 0, :2]) - 1e-3
    dz = (20.0 * 1.04 ** np.arange(shape[0])).astype(np.float32)
    before = columnar.launches
    got = columnar.fix_negative(torch.from_numpy(rq).to(cuda_device),
                                torch.from_numpy(dz).to(cuda_device))
    torch.cuda.synchronize()
    assert columnar.launches == before + 1
    ref = columnar.fix_negative_plain(torch.from_numpy(rq), torch.from_numpy(dz))
    # the kernel contracts m·Δz + carry into one fused multiply-add
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=2e-5, atol=1e-8)


@pytest.mark.cuda
def test_cuda_step_goes_through_both_kernels(cuda_device):
    model = bomex.bomex_model((32, 32, 32), dtype=torch.float32, device=cuda_device)
    state = bomex.bomex_state(model, _noise(model.grid.shape))
    t0, f0 = tendency.launches, columnar.launches
    state = ssp_rk3_step(model, state, 1.0)
    torch.cuda.synchronize()
    assert tendency.launches - t0 == 3
    assert columnar.launches - f0 == 1
    for name in NAMES:
        assert bool(torch.isfinite(getattr(state, name)).all()), name


def _compressible(size, stretched, device, damping=0.1):
    """The bubble configuration on an (nx, ny, nz) grid with Δx = 50 m, z
    uniform (25 m) or stretched, and its state with noise on the momenta
    and ρθ."""
    nx, ny, nz = size
    z = (np.concatenate([[0.0], np.cumsum(20.0 * 1.05 ** np.arange(nz))])
         if stretched else (0.0, 25.0 * nz))
    g = bt.make_grid(size, x=(0.0, 50.0 * nx), y=(0.0, 50.0 * ny), z=z,
                     dtype=torch.float32, device=device)
    model = TC.make_compressible_model(
        g, advection=bt.WENO(5), coriolis=bt.FPlane(1e-4),
        time_discretization=TC.SplitExplicitTimeDiscretization(damping_coefficient=damping))
    state = bubble.bubble_state(model)
    rng = np.random.default_rng(6)
    noise = lambda sd: torch.as_tensor(rng.normal(0.0, sd, g.shape), dtype=g.dtype,
                                       device=device)
    rho_w = state.rho_w + noise(0.2)
    rho_w[0] = 0.0
    return model, state.replace(rho_u=state.rho_u + noise(0.5), rho_v=state.rho_v + noise(0.5),
                                rho_w=rho_w, rho_theta=state.rho_theta + noise(0.05))


def _windows(model, state):
    g = model.grid
    aux = TC.compressible_diagnose(model, state)
    pz = lambda a, loc: fl.pad(a, g, loc, halo=3, axes=(0, 1))
    vel = [pz(aux.u, fl.CCF), pz(aux.v, fl.CFC), pz(aux.w, fl.FCC)]
    mom = [pz(state.rho_u, fl.CCF), pz(state.rho_v, fl.CFC), pz(state.rho_w, fl.FCC)]
    return aux, vel, mom, pz


@pytest.mark.cuda
@pytest.mark.parametrize("size,stretched", [((64, 32, 32), False), ((36, 20, 13), True)],
                         ids=["blocks", "ragged_stretched"])
def test_cuda_momentum_div_matches_plain(cuda_device, size, stretched):
    model, state = _compressible(size, stretched, cuda_device)
    _, vel, mom, _ = _windows(model, state)
    args = (*mom, *vel, model.z_columns.inv_dzc, model.z_columns.inv_dzf, 1.0 / model.grid.dx, 1.0 / model.grid.dy)
    before = momentum.launches
    got = momentum.momentum_div(*args)
    torch.cuda.synchronize()
    assert momentum.launches == before + 1
    for name, g, r in zip("uvw", got, momentum.momentum_div_plain(*args)):
        # float32 reassociation and FMA contraction: 1e-5 of the largest value
        assert _rel_to_max(g, r) < 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("size,stretched", [((64, 32, 32), False), ((36, 20, 13), True)],
                         ids=["blocks", "ragged_stretched"])
@pytest.mark.parametrize("bounds", [False, True], ids=["weno", "bounds"])
def test_cuda_div_rho_u_c_matches_plain(cuda_device, size, stretched, bounds):
    model, state = _compressible(size, stretched, cuda_device)
    aux, vel, _, pz = _windows(model, state)
    args = (pz(aux.theta, fl.CCC), *vel, pz(state.rho, fl.CCC), model.z_columns.inv_dzc,
            1.0 / model.grid.dx, 1.0 / model.grid.dy, bounds)
    before = advection.launches
    got = advection.div_rho_u_c(*args)
    torch.cuda.synchronize()
    assert advection.launches == before + 1
    assert _rel_to_max(got, advection.div_rho_u_c_plain(*args)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("size,stretched,damping,n_tau,gate", [
    ((64, 32, 32), False, 0.1, 7, True), ((36, 20, 13), True, 0.1, 4, True),
    ((36, 20, 13), False, 0.0, 3, False)],
    ids=["blocks_thermal", "ragged_stretched_thermal", "ragged_none_ungated"])
def test_cuda_acoustic_matches_plain(cuda_device, size, stretched, damping, n_tau, gate):
    model, state = _compressible(size, stretched, cuda_device, damping)
    aux = TC.compressible_diagnose(model, state)
    caches = TC.stage_caches(model, state, aux)
    G = TC.slow_tendencies(model, state, aux)
    rng = np.random.default_rng(8)
    # noise on the five perturbations and on the sums they are added to
    pert = [torch.as_tensor(rng.normal(0.0, 1e-3, model.grid.shape), dtype=torch.float32,
                            device=cuda_device) for _ in range(8)]
    pert[3][0] = 0.0
    pert = acoustic.Perturbations(*pert)
    kept = [p.clone() for p in pert]
    args = (model.acoustic_config, model.z_columns, caches, G, pert, 0.5 / 7,
            n_tau, gate)
    before = acoustic.launches
    got = acoustic.acoustic_substeps(*args)
    torch.cuda.synchronize()
    # one launch a substep, the pivots and the closing pass
    assert acoustic.launches == before + n_tau + 2
    for name, p, k in zip(acoustic.Perturbations._fields, pert, kept):
        assert torch.equal(p, k), f"the kernel wrote its input {name}"
    for name, g, r in zip(acoustic.Perturbations._fields, got,
                          acoustic.acoustic_substeps_plain(*args)):
        # float32, the kernel's sweep on d·(1/den) and lo·(1/den) against
        # the plain (d − lo·d′)·(1/den), and its FMA contraction: 5e-5 of the
        # largest value, as the TPU kernel's test
        assert _rel_to_max(g, r) < 5e-5, name


def _branch_model(size, stretched, device, formulation, direct, bf16):
    """The moist bubble configuration on an (nx, ny, nz) grid with Δx = 50 m
    and z uniform (25 m) or stretched, in ``formulation``, with direct or
    thermal damping and bfloat16 or float32 carries; its state with noise on
    the momenta and the thermodynamic slot (×1000 in ρe, about the same
    pressure noise)."""
    nx, ny, nz = size
    z = (np.concatenate([[0.0], np.cumsum(20.0 * 1.05 ** np.arange(nz))])
         if stretched else (0.0, 25.0 * nz))
    g = bt.make_grid(size, x=(0.0, 50.0 * nx), y=(0.0, 50.0 * ny), z=z,
                     dtype=torch.float32, device=device)
    model = TC.make_compressible_model(
        g, advection=bt.WENO(5), coriolis=bt.FPlane(1e-4), formulation=formulation,
        microphysics=bt.SaturationAdjustment(),
        time_discretization=TC.SplitExplicitTimeDiscretization(
            substep_floattype="bfloat16" if bf16 else None,
            damping=TC.DirectDivergenceDamping(0.1) if direct else None))
    state = bubble.bubble_state(model)
    rng = np.random.default_rng(11)
    noise = lambda sd: torch.as_tensor(rng.normal(0.0, sd, g.shape), dtype=g.dtype,
                                       device=device)
    rho_w = state.rho_w + noise(0.2)
    rho_w[0] = 0.0
    scale = 1e3 if formulation == "static_energy" else 1.0
    return model, state.replace(rho_u=state.rho_u + noise(0.5), rho_v=state.rho_v + noise(0.5),
                                rho_w=rho_w, rho_theta=state.rho_theta + noise(0.05 * scale))


@pytest.mark.cuda
@pytest.mark.parametrize("branch,size,stretched,n_tau,gate", [
    ("crho_thermal", (64, 32, 32), False, 7, True),
    ("theta_direct", (36, 20, 13), True, 4, True),
    ("crho_direct", (64, 32, 32), True, 7, True),
    ("crho_direct", (36, 20, 13), False, 3, False),
    ("bf16", (64, 32, 32), False, 7, True),
    ("bf16_crho_direct", (36, 20, 13), True, 4, True)],
    ids=["blocks_crho_thermal", "ragged_stretched_theta_direct",
         "blocks_stretched_crho_direct", "ragged_crho_direct_ungated", "blocks_bf16",
         "ragged_stretched_bf16_crho_direct"])
def test_cuda_acoustic_branches_match_plain(cuda_device, branch, size, stretched, n_tau, gate):
    """The C_ρ (ρe), direct-damping and bfloat16-carry branches of the
    acoustic kernel against the plain loop on the card, on the moist bubble
    with noise on the perturbations and the sums."""
    formulation = "static_energy" if "crho" in branch else "potential_temperature"
    bf16 = branch.startswith("bf16")
    model, state = _branch_model(size, stretched, cuda_device, formulation,
                                 "direct" in branch, bf16)
    aux = TC.compressible_diagnose(model, state)
    caches = TC.stage_caches(model, state, aux)
    assert (caches.C_rho is not None) == ("crho" in branch)
    G = TC.slow_tendencies(model, state, aux)
    rng = np.random.default_rng(12)
    pert = [torch.as_tensor(rng.normal(0.0, 1e-3, model.grid.shape), dtype=torch.float32,
                            device=cuda_device) for _ in range(8)]
    pert[3][0] = 0.0
    if bf16:
        pert[:5] = [p.to(torch.bfloat16) for p in pert[:5]]
    pert = acoustic.Perturbations(*pert)
    kept = [p.clone() for p in pert]
    args = (model.acoustic_config, model.z_columns, caches, G, pert, 0.5 / 7, n_tau, gate)
    before = acoustic.launches
    got = acoustic.acoustic_substeps(*args)
    torch.cuda.synchronize()
    # one launch a substep, the pivots and the closing pass
    assert acoustic.launches == before + n_tau + 2
    for name, p, k in zip(acoustic.Perturbations._fields, pert, kept):
        assert torch.equal(p, k), f"the kernel wrote its input {name}"
    for name, g, r in zip(acoustic.Perturbations._fields, got,
                          acoustic.acoustic_substeps_plain(*args)):
        assert g.dtype == r.dtype, name
        # float32, the kernel's sweep on d·(1/den) and lo·(1/den) against
        # the plain (d − lo·d′)·(1/den), and its FMA contraction: 5e-5 of the
        # largest value, as the TPU kernel's test; bfloat16 carries may round
        # the other way where the two float32 results straddle a rounding
        # boundary: 3e-2, its limit
        assert _rel_to_max(g, r) < (3e-2 if bf16 else 5e-5), name
        if bf16:
            assert _mismatch_share(g, r) < BF16_MISMATCH_SHARE, name


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(moist=True),
                                dict(moist=True, formulation="static_energy",
                                     damping=TC.DirectDivergenceDamping(0.1)),
                                dict(substep_floattype="bfloat16")],
                         ids=["moist_theta", "moist_rhoe_direct", "bf16"])
def test_cuda_bubble_variant_step_goes_through_the_kernels(cuda_device, kw):
    """One step of each bubble variant: the moist ones advect ρqᵗ through
    the scalar kernel (3 more launches) and repair it at step start."""
    model = bubble.bubble_model((64, 32, 32), device=cuda_device,
                                extent=(3_200.0, 1_600.0, 800.0), **kw)
    state = bubble.bubble_state(model)
    counts = (momentum.launches, advection.launches, acoustic.launches, columnar.launches)
    state = bt.acoustic_rk3_step(model, state, 0.5)
    torch.cuda.synchronize()
    moist = bool(kw.get("moist"))
    assert (momentum.launches - counts[0], advection.launches - counts[1],
            acoustic.launches - counts[2], columnar.launches - counts[3]) == (
        3, 6 if moist else 3, 20, 1 if moist else 0)
    for name in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta") + (("rho_qt",) if moist else ()):
        assert getattr(state, name).dtype == torch.float32, name
        assert bool(torch.isfinite(getattr(state, name)).all()), name


def _terrain_model(size, kind, sponge, stretched, device):
    """A ridge that varies in y, over an (nx, ny, nz) grid with Δx = 50 m
    and z uniform (25 m) or stretched: ``kind`` is ``linear``
    (LinearDecay), ``sleve`` or ``flat`` (no terrain); ``sponge`` None or
    the ``damp_full`` flag of an upper sponge over the top 40%.  The state
    is the bubble with noise on the momenta and ρθ, ρw on the surface face
    from the kinematic bottom."""
    nx, ny, nz = size
    z = (np.concatenate([[0.0], np.cumsum(20.0 * 1.05 ** np.arange(nz))])
         if stretched else (0.0, 25.0 * nz))
    g = bt.make_grid(size, x=(0.0, 50.0 * nx), y=(0.0, 50.0 * ny), z=z,
                     dtype=torch.float32, device=device)
    terrain = None
    if kind != "flat":
        kw = (dict(large_scale_height=0.5 * g.Lz, small_scale_height=0.25 * g.Lz)
              if kind == "sleve" else {})
        terrain = TT.make_terrain(g, bt.ThermodynamicConstants(),
                                  ridge.ridge_elevation(g.x0, g.Lx, g.Lz, g.y0, g.Ly, 0.3),
                                  **kw)
    model = TC.make_compressible_model(
        g, advection=bt.WENO(5), coriolis=bt.FPlane(1e-4), terrain=terrain,
        time_discretization=TC.SplitExplicitTimeDiscretization(
            sponge=None if sponge is None else TC.UpperSponge(depth=0.4 * g.Lz,
                                                              damp_full=sponge)))
    state = bubble.bubble_state(model)
    rng = np.random.default_rng(9)
    noise = lambda sd: torch.as_tensor(rng.normal(0.0, sd, g.shape), dtype=g.dtype,
                                       device=device)
    rho_u, rho_v = state.rho_u + noise(0.5), state.rho_v + noise(0.5)
    rho_w = state.rho_w + noise(0.2)
    rho_w[0] = 0.0 if terrain is None else TT.kinematic_bottom_rho_w(terrain, rho_u, rho_v)
    return model, state.replace(rho_u=rho_u, rho_v=rho_v, rho_w=rho_w,
                                rho_theta=state.rho_theta + noise(0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("size,kind,sponge,stretched,n_tau,gate", [
    ((64, 32, 32), "linear", None, False, 7, True),
    ((36, 20, 13), "sleve", None, True, 4, True),
    ((64, 32, 32), "linear", True, True, 7, True),
    ((36, 20, 13), "linear", False, False, 3, False),
    ((36, 20, 13), "flat", True, True, 4, True)],
    ids=["blocks_linear", "ragged_stretched_sleve", "blocks_stretched_linear_sponge_full",
         "ragged_linear_sponge_perturbation_ungated", "ragged_stretched_flat_sponge_full"])
def test_cuda_terrain_acoustic_matches_plain(cuda_device, size, kind, sponge, stretched,
                                             n_tau, gate):
    """The σ-terrain and sponge branches of the acoustic kernel against the
    plain loop, on a ridge that varies in y (so that every y-slope term
    acts), with noise on the perturbations and the sums."""
    model, state = _terrain_model(size, kind, sponge, stretched, cuda_device)
    aux = TC.compressible_diagnose(model, state)
    caches = TC.stage_caches(model, state, aux)
    G = TC.stage_slow_tendencies(model, state, aux)
    rng = np.random.default_rng(10)
    pert = [torch.as_tensor(rng.normal(0.0, 1e-3, model.grid.shape), dtype=torch.float32,
                            device=cuda_device) for _ in range(8)]
    pert = acoustic.Perturbations(*pert)
    kept = [p.clone() for p in pert]
    args = (model.acoustic_config, model.z_columns, caches, G, pert, 0.5 / 7, n_tau, gate)
    kw = dict(metrics=model.acoustic_metrics, rho_w_L=TC.sponge_rho_w_L(model, state))
    assert (kw["rho_w_L"] is not None) == bool(sponge)
    before = acoustic.launches
    got = acoustic.acoustic_substeps(*args, **kw)
    torch.cuda.synchronize()
    # one launch a substep, the pivots and the closing pass
    assert acoustic.launches == before + n_tau + 2
    for name, p, k in zip(acoustic.Perturbations._fields, pert, kept):
        assert torch.equal(p, k), f"the kernel wrote its input {name}"
    for name, g, r in zip(acoustic.Perturbations._fields, got,
                          acoustic.acoustic_substeps_plain(*args, **kw)):
        # float32, the kernel's sweep on d·(1/den) and lo·(1/den) against
        # the plain (d − lo·d′)·(1/den), and its FMA contraction: 5e-5 of the
        # largest value, as the TPU kernel's test
        assert _rel_to_max(g, r) < 5e-5, name


#: The substep kernel's edges: a block holds 32 columns of one row over all
#: levels in 16 groups (12 over terrain), so nx not a multiple of 32 (40)
#: and below it (20), nz not a multiple of the groups (11, 19) and below
#: them (5), ny of 3–4 rows (y−1 and y+1 wrap onto few rows; the slow
#: tendencies' halo needs 3), one substep (the closing pass alone applies
#: E), the PGF gate on and off; on every branch: (branch, (nx, ny, nz),
#: stretched, n_tau, gate).
EDGE_CASES = [
    ("thermal", (40, 3, 11), False, 1, True),
    ("thermal", (20, 4, 5), True, 2, False),
    ("none", (40, 3, 19), True, 1, False),
    ("theta_direct", (40, 3, 11), True, 1, False),
    ("crho_thermal", (40, 4, 11), False, 3, True),
    ("crho_direct", (20, 3, 19), True, 1, True),
    ("bf16", (40, 3, 11), False, 1, True),
    ("bf16_crho_direct", (20, 4, 11), True, 2, False),
    ("linear", (40, 3, 11), False, 1, True),
    ("sleve", (20, 4, 19), True, 2, False),
    ("linear_sponge", (40, 3, 11), True, 1, False),
    ("flat_sponge", (20, 3, 19), False, 2, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("branch,size,stretched,n_tau,gate", EDGE_CASES,
                         ids=[f"{c[0]}_{'x'.join(map(str, c[1]))}_n{c[3]}"
                              + ("_gated" if c[4] else "") for c in EDGE_CASES])
def test_cuda_acoustic_tile_edges_match_plain(cuda_device, branch, size, stretched, n_tau,
                                              gate):
    """Every branch of the acoustic kernel against the plain loop at the
    substep kernel's tile edges, with noise on the perturbations and the
    sums; the caller's tensors are left as they were."""
    if branch in ("thermal", "none"):
        model, state = _compressible(size, stretched, cuda_device,
                                     0.1 if branch == "thermal" else 0.0)
    elif branch in ("linear", "sleve", "linear_sponge", "flat_sponge"):
        model, state = _terrain_model(size, branch.split("_")[0], True if "sponge" in branch
                                      else None, stretched, cuda_device)
    else:
        model, state = _branch_model(size, stretched, cuda_device,
                                     "static_energy" if "crho" in branch
                                     else "potential_temperature",
                                     "direct" in branch, branch.startswith("bf16"))
    aux = TC.compressible_diagnose(model, state)
    caches = TC.stage_caches(model, state, aux)
    G = TC.stage_slow_tendencies(model, state, aux)
    rng = np.random.default_rng(13)
    pert = [torch.as_tensor(rng.normal(0.0, 1e-3, model.grid.shape), dtype=torch.float32,
                            device=cuda_device) for _ in range(8)]
    if model.terrain is None:
        pert[3][0] = 0.0
    bf16 = branch.startswith("bf16")
    if bf16:
        pert[:5] = [p.to(torch.bfloat16) for p in pert[:5]]
    pert = acoustic.Perturbations(*pert)
    kept = [p.clone() for p in pert]
    args = (model.acoustic_config, model.z_columns, caches, G, pert, 0.5 / 7, n_tau, gate)
    kw = dict(metrics=model.acoustic_metrics, rho_w_L=TC.sponge_rho_w_L(model, state))
    before = acoustic.launches
    got = acoustic.acoustic_substeps(*args, **kw)
    torch.cuda.synchronize()
    assert acoustic.launches == before + n_tau + 2
    for name, p, k in zip(acoustic.Perturbations._fields, pert, kept):
        assert torch.equal(p, k), f"the kernel wrote its input {name}"
    for name, g, r in zip(acoustic.Perturbations._fields, got,
                          acoustic.acoustic_substeps_plain(*args, **kw)):
        assert g.dtype == r.dtype, name
        # the limits of the tests above: 5e-5 in float32, 3e-2 for bfloat16
        assert _rel_to_max(g, r) < (3e-2 if bf16 else 5e-5), name
        if bf16:
            assert _mismatch_share(g, r) < BF16_MISMATCH_SHARE, name


@pytest.mark.cuda
def test_cuda_ridge_step_goes_through_the_kernels(cuda_device):
    model = ridge.ridge_model((64, 32, 32), device=cuda_device,
                              extent=(3_200.0, 1_600.0, 800.0))
    state = ridge.ridge_state(model)
    counts = (momentum.launches, advection.launches, acoustic.launches)
    state = bt.acoustic_rk3_step(model, state, 0.5)
    torch.cuda.synchronize()
    assert (momentum.launches - counts[0], advection.launches - counts[1],
            acoustic.launches - counts[2]) == (3, 3, 20)
    for name in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name
    # ρw on the surface face is the kinematic bottom's, not the flat wall's
    kb = TT.kinematic_bottom_rho_w(model.terrain, state.rho_u, state.rho_v)
    assert torch.equal(state.rho_w[0], kb) and float(kb.abs().max()) > 0.0


@pytest.mark.cuda
def test_cuda_bubble_step_goes_through_the_kernels(cuda_device):
    model = bubble.bubble_model((64, 32, 32), device=cuda_device,
                                extent=(3_200.0, 1_600.0, 800.0))
    state = bubble.bubble_state(model)
    counts = (momentum.launches, advection.launches, acoustic.launches)
    state = bt.acoustic_rk3_step(model, state, 0.5)
    torch.cuda.synchronize()
    # three stages; 3 + 4 + 7 substeps of one launch each and two a stage
    assert (momentum.launches - counts[0], advection.launches - counts[1],
            acoustic.launches - counts[2]) == (3, 3, 20)
    for name in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta"):
        assert bool(torch.isfinite(getattr(state, name)).all()), name


# ---------------------------------------------------------------------------
# The per-substep acoustic pair K1/K2
# ---------------------------------------------------------------------------

def _split_stage(size, stretched, device, damping, bf16, seed=14):
    """The noisy bubble's stage on an (nx, ny, nz) grid: the model, its
    caches and slow tendencies, and noise 1e-3·N(0, 1) on the five carries
    (in bfloat16 or float32) and on the three sums."""
    model, state = _compressible(size, stretched, device, damping)
    aux = TC.compressible_diagnose(model, state)
    caches, G = TC.stage_caches(model, state, aux), TC.slow_tendencies(model, state, aux)
    rng = np.random.default_rng(seed)
    pert = [torch.as_tensor(rng.normal(0.0, 1e-3, model.grid.shape), dtype=torch.float32,
                            device=device) for _ in range(8)]
    pert[3][0] = 0.0
    if bf16:
        pert[:5] = [p.to(torch.bfloat16) for p in pert[:5]]
    return model, caches, G, acoustic.Perturbations(*pert)


SPLIT_CASES = [((64, 32, 32), False, 0.1, False), ((36, 20, 13), True, 0.1, False),
               ((36, 20, 13), False, 0.0, False), ((64, 32, 32), False, 0.1, True),
               ((36, 20, 13), True, 0.1, True)]
SPLIT_IDS = ["blocks_thermal", "ragged_stretched_thermal", "ragged_none",
             "blocks_thermal_bf16", "ragged_stretched_thermal_bf16"]


@pytest.mark.cuda
@pytest.mark.parametrize("size,stretched,damping,bf16", SPLIT_CASES, ids=SPLIT_IDS)
@pytest.mark.parametrize("pgf", [1.0, 0.0], ids=["pgf", "gated"])
def test_cuda_acoustic_k1_matches_plain(cuda_device, size, stretched, damping, bf16, pgf):
    model, caches, G, pert = _split_stage(size, stretched, cuda_device, damping, bf16)
    carries = tuple(pert[:5])
    kept = [p.clone() for p in carries]
    args = (model.acoustic_config, model.z_columns, caches, G, carries, 0.5 / 7, pgf)
    before = acoustic_split.k1_launches
    got = acoustic_split.acoustic_k1(*args)
    torch.cuda.synchronize()
    assert acoustic_split.k1_launches == before + 1
    for name, p, k in zip(acoustic.Perturbations._fields, carries, kept):
        assert torch.equal(p, k), f"K1 wrote its input {name}"
    for name, g, r in zip(("rho_u", "rho_v", "rho_star", "rho_theta_star"), got,
                          acoustic_split.acoustic_k1_plain(*args)):
        assert g.dtype == torch.float32, name
        # float32 FMA contraction in a pointwise stencil: 1e-5 of the
        # largest value
        assert _rel_to_max(g, r) < 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("size,stretched,damping,bf16", SPLIT_CASES, ids=SPLIT_IDS)
def test_cuda_acoustic_k2_matches_plain(cuda_device, size, stretched, damping, bf16):
    """K2 on the plain K1's outputs, so that both versions see the same
    inputs."""
    model, caches, G, pert = _split_stage(size, stretched, cuda_device, damping, bf16)
    cfg, cols, dtau = model.acoustic_config, model.z_columns, 0.5 / 7
    carries = tuple(pert[:5])
    k1 = acoustic_split.acoustic_k1_plain(cfg, cols, caches, G, carries, dtau, 1.0)
    kept = [p.clone() for p in (*carries, *k1)]
    args = (cfg, cols, caches, G.rho_w, carries, k1, dtau)
    before = acoustic_split.k2_launches
    got = acoustic_split.acoustic_k2(*args)
    torch.cuda.synchronize()
    assert acoustic_split.k2_launches == before + 2     # the column solve, then E
    for p, k in zip((*carries, *k1), kept):
        assert torch.equal(p, k), "K2 wrote an input"
    for name, g, r in zip(("rho", "rho_u", "rho_v", "rho_w", "rho_theta"), got,
                          acoustic_split.acoustic_k2_plain(*args)):
        assert g.dtype == r.dtype == pert.rho.dtype, name
        # the sweep's two divides and FMA contraction: 5e-5 of the largest
        # value, the TPU kernel's test's limit; bfloat16 outputs may round the
        # other way where the two float32 results straddle a boundary: 3e-2
        assert _rel_to_max(g, r) < (3e-2 if bf16 else 5e-5), name


@pytest.mark.cuda
@pytest.mark.parametrize("size,stretched,damping,bf16", SPLIT_CASES, ids=SPLIT_IDS)
def test_cuda_acoustic_split_stage_matches_plain(cuda_device, size, stretched, damping,
                                                 bf16):
    """A 7-substep stage through the pair against the plain pair, the
    sums included; the caller's tensors are left as they were."""
    model, caches, G, pert = _split_stage(size, stretched, cuda_device, damping, bf16)
    kept = [p.clone() for p in pert]
    args = (model.acoustic_config, model.z_columns, caches, G, pert, 0.5 / 7, 7, True)
    before = (acoustic_split.k1_launches, acoustic_split.k2_launches, acoustic.launches)
    got = acoustic_split.acoustic_substeps_split(*args)
    torch.cuda.synchronize()
    assert (acoustic_split.k1_launches, acoustic_split.k2_launches, acoustic.launches) == (
        before[0] + 7, before[1] + 14, before[2])
    for name, p, k in zip(acoustic.Perturbations._fields, pert, kept):
        assert torch.equal(p, k), f"the stage wrote its input {name}"
    for name, g, r in zip(acoustic.Perturbations._fields, got,
                          acoustic_split.acoustic_substeps_split_plain(*args)):
        assert g.dtype == r.dtype, name
        assert _rel_to_max(g, r) < (3e-2 if bf16 else 5e-5), name


#: K2's edges: a block of its column kernel holds 32 columns of one row over
#: all levels in 16 groups with runs of at least 4 levels, so nx below 32
#: (20) and not a multiple of it (40), ny of 3–4 rows (E's D at y−1 wraps
#: onto few rows), nz small and odd (5: two runs, the last of one level;
#: 7, 9, 11: the last run short), thermal damping on and off, float32 and
#: bfloat16, a stage of one substep (its sums from the caller's, which stay
#: as they were) and one of three (the later sums in place):
#: ((nx, ny, nz), damping, bf16, n_tau).
K2_EDGE_CASES = [((20, 3, 5), 0.1, False, 1), ((40, 4, 11), 0.1, False, 1),
                 ((40, 3, 7), 0.0, False, 1), ((20, 4, 9), 0.1, True, 1),
                 ((40, 3, 11), 0.0, True, 1), ((20, 3, 11), 0.1, False, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("size,damping,bf16,n_tau", K2_EDGE_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}_{'thermal' if c[1] else 'none'}"
                              + ("_bf16" if c[2] else "") + f"_n{c[3]}" for c in K2_EDGE_CASES])
def test_cuda_acoustic_k2_tile_edges_match_plain(cuda_device, size, damping, bf16, n_tau):
    """K2 at its column kernel's edges on stretched z: one K2 on the plain
    K1's outputs against the plain K2 (E's D at x = 0 and y = 0 wraps to
    the last column and row, checked on its own), and a stage through the
    pair against the plain pair, the sums included; the caller's tensors
    are left as they were."""
    model, caches, G, pert = _split_stage(size, True, cuda_device, damping, bf16)
    cfg, cols, dtau = model.acoustic_config, model.z_columns, 0.5 / 7
    carries = tuple(pert[:5])
    k1 = acoustic_split.acoustic_k1_plain(cfg, cols, caches, G, carries, dtau, 1.0)
    kept = [p.clone() for p in (*pert, *k1)]
    args = (cfg, cols, caches, G.rho_w, carries, k1, dtau)
    stage_args = (cfg, cols, caches, G, pert, dtau, n_tau, True)
    before = (acoustic_split.k1_launches, acoustic_split.k2_launches)
    got = acoustic_split.acoustic_k2(*args)
    stage = acoustic_split.acoustic_substeps_split(*stage_args)
    torch.cuda.synchronize()
    assert (acoustic_split.k1_launches, acoustic_split.k2_launches) == (
        before[0] + n_tau, before[1] + 2 + 2 * n_tau)
    for p, k in zip((*pert, *k1), kept):
        assert torch.equal(p, k), "K2 or the stage wrote an input"
    # the limits of the tests above: 5e-5 in float32, 3e-2 for bfloat16
    limit = 3e-2 if bf16 else 5e-5
    ref = acoustic_split.acoustic_k2_plain(*args)
    for name, g, r in zip(("rho", "rho_u", "rho_v", "rho_w", "rho_theta"), got, ref):
        assert g.dtype == r.dtype == pert.rho.dtype, name
        assert _rel_to_max(g, r) < limit, name
        if bf16:
            assert _mismatch_share(g, r) < BF16_MISMATCH_SHARE, name
    # ρu′ at x = 0 and ρv′ at y = 0 take D from the last column and row
    assert _rel_to_max(got[1][:, :, 0], ref[1][:, :, 0]) < limit, "rho_u at x = 0"
    assert _rel_to_max(got[2][:, 0], ref[2][:, 0]) < limit, "rho_v at y = 0"
    for name, g, r in zip(acoustic.Perturbations._fields, stage,
                          acoustic_split.acoustic_substeps_split_plain(*stage_args)):
        assert g.dtype == r.dtype, name
        assert _rel_to_max(g, r) < limit, name
        if bf16 and not name.startswith("sum"):
            assert _mismatch_share(g, r) < BF16_MISMATCH_SHARE, name


@pytest.mark.cuda
@pytest.mark.parametrize("floattype", [None, "bfloat16"], ids=["float32", "bf16"])
def test_cuda_split_bubble_step_goes_through_the_pair(cuda_device, floattype):
    model = bubble.bubble_model((64, 32, 32), device=cuda_device,
                                extent=(3_200.0, 1_600.0, 800.0), substep_floattype=floattype,
                                per_substep_kernels=True)
    state = bubble.bubble_state(model)
    counts = (momentum.launches, advection.launches, acoustic.launches,
              acoustic_split.k1_launches, acoustic_split.k2_launches)
    state = bt.acoustic_rk3_step(model, state, 0.5)
    torch.cuda.synchronize()
    # three stages; 3 + 4 + 7 substeps of one K1 and two K2 launches each, no K3
    assert (momentum.launches - counts[0], advection.launches - counts[1],
            acoustic.launches - counts[2], acoustic_split.k1_launches - counts[3],
            acoustic_split.k2_launches - counts[4]) == (3, 3, 0, 14, 28)
    for name in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta"):
        assert getattr(state, name).dtype == torch.float32, name
        assert bool(torch.isfinite(getattr(state, name)).all()), name


# ---------------------------------------------------------------------------
# The anelastic routes outside the fused tendency kernel
# ---------------------------------------------------------------------------

def _anelastic(size, stretched, device, moist, closure=True, coriolis=False):
    """An anelastic model with Smagorinsky-Lilly (or no closure; moist:
    with saturation adjustment; with an FPlane if ``coriolis``) on an
    (nx, ny, nz) grid with Δx = 50 m and z uniform (25 m) or stretched,
    and its perturbed BOMEX-like state's diagnostics and windows: noise on
    every velocity (w off the bottom face), θ with a stable gradient and
    noise, qᵗ decaying with height."""
    nx, ny, nz = size
    z = (np.concatenate([[0.0], np.cumsum(20.0 * 1.05 ** np.arange(nz))])
         if stretched else (0.0, 25.0 * nz))
    g = bt.make_grid(size, x=(0.0, 50.0 * nx), y=(0.0, 50.0 * ny), z=z,
                     dtype=torch.float32, device=device)
    model = bt.make_model(g, advection=bt.WENO(5), potential_temperature=300.0,
                          closure=bt.SmagorinskyLilly() if closure else None,
                          coriolis=bt.FPlane(1e-4) if coriolis else None,
                          microphysics=bt.SaturationAdjustment() if moist else None)
    rng = np.random.default_rng(13)
    noise = lambda sd: torch.as_tensor(rng.normal(0.0, sd, g.shape), dtype=g.dtype,
                                       device=device)
    w = noise(0.5)
    w[0] = 0.0
    state = bt.initial_state(
        model, u=lambda x, y, z: 2.0 + 0.0 * z + noise(1.0),
        v=lambda x, y, z: 0.0 * z + noise(1.0),
        theta=lambda x, y, z: 300.0 + 3e-3 * z + noise(0.2),
        qt=(lambda x, y, z: 0.015 * torch.exp(-z / 1500.0) + 0.0 * x) if moist else None)
    state = state.replace(rho_w=w * model.reference.rho_f_col)
    aux = TM.diagnose(model, state)
    args = TM.tendency_kernel_args(model, state, aux, 1.0, state, 1.0)
    return model, state, args


@pytest.mark.cuda
@pytest.mark.parametrize("size,stretched", [((64, 32, 32), False), ((36, 20, 13), True)],
                         ids=["blocks", "ragged_stretched"])
def test_cuda_momentum_div_cols_matches_plain(cuda_device, size, stretched):
    model, _, args = _anelastic(size, stretched, cuda_device, moist=False)
    cfg, cols, u, v, w = args[:5]
    margs = (u, v, w, cols.colc, cols.colf, cols.invdzc, cols.invdzf, cfg.inv_dx, cfg.inv_dy)
    before = momentum.cols_launches
    got = momentum.momentum_div_cols(*margs)
    torch.cuda.synchronize()
    assert momentum.cols_launches == before + 1
    for name, g, r in zip("uvw", got, momentum.momentum_div_cols_plain(*margs)):
        if name == "w":
            g, r = g[1:], r[1:]     # row 0 reads below-wall data; the wall overwrites it
        # float32 reassociation and FMA contraction: 1e-5 of the largest value
        assert _rel_to_max(g, r) < 1e-5, name


#: The column-momentum kernel's edges: a block holds a 32 × 16 tile of
#: columns and marches up a chunk of ``COLS_Z_CHUNK`` (64) levels, so nx
#: below 32 (20) and not a multiple of it (40, 36), ny not a multiple of 16
#: (5; 17: a second tile of one row; 20), nz below the chunk (13) and above
#: it but not a multiple (70, 67); z stretched.
COLS_EDGE_SIZES = [(20, 5, 13), (40, 17, 70), (36, 20, 67)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", COLS_EDGE_SIZES, ids=["x".join(map(str, s))
                                                       for s in COLS_EDGE_SIZES])
def test_cuda_momentum_div_cols_tile_edges_match_plain(cuda_device, size):
    """The column-momentum kernel against its plain version at its tile's
    and chunk's edges; the inputs are left as they were."""
    model, _, args = _anelastic(size, True, cuda_device, moist=False)
    cfg, cols, u, v, w = args[:5]
    margs = (u, v, w, cols.colc, cols.colf, cols.invdzc, cols.invdzf, cfg.inv_dx, cfg.inv_dy)
    kept = [t.clone() for t in margs[:7]]
    before = momentum.cols_launches
    got = momentum.momentum_div_cols(*margs)
    torch.cuda.synchronize()
    assert momentum.cols_launches == before + 1
    for t, k in zip(margs[:7], kept):
        assert torch.equal(t, k), "the kernel wrote an input"
    for name, g, r in zip("uvw", got, momentum.momentum_div_cols_plain(*margs)):
        if name == "w":
            g, r = g[1:], r[1:]     # row 0 reads below-wall data; the wall overwrites it
        # float32 reassociation and FMA contraction: 1e-5 of the largest value
        assert _rel_to_max(g, r) < 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("size,stretched,dt", [((64, 32, 32), False, 1.0),
                                               ((36, 20, 13), True, 2.0 / 3.0)],
                         ids=["blocks", "ragged_stretched_dt"])
def test_cuda_projection_matches_plain(cuda_device, size, stretched, dt):
    """The divergence and the gradient correction on noisy momenta and φ,
    at a Δt of 1 and one of another stage's.  ρw is noisy on the bottom
    face too: the correction must pin it whatever it is given."""
    model, state, _ = _anelastic(size, stretched, cuda_device, moist=False)
    cfg, cols, ref = model.tendency_config, model.tendency_columns, model.reference
    rng = np.random.default_rng(14)
    noise = lambda: torch.as_tensor(rng.normal(0.0, 1.0, model.grid.shape),
                                    dtype=torch.float32, device=cuda_device)
    ru, rv, rw, phi = state.rho_u + noise(), state.rho_v + noise(), noise(), noise()
    dargs = (ru, rv, rw, cols.invdzc, cfg.inv_dx, cfg.inv_dy)
    nz = model.grid.nz
    gargs = (phi, ru, rv, rw, ref.rho_c, ref.rho_f[:nz], cols.invdzf, cfg.inv_dx,
             cfg.inv_dy, dt)
    before = (projection.div_launches, projection.grad_launches)
    got_div = projection.divergence(*dargs)
    got_grad = projection.gradient_correct(*gargs)
    torch.cuda.synchronize()
    assert (projection.div_launches, projection.grad_launches) == (before[0] + 1, before[1] + 1)
    # TestFusedProjection's limits: rtol 2e-5, atol 2e-5 (float32 reordering)
    torch.testing.assert_close(got_div, projection.divergence_plain(*dargs), rtol=2e-5, atol=2e-5)
    for name, g, r in zip(("rho_u", "rho_v", "rho_w"), got_grad,
                          projection.gradient_correct_plain(*gargs)):
        torch.testing.assert_close(g, r, rtol=2e-5, atol=2e-5, msg=name)
    assert not got_grad[2][0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("size,stretched,moist", [((64, 32, 32), False, False),
                                                  ((64, 32, 32), True, True),
                                                  ((36, 20, 13), True, True)],
                         ids=["blocks_dry", "blocks_stretched_moist", "ragged_stretched_moist"])
def test_cuda_closure_matches_plain(cuda_device, size, stretched, moist):
    """The closure kernel on the windows of the fused stage (moist: with the
    θᵥ window of Lilly's correction), each output against its own largest
    value."""
    model, _, args = _anelastic(size, stretched, cuda_device, moist)
    cfg, cols, u, v, w, scalars, _, thb = args[:8]
    assert (thb is scalars[0]) != moist
    cargs = (cfg, cols, u, v, w, thb, scalars)
    before = closure.launches
    got = closure.closure_tendencies(*cargs)
    torch.cuda.synchronize()
    assert closure.launches == before + 1
    assert len(got) == 3 + len(scalars)
    # row 0 of G_w, which the wall condition overwrites, is held too: both
    # sides read the same pads there, and it is the only row where the ν
    # wall mirror shows (the strains at the wall faces vanish elsewhere)
    for name, g, r in zip(("G_u", "G_v", "G_w", "G_theta", "G_qt"), got,
                          closure.closure_tendencies_plain(*cargs)):
        # float32 reassociation and FMA contraction: 1e-5 of the largest
        # value, tighter than TestClosureKernel's 2e-4
        assert _rel_to_max(g, r) < 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["bomex", "bomex_beta"])
def test_cuda_anelastic_route_step_goes_through_its_kernels(cuda_device, path):
    coriolis = bomex.BETA_PLANE if path == "bomex_beta" else None
    model = bomex.bomex_model((32, 32, 32), device=cuda_device, coriolis=coriolis)
    state = bomex.bomex_state(model, _noise(model.grid.shape))
    counters = lambda: (tendency.launches, momentum.cols_launches, advection.launches,
                        closure.launches, projection.div_launches,
                        projection.grad_launches, columnar.launches)
    before = counters()
    state = ssp_rk3_step(model, state, 1.0)
    torch.cuda.synchronize()
    ran = tuple(a - b for a, b in zip(counters(), before))
    assert ran == ((0, 3, 6, 3, 3, 3, 1) if path == "bomex_beta" else (3, 0, 0, 0, 3, 3, 1))
    for name in NAMES:
        assert bool(torch.isfinite(getattr(state, name)).all()), name
