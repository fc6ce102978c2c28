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

from breeze_tpu_torch import bomex, ssp_rk3_step
from breeze_tpu_torch import model as TM
from breeze_tpu_torch.kernels import columnar, tendency

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


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 32, 32), (36, 20, 12)],
                         ids=["blocks", "ragged"])
@pytest.mark.parametrize("what", ["G", "increment"])
def test_cuda_fused_tendency_matches_plain(cuda_device, size, what):
    """``G``: zero current and stage-0 fields with α = Δt = 1 make the
    output the tendency alone; ``increment``: out − ((1−α)s⁰ + α·s) = αΔt·G
    at α = 2/3, Δt = 3, where αΔt·G stands well above the float32 rounding
    of the state it is added to.  Each against its own largest value."""
    model = bomex.bomex_model(size, dtype=torch.float32, device=cuda_device)
    state, state0 = _perturbed(model, bomex.bomex_state(model, _noise(model.grid.shape)))
    args = TM.tendency_kernel_args(model, state, TM.diagnose(model, state),
                                   3.0, state0, 2.0 / 3.0)
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
