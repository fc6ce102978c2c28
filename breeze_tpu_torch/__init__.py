"""breeze_tpu_torch: ``breeze_tpu`` in PyTorch, with hand-written CUDA
kernels for the NVIDIA H100 (``sm_90a``).

Three paths are ported: the anelastic moist LES (BOMEX, ``ssp_rk3_step``;
through the fused tendency kernel, or on a β-plane outside it),
the split-explicit compressible core (the bubble, ``acoustic_rk3_step``:
dry or moist, in ρθ or ρe, with float32 or bfloat16 acoustic carries), and
the dry core over terrain in σ-coordinates (the bubble over a ridge,
``ridge.py``).  The JAX package ``breeze_tpu`` is the reference
this port is tested against; the port imports no JAX.  Plain tensor code
runs wherever its tensors live; each kernel (``kernels/``) takes its plain
PyTorch version for CPU tensors and launches CUDA for CUDA tensors, built
from ``csrc/`` at first use.
"""

from .advection import WENO
from .dynamics.compressible import (CompressibleModel, CompressibleState,
                                    DirectDivergenceDamping, SplitExplicitTimeDiscretization,
                                    acoustic_rk3_step, compressible_initial_state,
                                    make_compressible_model)
from .grid import BOUNDED, PERIODIC, Grid, Topology, make_grid
from .model import (AtmosphereModel, State, compute_tendencies, diagnose,
                    initial_state, make_model, pressure_projection, stage_update)
from .physics.closures import SmagorinskyLilly
from .physics.coriolis import BetaPlane, FPlane
from .physics.microphysics import SaturationAdjustment
from .thermo.constants import ThermodynamicConstants
from .thermo.saturation import WarmPhaseEquilibrium
from .timesteppers import ssp_rk3_step

__all__ = [
    "AtmosphereModel", "BOUNDED", "BetaPlane", "CompressibleModel", "CompressibleState",
    "DirectDivergenceDamping", "FPlane", "Grid", "PERIODIC", "SaturationAdjustment",
    "SmagorinskyLilly",
    "SplitExplicitTimeDiscretization", "State", "ThermodynamicConstants",
    "Topology", "WENO", "WarmPhaseEquilibrium",
    "acoustic_rk3_step", "compressible_initial_state", "compute_tendencies",
    "diagnose", "initial_state", "make_compressible_model", "make_grid",
    "make_model", "pressure_projection", "ssp_rk3_step", "stage_update",
]
