"""breeze_tpu_torch: the anelastic moist LES of ``breeze_tpu`` in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100 (``sm_90a``).

The JAX package ``breeze_tpu`` is the reference this port is tested
against; the port imports no JAX.  Plain tensor code runs wherever its
tensors live; the two kernels (``kernels/tendency.py``,
``kernels/columnar.py``) take their plain PyTorch version for CPU tensors and
launch CUDA for CUDA tensors, built from ``csrc/`` at first use.
"""

from .advection import WENO
from .grid import BOUNDED, PERIODIC, Grid, Topology, make_grid
from .model import (AtmosphereModel, State, compute_tendencies, diagnose,
                    initial_state, make_model, pressure_projection, stage_update)
from .physics.closures import SmagorinskyLilly
from .physics.coriolis import FPlane
from .physics.microphysics import SaturationAdjustment
from .thermo.constants import ThermodynamicConstants
from .thermo.saturation import WarmPhaseEquilibrium
from .timesteppers import ssp_rk3_step

__all__ = [
    "AtmosphereModel", "BOUNDED", "FPlane", "Grid", "PERIODIC",
    "SaturationAdjustment", "SmagorinskyLilly", "State",
    "ThermodynamicConstants", "Topology", "WENO", "WarmPhaseEquilibrium",
    "compute_tendencies", "diagnose", "initial_state", "make_grid",
    "make_model", "pressure_projection", "ssp_rk3_step", "stage_update",
]
