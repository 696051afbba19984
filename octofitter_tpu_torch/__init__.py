"""octofitter_tpu_torch: the PyTorch + CUDA port of octofitter_tpu.

The same model-building API as the JAX package (`Planet`, `System`,
`UniformCircular`, `PlanetRelAstromObs`, `HGCAInstantaneousObs`, the RV
likelihoods without Gaussian processes, the continuous priors,
`LogDensityModel`, the parameterizations with `ofti_linear_solve`, the
`UserLikelihood` and `DirectLL` user terms, `octofit` with ChEES, NUTS
and HMC, the parallel-tempering `octofit_pigeons`, `octofit_rejection`,
`Chains` and the diagnostics, `ess_rhat_batch_device` on the card among
them), written in PyTorch.
`LogDensityModel(system, device=..., dtype=...)` fixes the device and
dtype of every tensor the model makes. The device is the GPU unless the
caller says `device="cpu"`. On a CUDA device the orbit solve runs as
hand-written CUDA kernels (`orbits/kernels/csrc/orbit_solve.cu`, forward
and backward, and the standalone Kepler solve `kepler.cu`), built with
nvcc at first use. This package never imports JAX.
"""

from . import constants
from . import distributions
from .distributions import Sine, UniformImproper, KDEDist
from . import bijectors
from . import orbits
from .constants import mjd, mjd2jd, jd2mjd, years2mjd, mjd2years
from .orbits import (
    KepOrbit,
    VisualOrbit,
    ThieleInnesOrbit,
    RadialVelocityOrbit,
    orbitsolve,
    kepler_solver,
)
from .model import (
    Params,
    Derived,
    DirectLL,
    Planet,
    System,
    UniformCircular,
    UserLikelihood,
    LogDensityModel,
    theta_at_epoch_to_tperi,
    ofti_linear_solve,
    likelihoodname,
)
from .likelihoods import (
    PlanetRelAstromObs,
    PlanetRelAstromLikelihood,
    HGCAInstantaneousObs,
    HGCAInstantaneousLikelihood,
    gaia_plx,
)
from . import rv
from .rv import (
    StarAbsoluteRVObs,
    StarAbsoluteRVLikelihood,
    MarginalizedStarAbsoluteRVObs,
    MarginalizedStarAbsoluteRVLikelihood,
    StarAbsoluteRVMarginLikelihood,
    PlanetRelativeRVObs,
    PlanetRelativeRVLikelihood,
)
from . import io
from .config import OctofitterConfig, get_config, set_config
from .samplers import octofit, octofit_pigeons, octofit_rejection
from .chains import (
    Chains,
    ess_rhat,
    ess_rhat_batch,
    ess_rhat_batch_device,
    ess_tail,
    ess_tail_batch,
)
from . import interop

__version__ = "0.1.0"
