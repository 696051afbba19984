"""octofitter_tpu_torch: the PyTorch + CUDA port of octofitter_tpu.

The same model-building API as the JAX package (`Planet`, `System`,
`UniformCircular`, the orbit bases (Visual, Thiele-Innes, RV,
`AbsoluteVisual{KepOrbit}`, Cartesian, FixedPosition, hyperbolic),
`PlanetRelAstromObs`, `HGCAInstantaneousObs`, the absolute-astrometry
likelihoods (`HipparcosIADObs`, the HGCA linear-fit `HGCAObs`,
`GaiaDR4AstromObs` and the G23H composite `G23HObs`; `astrom/`), the
observable and stability priors (`ObsPriorAstromONeil2019`,
`LimitClosestApproachAUPrior`, `NonCrossingPrior`, `HillStabilityPrior`,
`PlanetOrderPrior`), `PhotometryObs` with the Sonora and BHAC15
interpolators (`atmosphere`), direct images and likelihood maps
(`ImageObs`, `LogLikelihoodMapObs`; `images/`), interferometry
(`InterferometryObs` with its OIFITS loader, `GRAVITYWideKPObs`;
`interferometry/`), transit light curves (`LightCurveObs`; `transits/`),
the RV
likelihoods with Gaussian-process noise (dense kernels and celerite
terms) and the RV archive loaders, the continuous priors,
`LogDensityModel`, the parameterizations with `ofti_linear_solve`, the
`UserLikelihood`, `DirectLL` and `BlankLikelihood` user terms, discrete
priors (`DiscreteUniform`, `Categorical`, `IIDVector`) marginalized or
sampled by Gibbs-within-HMC, `octofit` with ChEES, NUTS, HMC and Gibbs,
the parallel-tempering `octofit_pigeons`, `octofit_rejection`, batched
nested sampling (`dysample`, `samplers.octofit_nested`), validation
(`analysis`: pointwise likelihoods and PSIS-LOO, k-fold and per-epoch
systems, `prior_only_model`, simulation-based calibration and
completeness maps), the Gaia DR3 NSS warm start (`nss`), `Chains`
and the diagnostics, `ess_rhat_batch_device` on the card among them,
`savechain` / `loadchain`, `generate_from_params` and the package-level
`drawfrompriors`, `sample_priors`, `initialize`, `startingpoints` and
`describe`), the chains and the tempering ladder sharded across
processes on `torch.distributed` (`parallel`: `octofit_sharded`,
`octofit_pigeons(mesh=)`, epoch sharding) and the profiling hooks
(`utils`, `octofit(profile_dir=)`), the plots (`plots`, `octoplot`,
`octocorner`; matplotlib is imported only by the functions that draw),
Orbitize! HDF5 I/O (`loadhdf5`, `savehdf5`; `h5py` likewise), the live
data layer (`net`, `datadeps`) and a native table reader (`native`, C++
built with g++ at first use), written in PyTorch.
`LogDensityModel(system, device=..., dtype=...)` fixes the device and
dtype of every tensor the model makes. The device is the GPU unless the
caller says `device="cpu"`. On a CUDA device the orbit solve runs as
hand-written CUDA kernels (`orbits/kernels/csrc/orbit_solve.cu`, forward
and backward, and the standalone Kepler solve `kepler.cu`) and a celerite
Gaussian process as a CUDA forward and backward pair
(`rv/csrc/celerite.cu`), each built with nvcc at first use. This package never imports JAX.
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
    AbsoluteVisualOrbit,
    orbitsolve,
    kepler_solver,
)
from .model import (
    Params,
    Derived,
    DirectLL,
    IIDVector,
    Planet,
    System,
    UniformCircular,
    UserLikelihood,
    LogDensityModel,
    theta_at_epoch_to_tperi,
    ofti_linear_solve,
    likelihoodname,
    generate_from_params,
)
from .model.chain_tools import construct_elements, mcmcchain2result
from .likelihoods import (
    PlanetRelAstromObs,
    PlanetRelAstromLikelihood,
    HGCAInstantaneousObs,
    HGCAInstantaneousLikelihood,
    gaia_plx,
    PhotometryObs,
    PhotometryLikelihood,
    ObsPriorAstromONeil2019,
    LimitClosestApproachAUPrior,
    NonCrossingPrior,
    HillStabilityPrior,
    PlanetOrderPrior,
)
from . import astrom
from .astrom import (
    HipparcosIADObs,
    HipparcosIADLikelihood,
    GaiaCatalogFitObs,
    GaiaCatalogFitLikelihood,
    HGCAObs,
    HGCALikelihood,
    GaiaDR4AstromObs,
    GaiaDR4Astrom,
    G23HObs,
    G23HLikelihood,
)
from . import atmosphere
from .atmosphere import (
    sonora_photometry_interpolator,
    sonora_cooling_interpolator,
    bhac15_mass_age_interpolator,
)
from . import images
from .images import ImageObs, ImageLikelihood, LogLikelihoodMapObs, LogLikelihoodMap
from . import interferometry
from .interferometry import (
    InterferometryObs,
    InterferometryLikelihood,
    AbstractInterferometryObs,
    AbstractInterferometryLikelihood,
    GRAVITYWideKPObs,
    GRAVITYWideKPLikelihood,
)
from . import transits
from .transits import LightCurveObs, LightCurveLikelihood
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
from .rv.data_sources import (
    HARPS_RVBank_rvs,
    HARPS_DR1_rvs,
    HIRES_rvs,
    Lick_rvs,
    CES_lc_rvs,
    CES_vlc_rvs,
    radvel_posterior,
)
from . import io
from . import io as octo_io
from .io import savechain, loadchain
from .io.orbitize import (
    loadhdf5,
    savehdf5,
    Whereistheplanet_search,
    Whereistheplanet_astrom,
)
from . import datadeps
from . import net
from .net import GOST_forecast, query_gaia_catalog, query_nss_tap, tap_query
from .config import OctofitterConfig, get_config, set_config
from .samplers import octofit, octofit_pigeons, octofit_rejection, dysample
from .samplers.nested import octofit_nested
from . import analysis
from .analysis import (
    prior_only_model,
    pointwise_like,
    generate_kfold_systems,
    psis_loo,
    CompletenessJob,
    CompletenessResult,
    CompletenessMap,
    completeness_jobs,
    run_completeness_trial,
    assemble_completeness,
    completeness_map,
)
from . import nss
from .nss import query_nss, nss_to_starting_point, initialize_from_nss, nss_to_model_chain
from .chains import (
    Chains,
    ess_rhat,
    ess_rhat_batch,
    ess_rhat_batch_device,
    ess_tail,
    ess_tail_batch,
)
from . import interop
from . import parallel
from . import utils
from . import plots
from .plots import octoplot, octocorner


def describe(chain):
    """Summary + quantile tables of a Chains (the reference re-exports
    MCMCChains `describe`, src/Octofitter.jl:47)."""
    return chain.describe()


def drawfrompriors(model, generator):
    """A structured parameter set drawn from the model's priors (reference
    `drawfrompriors`, src/variables.jl:1507): `model.drawfrompriors`."""
    return model.drawfrompriors(generator)


def sample_priors(model, generator, n=None):
    """Flat prior draws, (D,) or (n, D) (reference `sample_priors`,
    src/sampling.jl:6): `model.sample_priors`."""
    return model.sample_priors(generator, n)


def initialize(model, *args, **kwargs):
    """Run the starting-point pipeline (reference `initialize!`,
    src/initialization.jl:184) and return the init chain of starting
    points, as the reference does: check data entry with it before
    sampling. (The method `LogDensityModel.initialize` returns the mode
    in unconstrained coordinates instead.)"""
    from .model.initialization import starting_points_chain

    model.initialize(*args, **kwargs)
    return starting_points_chain(model)


def startingpoints(model, points):
    """Set explicit starting points (reference `startingpoints!`,
    src/initialization.jl:293): `model.startingpoints`."""
    return model.startingpoints(points)


__version__ = "0.1.0"
