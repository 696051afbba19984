"""Radial-velocity likelihoods (the reference's `OctofitterRadialVelocity`),
with Gaussian-process noise: dense kernels (`kernels.py`) and celerite
terms (`celerite.py`, on the GPU through the CUDA kernel pair of
`csrc/celerite.cu`), and the RV archive loaders (`data_sources.py`)."""

from .likelihoods import (
    StarAbsoluteRVObs,
    StarAbsoluteRVLikelihood,
    MarginalizedStarAbsoluteRVObs,
    MarginalizedStarAbsoluteRVLikelihood,
    StarAbsoluteRVMarginLikelihood,
    PlanetRelativeRVObs,
    PlanetRelativeRVLikelihood,
)
from .celerite import (
    CeleriteTerm,
    RealTerm,
    ComplexTerm,
    SHOTerm,
    celerite_loglike,
)
from .kernels import (
    Kernel,
    SqExponentialKernel,
    Matern32Kernel,
    QuasiPeriodicKernel,
    gp_loglike,
    gp_predict,
)
from .data_sources import (
    HARPS_RVBank_rvs,
    HARPS_DR1_rvs,
    HIRES_rvs,
    Lick_rvs,
    CES_lc_rvs,
    CES_vlc_rvs,
    radvel_posterior,
)

__all__ = [
    "StarAbsoluteRVObs",
    "StarAbsoluteRVLikelihood",
    "MarginalizedStarAbsoluteRVObs",
    "MarginalizedStarAbsoluteRVLikelihood",
    "StarAbsoluteRVMarginLikelihood",
    "PlanetRelativeRVObs",
    "PlanetRelativeRVLikelihood",
    "Kernel",
    "SqExponentialKernel",
    "Matern32Kernel",
    "QuasiPeriodicKernel",
    "gp_loglike",
    "gp_predict",
    "CeleriteTerm",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "celerite_loglike",
    "HARPS_RVBank_rvs",
    "HARPS_DR1_rvs",
    "HIRES_rvs",
    "Lick_rvs",
    "CES_lc_rvs",
    "CES_vlc_rvs",
    "radvel_posterior",
]
