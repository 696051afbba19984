"""Radial-velocity likelihoods (the reference's `OctofitterRadialVelocity`),
without Gaussian processes."""

from .likelihoods import (
    StarAbsoluteRVObs,
    StarAbsoluteRVLikelihood,
    MarginalizedStarAbsoluteRVObs,
    MarginalizedStarAbsoluteRVLikelihood,
    StarAbsoluteRVMarginLikelihood,
    PlanetRelativeRVObs,
    PlanetRelativeRVLikelihood,
)

__all__ = [
    "StarAbsoluteRVObs",
    "StarAbsoluteRVLikelihood",
    "MarginalizedStarAbsoluteRVObs",
    "MarginalizedStarAbsoluteRVLikelihood",
    "StarAbsoluteRVMarginLikelihood",
    "PlanetRelativeRVObs",
    "PlanetRelativeRVLikelihood",
]
