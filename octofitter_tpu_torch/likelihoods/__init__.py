"""Observation / likelihood layer."""

from .relastrom import PlanetRelAstromObs, PlanetRelAstromLikelihood
from .photometry import PhotometryObs, PhotometryLikelihood
from .hgca import HGCAInstantaneousObs, HGCAInstantaneousLikelihood, gaia_plx
from .obs_priors import (
    ObsPriorAstromONeil2019,
    LimitClosestApproachAUPrior,
    NonCrossingPrior,
    HillStabilityPrior,
    PlanetOrderPrior,
)

__all__ = [
    "PlanetRelAstromObs",
    "PlanetRelAstromLikelihood",
    "PhotometryObs",
    "PhotometryLikelihood",
    "HGCAInstantaneousObs",
    "HGCAInstantaneousLikelihood",
    "gaia_plx",
    "ObsPriorAstromONeil2019",
    "LimitClosestApproachAUPrior",
    "NonCrossingPrior",
    "HillStabilityPrior",
    "PlanetOrderPrior",
]
