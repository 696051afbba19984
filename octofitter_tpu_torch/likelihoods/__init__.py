"""Observation / likelihood layer."""

from .relastrom import PlanetRelAstromObs, PlanetRelAstromLikelihood
from .hgca import HGCAInstantaneousObs, HGCAInstantaneousLikelihood, gaia_plx

__all__ = [
    "PlanetRelAstromObs",
    "PlanetRelAstromLikelihood",
    "HGCAInstantaneousObs",
    "HGCAInstantaneousLikelihood",
    "gaia_plx",
]
