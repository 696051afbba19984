"""Model specification and posterior construction."""

from .params import Params, hasproperty
from .variables import (
    AbstractObs,
    Derived,
    DirectLL,
    Planet,
    PlanetObservationContext,
    System,
    SystemObservationContext,
    UniformCircular,
    UnitLengthPrior,
    UserLikelihood,
    likelihoodname,
    normalizename,
)
from .logdensity import LogDensityModel
from .parameterizations import theta_at_epoch_to_tperi

__all__ = [
    "Params",
    "hasproperty",
    "AbstractObs",
    "Derived",
    "DirectLL",
    "Planet",
    "PlanetObservationContext",
    "System",
    "SystemObservationContext",
    "UniformCircular",
    "UnitLengthPrior",
    "UserLikelihood",
    "likelihoodname",
    "normalizename",
    "LogDensityModel",
    "theta_at_epoch_to_tperi",
]
