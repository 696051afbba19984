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
from .parameterizations import (
    ofti_linear_solve,
    theta_at_epoch_to_tperi,
    theta_omegatheta_at_epoch_to_omega_tperi,
    theta_sep_at_epoch_to_tperi_sma,
)

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
    "theta_omegatheta_at_epoch_to_omega_tperi",
    "theta_sep_at_epoch_to_tperi_sma",
    "ofti_linear_solve",
]
