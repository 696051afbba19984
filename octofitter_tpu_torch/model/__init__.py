"""Model specification and posterior construction."""

from .params import Params, hasproperty
from .variables import (
    AbstractObs,
    BlankLikelihood,
    Derived,
    DirectLL,
    IIDVector,
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
from .initialization import starting_points_chain
from .generate import generate_from_params
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
    "BlankLikelihood",
    "Derived",
    "DirectLL",
    "IIDVector",
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
    "starting_points_chain",
    "generate_from_params",
    "theta_at_epoch_to_tperi",
    "theta_omegatheta_at_epoch_to_omega_tperi",
    "theta_sep_at_epoch_to_tperi_sma",
    "ofti_linear_solve",
]
