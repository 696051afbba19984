"""Interferometry likelihoods (reference `OctofitterInterferometry`)."""

from .likelihoods import (
    InterferometryObs,
    InterferometryLikelihood,
    AbstractInterferometryObs,
    AbstractInterferometryLikelihood,
    cvis_point_sources,
    closure_phases_deg,
)
from .oifits import load_oifits, cp_indices
from .gravity import (
    GRAVITYWideKPObs,
    GRAVITYWideKPLikelihood,
    fiber_coupling_fraction,
)

__all__ = [
    "InterferometryObs",
    "InterferometryLikelihood",
    "AbstractInterferometryObs",
    "AbstractInterferometryLikelihood",
    "cvis_point_sources",
    "closure_phases_deg",
    "load_oifits",
    "cp_indices",
    "GRAVITYWideKPObs",
    "GRAVITYWideKPLikelihood",
    "fiber_coupling_fraction",
]
