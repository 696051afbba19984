"""Photometric transit likelihood (reference `OctofitterTransits`)."""

from .likelihoods import LightCurveObs, LightCurveLikelihood, QuadLimbDark, NonlinearLimbDark, transit_depth

__all__ = [
    "LightCurveObs",
    "LightCurveLikelihood",
    "QuadLimbDark",
    "NonlinearLimbDark",
    "transit_depth",
]
