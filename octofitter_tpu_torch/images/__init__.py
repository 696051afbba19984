"""Direct-imaging likelihoods (reference `OctofitterImages`)."""

from .likelihoods import (
    ImageObs,
    ImageLikelihood,
    LogLikelihoodMapObs,
    LogLikelihoodMap,
    contrast_curve,
)
from .utils_interp import interp_image_centered

__all__ = [
    "ImageObs",
    "ImageLikelihood",
    "LogLikelihoodMapObs",
    "LogLikelihoodMap",
    "contrast_curve",
    "interp_image_centered",
]
