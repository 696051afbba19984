"""Visualization (reference `ext/OctofitterMakieExt/`, `OctofitterPairPlotsExt`).

Port of `octofitter_tpu/plots/`: the same 19 functions. matplotlib is
imported only when a function draws, so the package imports without it.
"""

from .octoplot import octoplot, astromplot, rvtimeplot, pmaplot, rvpostplot
from .corner import octocorner
from .sbc_plots import calibrationplots, sbc_corner
from .panels import (
    absastromplot,
    astromtimeplot,
    completenessplot,
    dotplot,
    gaiastarplot,
    gaiatimeplot,
    hgcaplot,
    hipparcosplot,
    masspostplot,
    physorbitplot,
    skytrackplot,
)

__all__ = [
    "octoplot",
    "calibrationplots",
    "sbc_corner",
    "octocorner",
    "astromplot",
    "rvtimeplot",
    "pmaplot",
    "rvpostplot",
    "astromtimeplot",
    "physorbitplot",
    "masspostplot",
    "dotplot",
    "hgcaplot",
    "hipparcosplot",
    "gaiastarplot",
    "gaiatimeplot",
    "skytrackplot",
    "absastromplot",
    "completenessplot",
]
