"""Absolute astrometry stack: ephemeris, scan laws, LSQ fits, Hipparcos
IAD, Gaia catalog fits, HGCA linear-fit, Gaia DR4 epoch astrometry and
the G23H composite model.

PyTorch port of `octofitter_tpu/astrom/`. The ephemeris, scan-law, Gaia
catalog container, IAD parsing and G23H catalog loader are numpy copies;
the likelihoods write the chain axis out.
"""

from .ephemeris import earth_position_au, geocentre_position_query
from .fitting import (
    fit_4param,
    fit_5param,
    fit_5param_pinv,
    prepare_A_4param,
    prepare_A_5param,
)
from .skypath import (
    HIPPARCOS_GRID_STEP_ARCSEC,
    HIPPARCOS_RESOLUTION_ARCSEC,
    hippacentre_combined,
    photocentre_coeff,
    skypath_perturbations_linear,
)
from .scanlaw import (
    GAIA_AGIS_SPAN_DR2,
    GAIA_AGIS_SPAN_DR3,
    META_GAIA_DR1,
    META_GAIA_DR2,
    META_GAIA_DR3,
    add_parallax_factors,
    filter_agis_span,
    filter_scan_gaps,
    load_gost_csv,
    obmt2mjd,
    scanlaw_from_angles,
    tcb_at_gaia_2mjd,
)
from .hipparcos import (
    HipparcosIADLikelihood,
    HipparcosIADObs,
    correct_iad_corruption,
    detect_corruption,
    parse_iad_file,
)
from .gaia import GaiaCatalogFitLikelihood, GaiaCatalogFitObs
from .hgca_linfit import HGCALikelihood, HGCAObs
from .gaia_dr4 import GaiaDR4Astrom, GaiaDR4AstromObs
from .g23h import G23HLikelihood, G23HObs, noncentral_chi2_logpdf
from .g23h_catalog import load_g23h_catalog_row

__all__ = [
    "earth_position_au",
    "geocentre_position_query",
    "fit_4param",
    "fit_5param",
    "fit_5param_pinv",
    "prepare_A_4param",
    "prepare_A_5param",
    "HIPPARCOS_GRID_STEP_ARCSEC",
    "HIPPARCOS_RESOLUTION_ARCSEC",
    "hippacentre_combined",
    "photocentre_coeff",
    "skypath_perturbations_linear",
    "META_GAIA_DR1",
    "META_GAIA_DR2",
    "META_GAIA_DR3",
    "GAIA_AGIS_SPAN_DR2",
    "GAIA_AGIS_SPAN_DR3",
    "add_parallax_factors",
    "filter_agis_span",
    "filter_scan_gaps",
    "load_gost_csv",
    "obmt2mjd",
    "scanlaw_from_angles",
    "tcb_at_gaia_2mjd",
    "HipparcosIADObs",
    "HipparcosIADLikelihood",
    "correct_iad_corruption",
    "detect_corruption",
    "parse_iad_file",
    "GaiaCatalogFitObs",
    "GaiaCatalogFitLikelihood",
    "HGCAObs",
    "HGCALikelihood",
    "GaiaDR4Astrom",
    "GaiaDR4AstromObs",
    "G23HObs",
    "G23HLikelihood",
    "noncentral_chi2_logpdf",
    "load_g23h_catalog_row",
]
