"""G23H composite absolute-astrometry likelihood.

PyTorch port of `octofitter_tpu/astrom/g23h.py` (the reference's
`G23HObs`, `src/likelihoods/g23h.jl`): a joint model of the G23H
catalog channels

  1-2   Hipparcos-epoch proper motion        (per-scan BINARYS sim + LSQ)
  3-4   Hip->DR3 positional proper motion
  5-6   Gaia DR2 proper motion               (per-scan sim + LSQ)
  7-8   DR3-DR2 scaled positional PM
  9-10  Gaia DR3 proper motion               (per-scan sim + LSQ)
  11    UEVA (RUWE / astrometric excess noise) with the cube-root
        transform, single-star calibration, the change-of-variables
        Jacobian, and DR3/DR32 covariance deflation
plus the Hipparcos IAD residual channel (offset+trend nuisances) and the
Gaia RV-variability channel (non-central chi^2 on the catalog RV scatter).

The chain axis is written out. The JAX package computes one sample and
is vmapped; here every per-sample value is one value per row (the
context's row shape R, chains or chains times discrete combinations):
the photocentre perturbations are (R..., n) over each mission's scans;
the three 5-parameter fits solve every row at once, by one batched
Cholesky of the normal equations where each row's epoch selection gives
it its own weights (`fitting.py`), or by a weighted pseudo-inverse formed
once where one weighting serves every row (frozen or no selection, the
Hipparcos scans); the selection weights come from a stable per-row sort
of the transit priorities; the channel covariance is constant terms
times per-row coefficients, one product; and the catalog channels take
one Cholesky factorization per row (at most 11 x 11; a row whose
covariance is not positive definite gives -inf with a zero gradient
row). These are library calls, as the JAX package leaves them to XLA: no
Pallas kernel computes any of them. The orbit solves that reach this
likelihood are the model's (the fused pair on Visual{KepOrbit}, the
standalone Kepler kernel at each row's emission epochs on
AbsoluteVisual{KepOrbit}); the barycentre's propagation to the nine
release epochs (DR3, DR2 and Hipparcos: right ascension, declination and
100 days after the later one) is one `propagate_astrometry` over a
(R..., 9) epoch tensor, which solves no Kepler equation: the JAX package
solves the whole orbit at each and reads only the propagated astrometry.

Per-sample epoch selection (`transit_priorities` / `transits_dr2`) is a
weight mask in the fits' normal equations: each scan row carries a
multiplicity in {0, 1, 2, ...} computed from the sampled priorities
(detached: the selection is piecewise constant, and gradients reach the
priorities only through their prior).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from ..constants import HIPPARCOS_EPOCH_MJD, J2000_MJD, JULIAN_YEAR_DAYS, MJUP2MSOL
from ..likelihoods.utils import row_shape, take_epochs
from ..model.params import Params, hasproperty
from ..model.variables import AbstractObs, SystemObservationContext
from ..orbits import AbsoluteVisualOrbit, propagate_astrometry, radvel
from ..rv.kernels import _gated_cholesky
from .fitting import fit_5param, prepare_A_5param
from .gaia import GaiaCatalogFitObs
from .hipparcos import HipparcosIADObs
from .scanlaw import GAIA_AGIS_SPAN_DR2, GAIA_AGIS_SPAN_DR3
from .skypath import hippacentre_combined, skypath_perturbations_linear

_CHANNELS = [
    "ra_hip", "dec_hip", "ra_hg", "dec_hg", "ra_dr2", "dec_dr2",
    "ra_dr32", "dec_dr32", "ra_dr3", "dec_dr3", "ueva_dr3",
]
_DEG2MAS = 3600.0 * 1000.0
_LOG_2PI = math.log(2 * math.pi)
# the floor under log(nc / 2) and log(x) in the Poisson series: the JAX
# package's 1e-300, or float32's smallest normal number, where 1e-300
# rounds to 0 (and log 0 times j = 0 would be NaN)
_LOG_FLOOR = {torch.float64: 1e-300, torch.float32: torch.finfo(torch.float32).tiny}


def noncentral_chi2_logpdf(x, df, nc, n_terms: int = 64):
    """log pdf of the noncentral chi-squared via the Poisson-mixture series
    (differentiable; used by the Gaia RV channel): x and nc of the rows'
    shape, the n_terms series terms on a trailing axis reduced by
    logsumexp. At nc = 0 the series is the central chi-squared, finite in
    float32 too."""
    ref = x if isinstance(x, torch.Tensor) else torch.as_tensor(nc)
    x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    nc = torch.as_tensor(nc, dtype=ref.dtype, device=ref.device)
    floor = _LOG_FLOOR.get(ref.dtype, 1e-300)
    j = torch.arange(n_terms, dtype=ref.dtype, device=ref.device)
    nc_, x_ = nc[..., None], x[..., None]
    # Poisson(nc/2) weights
    log_w = -nc_ / 2 + j * torch.log(torch.clamp(nc_ / 2, min=floor)) - torch.lgamma(j + 1)
    k = df + 2 * j
    log_chi2 = ((k / 2 - 1) * torch.log(torch.clamp(x_, min=floor)) - x_ / 2
                - (k / 2) * math.log(2.0) - torch.lgamma(k / 2))
    return torch.logsumexp(log_w + log_chi2, dim=-1)


def _jyear_to_mjd(jy):
    return (jy - 2000.0) * JULIAN_YEAR_DAYS + J2000_MJD


def _sqrt2x2(M):
    """Principal square root of an SPD 2x2 matrix (numpy, closed form):
    sqrt(M) = (M + sqrt(det) I) / sqrt(tr + 2 sqrt(det))."""
    s = math.sqrt(max(M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0], 0.0))
    t = math.sqrt(max(M[0, 0] + M[1, 1] + 2 * s, 1e-300))
    return (M + s * np.eye(2)) / t


_REQ_CAT = [
    "pmra_dr3", "pmdec_dr3", "pmra_dr3_error", "pmdec_dr3_error", "pmra_pmdec_dr3",
    "pmra_dr2", "pmdec_dr2", "pmra_dr2_error", "pmdec_dr2_error", "pmra_pmdec_dr2",
    "pmra_dr32", "pmdec_dr32", "pmra_dr32_error", "pmdec_dr32_error", "pmra_pmdec_dr32",
    "epoch_ra_dr3_mjd", "epoch_dec_dr3_mjd", "epoch_ra_dr2_mjd", "epoch_dec_dr2_mjd",
    "astrometric_chi2_al_dr3", "astrometric_n_good_obs_al_dr3",
    "astrometric_matched_transits_dr3",
]


# --------------------------------------------------------------------------
# Per-sample epoch-selection machinery (`g23h.jl:749-836`): pools and
# counts are static (host-side numpy, copied from the JAX package); which
# epochs fill them is sampled via continuous priorities and applied as
# fit weight masks, one per row.
# --------------------------------------------------------------------------

class _EpochPools:
    """Static DR2/DR3 selection pools and target counts for one source."""

    def __init__(self):
        self.dr2_pool = np.zeros(0, int)
        self.dr3_win = np.zeros(0, int)
        self.dr3_tail = np.zeros(0, int)
        self.n2_win = 0
        self.n_tail = 0
        self.n_dr2_total = 0
        self.n_dr2_lo = 0
        self.n_dr2_hi = 0
        self.marginalize_dup = False
        self.n_epochs = 0


def _in_gaps(epochs, gaps):
    m = np.zeros(len(epochs), bool)
    for start, stop in gaps:
        m |= (epochs >= start) & (epochs <= stop)
    return m


def _epoch_pools(catalog, gaia_like, gaps_dr2, gaps_dr3, gmag_threshold):
    """Selection pools per release with gap masks and target transit
    counts (`g23h.jl:525-559,738-795`)."""
    p = _EpochPools()
    ep = np.asarray(gaia_like.table["epoch"], float)
    p.n_epochs = len(ep)
    dr2_ok = (
        (ep >= GAIA_AGIS_SPAN_DR2["start_mjd"])
        & (ep <= GAIA_AGIS_SPAN_DR2["stop_mjd"])
        & ~_in_gaps(ep, gaps_dr2)
    )
    dr3_ok = (
        (ep >= GAIA_AGIS_SPAN_DR3["start_mjd"])
        & (ep <= GAIA_AGIS_SPAN_DR3["stop_mjd"])
        & ~_in_gaps(ep, gaps_dr3)
    )
    dr2_stop = GAIA_AGIS_SPAN_DR2["stop_mjd"]
    p.dr2_pool = np.nonzero(dr2_ok)[0]
    p.dr3_win = np.nonzero(dr3_ok & (ep <= dr2_stop))[0]
    p.dr3_tail = np.nonzero(dr3_ok & (ep > dr2_stop))[0]

    n_dr3 = int(catalog["astrometric_matched_transits_dr3"])
    n_pool = len(p.dr3_win) + len(p.dr3_tail)
    if n_pool < n_dr3:
        # degenerate: every usable forecast epoch is selected
        p.n2_win = len(p.dr3_win)
        p.n_tail = len(p.dr3_tail)
    else:
        p.n2_win = int(
            np.clip(
                round(n_dr3 * len(p.dr3_win) / max(n_pool, 1)),
                max(n_dr3 - len(p.dr3_tail), 0),
                min(len(p.dr3_win), n_dr3),
            )
        )
        p.n_tail = n_dr3 - p.n2_win

    # DR2 totals incl. doubly-downlinked bright-star transits
    # (`_g23h_dr2_target_transits`, `g23h.jl:200-220`)
    v = catalog.get("astrometric_matched_observations_dr2", None)
    if v is None or not np.isfinite(v):
        # documented approximation when the DR2 sidecar count is absent:
        # assume the DR2 selection matches the pool size (no duplicates)
        p.n_dr2_total = min(len(p.dr2_pool), max(p.n2_win, 1))
    else:
        p.n_dr2_total = max(int(round(float(v))), 0)
    p.n_dr2_hi = min(p.n_dr2_total, len(p.dr2_pool))
    gmag = catalog.get("phot_g_mean_mag_dr3", np.nan)
    bright = np.isfinite(gmag) and gmag < gmag_threshold
    if bright:
        lo = int(np.ceil(p.n_dr2_total / 2))
        p.n_dr2_lo = int(np.clip(lo, min(1, p.n_dr2_hi), p.n_dr2_hi))
    else:
        p.n_dr2_lo = p.n_dr2_hi
    p.marginalize_dup = p.n_dr2_lo < p.n_dr2_hi
    return p


def _descending_ranks(values):
    """0-based rank of each entry of `values` (..., n) in descending order
    along the last axis, ties in index order (the stable sort of the JAX
    package's `jnp.argsort(-values)`)."""
    order = torch.argsort(-values, dim=-1, stable=True)
    ranks = torch.arange(values.shape[-1], device=values.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


def _pool_ranks(priorities, pool_idx):
    """0-based descending rank of each pool member's priority, per row."""
    return _descending_ranks(priorities[..., torch.as_tensor(pool_idx, device=priorities.device)])


def _dr3_weights(priorities, pools: _EpochPools):
    """DR3 selection weights over the full epoch axis, per row: top-n2_win
    of the DR2-window pool + top-n_tail of the DR3-only tail
    (`g23h.jl:819-823`)."""
    w = priorities.new_zeros(priorities.shape[:-1] + (pools.n_epochs,))
    for pool, n_sel in ((pools.dr3_win, pools.n2_win), (pools.dr3_tail, pools.n_tail)):
        if len(pool):
            r = _pool_ranks(priorities, pool)
            w[..., torch.as_tensor(pool, device=w.device)] = (r < n_sel).to(w.dtype)
    return w


def _dr2_weights(priorities, n_distinct, pools: _EpochPools):
    """DR2 multiplicity weights per row (`_g23h_select_dr2_epochs`,
    `g23h.jl:233-241`): the top-`n_distinct` pool epochs get weight 1, and
    the `n_dr2_total - n_distinct` repeats wrap over the selection in
    priority order: the epoch at selection rank r receives
    `n_rep // n_distinct + (r < n_rep % n_distinct)` extra copies.
    `n_distinct`: an integer, or one per row."""
    w = priorities.new_zeros(priorities.shape[:-1] + (pools.n_epochs,))
    if not len(pools.dr2_pool):
        return w
    r = _pool_ranks(priorities, pools.dr2_pool)
    n_distinct = torch.clamp(torch.as_tensor(n_distinct, device=r.device).long(), min=1)[..., None]
    n_rep = torch.clamp(pools.n_dr2_total - n_distinct, min=0)
    q = n_rep // n_distinct
    rem = n_rep - q * n_distinct
    mult = torch.where(r < n_distinct, 1 + q + (r < rem).long(), 0)
    w[..., torch.as_tensor(pools.dr2_pool, device=w.device)] = mult.to(w.dtype)
    return w


def _rv_weights(priorities, w_dr3, n_rv, n_astro_sel):
    """RV transits = top-n_rv priorities WITHIN each row's DR3 selection
    (`g23h.jl:879-897`); all of it when n_rv >= n_astro_sel."""
    if n_rv >= n_astro_sel:
        return w_dr3
    masked = torch.where(w_dr3 > 0, priorities, -torch.inf)
    ranks = _descending_ranks(masked)
    return torch.where((ranks < n_rv) & (w_dr3 > 0), 1.0, 0.0).to(w_dr3.dtype)


def _zero(scope):
    """A zero of the dtype and device of the first tensor in `scope`."""
    ref = next(v for v in scope.values() if isinstance(v, torch.Tensor))
    return torch.zeros((), dtype=ref.dtype, device=ref.device)


def _build_auto_variables(catalog, pools, hip_like, ueva_mode, include_iad,
                          include_rv, freeze_epochs, seed):
    """Default observation variables (`g23h.jl:687-905`): UEVA calibration
    priors from the catalog sigma fields (population-median constants if
    absent or ueva_mode none), fluxratio passthrough, transit priorities,
    duplicate-count marginalization, IAD nuisances, and the per-transit
    RV uncertainty prior."""
    from ..distributions import LogNormal, LogUniform, Normal, Uniform, truncated
    from ..model.variables import IIDVector

    v = {}
    has_sig = all(
        np.isfinite(catalog.get(k, np.nan))
        for k in ("sig_AL", "sig_AL_sigma", "sig_att_radec",
                  "sig_att_radec_sigma", "sig_cal", "sig_cal_sigma")
    )
    if ueva_mode == "none" or not has_sig:
        # inert placeholders / population medians (`g23h.jl:695-722`)
        v["σ_AL"] = 0.132
        v["σ_att"] = 0.0779
        v["σ_calib"] = 0.0795
    else:
        v["σ_AL"] = truncated(
            Normal(catalog["sig_AL"], catalog["sig_AL_sigma"]), lower=1e-6, upper=10.0)
        v["σ_att"] = truncated(
            Normal(catalog["sig_att_radec"], catalog["sig_att_radec_sigma"]),
            lower=1e-6, upper=10.0)
        v["σ_calib"] = truncated(
            Normal(catalog["sig_cal"], catalog["sig_cal_sigma"]), lower=1e-6, upper=10.0)

    def _fr(sys, obs):
        return sys.fluxratio if hasproperty(sys, "fluxratio") else _zero(sys)

    def _frh(sys, obs):
        return sys.fluxratio_hip if hasproperty(sys, "fluxratio_hip") else _zero(sys)

    v["fluxratio"] = _fr
    v["fluxratio_hip"] = _frh

    if freeze_epochs:
        rng = np.random.default_rng(seed)
        v["transit_priorities"] = rng.standard_normal(pools.n_epochs)
        if pools.marginalize_dup:
            v["u_dup_dr2"] = float(rng.uniform())
    else:
        v["transit_priorities"] = IIDVector(Normal(0.0, 1.0), pools.n_epochs)
        if pools.marginalize_dup:
            v["u_dup_dr2"] = Uniform(0.0, 1.0)

    if include_iad and hip_like is not None:
        pm_ra = float(hip_like.hip_sol["pm_ra"])
        pm_de = float(hip_like.hip_sol["pm_de"])
        v["hip_iad_jitter"] = LogUniform(0.001, 100.0)
        v["iad_Δra"] = Uniform(-1000.0, 1000.0)
        v["iad_Δdec"] = Uniform(-1000.0, 1000.0)
        v["iad_Δplx"] = Uniform(-10.0, 10.0)
        v["iad_Δpmra"] = Uniform(-1000.0, 1000.0)
        v["iad_Δpmdec"] = Uniform(-1000.0, 1000.0)
        v["iad_pmra"] = lambda sys, obs, _p=pm_ra: _p + obs["iad_Δpmra"]
        v["iad_pmdec"] = lambda sys, obs, _p=pm_de: _p + obs["iad_Δpmdec"]

    if (
        include_rv
        and np.isfinite(catalog.get("rv_ln_uncert_dr3", np.nan))
        and np.isfinite(catalog.get("rv_ln_uncert_err_dr3", np.nan))
    ):
        v["σ_rv_per_transit"] = LogNormal(
            catalog["rv_ln_uncert_dr3"], catalog["rv_ln_uncert_err_dr3"]
        )
    return v


def _coerce_scalar(v):
    # integer dtypes (incl. np.int64 gaia_source_id, 19 digits > 2^53)
    # must go to Python int, not float
    if np.ndim(v) != 0 or isinstance(v, (int, str)):
        return v
    if np.issubdtype(np.asarray(v).dtype, np.integer):
        return int(np.asarray(v))
    return float(np.asarray(v))


class G23HObs(AbstractObs):
    """G23H composite likelihood.

    Parameters:
      catalog: dict of G23H catalog fields for one source. Hip channels
        are enabled when `pmra_hip`/... are present; UEVA per
        `ueva_mode`; RV per `include_rv` + `radial_velocity_error`.
      hip_like: HipparcosIADObs (required for the Hip channels).
      gaia_like: GaiaCatalogFitObs whose scan table spans the DR2+DR3
        windows (design matrices are rebuilt against each release's
        reference epochs internally).
      ueva_mode: "RUWE" (default), "EAN", or "none".
      include_iad / include_rv: toggle those channels.

    Observation variables: σ_att, σ_AL, σ_calib (UEVA calibration),
    fluxratio / fluxratio_hip (one per planet on a last axis, or one), and
    when include_iad: iad_Δra, iad_Δdec, iad_pmra, iad_pmdec, iad_Δplx,
    hip_iad_jitter; when include_rv: σ_rv_per_transit [km/s].
    """

    def __init__(
        self,
        *,
        catalog: dict,
        gaia_like: GaiaCatalogFitObs,
        hip_like: HipparcosIADObs | None = None,
        ueva_mode: str = "RUWE",
        include_iad: bool = True,
        include_rv: bool = True,
        variables=None,
        name="G23H",
        marginalize_epochs: bool = True,
        freeze_epochs: bool = False,
        gaps_dr2=(),
        gaps_dr3=(),
        dr2_dup_gmag_threshold: float = 6.5,
        epoch_rng_seed: int = 0,
    ):
        pools = _epoch_pools(catalog, gaia_like, gaps_dr2, gaps_dr3, dr2_dup_gmag_threshold)
        if variables is None and marginalize_epochs:
            variables = _build_auto_variables(
                catalog, pools, hip_like, ueva_mode,
                include_iad and hip_like is not None, include_rv,
                freeze_epochs, epoch_rng_seed,
            )
        super().__init__(variables=variables, name=name)
        self.pools = pools
        missing = [k for k in _REQ_CAT if k not in catalog]
        if missing:
            raise ValueError(f"G23H catalog row missing {missing}")

        self.catalog = {k: _coerce_scalar(v) for k, v in catalog.items()}
        self.gaia_like = gaia_like
        self.hip_like = hip_like
        self.ueva_mode = ueva_mode
        self.include_iad = include_iad and hip_like is not None
        self.has_hip = hip_like is not None and "pmra_hip" in catalog
        self.include_rv = include_rv and "radial_velocity_error" in catalog

        # active channels (`like.table.kind`)
        kinds = []
        if self.has_hip:
            kinds += ["ra_hip", "dec_hip", "ra_hg", "dec_hg"]
        kinds += ["ra_dr2", "dec_dr2", "ra_dr32", "dec_dr32", "ra_dr3", "dec_dr3"]
        if ueva_mode != "none":
            kinds += ["ueva_dr3"]
        self.kinds = kinds

        gt = gaia_like.table
        ep = gt["epoch"]
        self._dr3_sel = np.nonzero(
            (ep >= GAIA_AGIS_SPAN_DR3["start_mjd"]) & (ep <= GAIA_AGIS_SPAN_DR3["stop_mjd"])
        )[0]
        self._dr2_sel = np.nonzero(
            (ep >= GAIA_AGIS_SPAN_DR2["start_mjd"]) & (ep <= GAIA_AGIS_SPAN_DR2["stop_mjd"])
        )[0]
        if len(self._dr3_sel) < 6 or len(self._dr2_sel) < 6:
            raise ValueError("gaia scan table does not cover the DR2/DR3 windows")

        def prep(sel, ref_ra, ref_dec):
            return prepare_A_5param(
                ep[sel], gt["cosphi"][sel], gt["sinphi"][sel],
                gt["parallaxFactorAlongScan"][sel], ref_ra, ref_dec,
            )

        cat = self.catalog
        self.A5_dr3 = prep(self._dr3_sel, cat["epoch_ra_dr3_mjd"], cat["epoch_dec_dr3_mjd"])
        self.A5_dr2 = prep(self._dr2_sel, cat["epoch_ra_dr2_mjd"], cat["epoch_dec_dr2_mjd"])
        # full-pool design matrices for the weight-masked per-sample
        # selections (rows outside a sample's selection get weight 0)
        all_rows = np.arange(len(ep))
        self.A5_dr3_full = prep(all_rows, cat["epoch_ra_dr3_mjd"], cat["epoch_dec_dr3_mjd"])
        self.A5_dr2_full = prep(all_rows, cat["epoch_ra_dr2_mjd"], cat["epoch_dec_dr2_mjd"])

        # epoch registration: hip scans then gaia scans
        n_hip = len(hip_like.table["epoch"]) if hip_like is not None else 0
        self.n_hip = n_hip
        self.n_gaia = len(ep)
        self.table = {
            "epoch": np.concatenate(
                ([hip_like.table["epoch"]] if hip_like is not None else []) + [ep]
            )
        }

        # gaia dof (`g23h.jl:1703`)
        self.gaia_n_dof = 5 if int(cat.get("astrometric_params_solved_dr3", 31)) == 31 else 6

    @property
    def epochs(self):
        return self.table["epoch"]

    # ------------------------------------------------------------------
    def _fluxratio(self, theta_obs, key, i, rows, like):
        if isinstance(theta_obs, Params) and key in theta_obs:
            fr = theta_obs[key]
            if fr.ndim == 0 or tuple(fr.shape) == rows:
                return fr
            return fr[..., i]
        return like.new_zeros(())

    def _release_epochs(self):
        """The nine (fewer without Hipparcos) epochs the barycentre is
        propagated to: per release (DR3, DR2, Hipparcos) its right
        ascension's and declination's reference epochs and 100 days after
        the later one."""
        cat = self.catalog
        pairs = [(cat["epoch_ra_dr3_mjd"], cat["epoch_dec_dr3_mjd"]),
                 (cat["epoch_ra_dr2_mjd"], cat["epoch_dec_dr2_mjd"])]
        if self.has_hip:
            pairs.append((_jyear_to_mjd(cat["epoch_ra_hip"]), _jyear_to_mjd(cat["epoch_dec_hip"])))
        return pairs

    def _propagate_astrom(self, orbit, theta, like):
        """Per release, (ra, dec, pmra, pmdec) of the barycentre at its
        channel epochs: on AbsoluteVisual{KepOrbit} the propagated
        astrometry with the differential light-travel apparent acceleration
        (`g23h.jl` via `_propagate_astrom`), all releases in one call;
        otherwise (0, 0, pmra, pmdec)."""
        pairs = self._release_epochs()
        if not isinstance(orbit, AbsoluteVisualOrbit):
            zero = like.new_zeros(())
            return [(zero, zero, theta.pmra, theta.pmdec)] * len(pairs)
        dt = 100.0
        t = self.constant("release_epochs", lambda: np.array(
            [[ra, dec, max(ra, dec) + dt] for ra, dec in pairs]).reshape(-1), like)
        comp = propagate_astrometry(orbit, t)
        out = []
        for r, (ep_ra, ep_dec) in enumerate(pairs):
            i_ra, i_dec, i_late = 3 * r, 3 * r + 1, 3 * r + 2
            i_sol = i_ra if ep_ra >= ep_dec else i_dec
            lt = (comp.t_em_days[..., i_late] - comp.t_em_days[..., i_sol] - dt) / dt
            out.append((comp.ra2[..., i_ra], comp.dec2[..., i_dec],
                        comp.pmra2[..., i_ra] + lt * comp.pmra2[..., i_sol],
                        comp.pmdec2[..., i_dec] + lt * comp.pmdec2[..., i_sol]))
        return out

    def _frozen_selection(self):
        """The selection weights (numpy: priorities, w_dr3, w_dr2, w_rv) where
        the priorities (and the DR2 duplicate draw, if any) are constants of
        this observation (`freeze_epochs`), computed once; else None."""
        if "frozen_selection" not in self._columns:
            specs = {spec.name: spec for spec in self.var_specs}
            pr, u = specs.get("transit_priorities"), specs.get("u_dup_dr2")
            out = None
            if (pr is not None and pr.kind == "constant"
                    and (u is None or u.kind == "constant" or not self.pools.marginalize_dup)):
                p = torch.as_tensor(np.asarray(pr.value, dtype=np.float64))
                n_distinct = self.pools.n_dr2_hi
                if self.pools.marginalize_dup and u is not None:
                    lo, hi = self.pools.n_dr2_lo, self.pools.n_dr2_hi
                    n_distinct = min(lo + int(math.floor(float(u.value) * (hi - lo + 1))), hi)
                w3 = _dr3_weights(p, self.pools)
                w_rv = _rv_weights(p, w3, int(self.catalog.get("rv_nb_transits", 8)),
                                   self.pools.n2_win + self.pools.n_tail)
                out = tuple(x.numpy() for x in (p, w3, _dr2_weights(p, n_distinct, self.pools),
                                                w_rv))
            self._columns["frozen_selection"] = out
        return self._columns["frozen_selection"]

    def _selection(self, theta_obs, like):
        """(priorities, w_dr3, w_dr2, n_dr3_modeled): the selection weights
        from the sampled priorities, one per row and detached, or from the
        frozen ones (numpy, the same for every row), or Nones without
        priorities."""
        use_marg = (isinstance(theta_obs, Params) and "transit_priorities" in theta_obs
                    and getattr(self, "pools", None) is not None)
        if not use_marg:
            return None, None, None, len(self._dr3_sel)
        n_modeled = self.pools.n2_win + self.pools.n_tail
        frozen = self._frozen_selection()
        if frozen is not None:
            return frozen[0], frozen[1], frozen[2], n_modeled
        # selection is piecewise-constant in the priorities: gradients flow
        # only through the prior (as in the reference, where ForwardDiff
        # sees constant integer selections)
        pr = torch.as_tensor(theta_obs["transit_priorities"], dtype=like.dtype,
                             device=like.device).detach()
        w_dr3 = _dr3_weights(pr, self.pools)
        if self.pools.marginalize_dup and "u_dup_dr2" in theta_obs:
            u = torch.as_tensor(theta_obs["u_dup_dr2"]).detach()
            lo, hi = self.pools.n_dr2_lo, self.pools.n_dr2_hi
            n_distinct = torch.clamp(lo + torch.floor(u * (hi - lo + 1)).long(), max=hi)
        else:
            n_distinct = self.pools.n_dr2_hi
        w_dr2 = _dr2_weights(pr, n_distinct, self.pools)
        return pr, w_dr3, w_dr2, n_modeled

    def _fit(self, key, A, weights, d_a, d_d, cos, sin, like, residuals=0.0):
        """The 5-parameter fit of every row's perturbations (d_a, d_d)
        (..., N) over the scans of the numpy design matrix A (N, 5):
        ((d_alpha, d_delta, d_pmra, d_pmdec, d_plx), chi2), chi2 the weighted
        residuals' sum of squares. Per-row weights (a tensor with a row axis)
        go to `fitting.fit_5param`; one weighting for every row (numpy, or
        None for all ones) is solved by its weighted pseudo-inverse, formed
        once per dtype and device."""
        if isinstance(weights, torch.Tensor):
            out = fit_5param(self.constant(key, lambda: A, like), cos, sin, d_a, d_d,
                             residuals=residuals, include_chi2=True, weights=weights)
            return out["parameters"], out["chi_squared_astro"]
        w = np.ones(len(A)) if weights is None else np.asarray(weights, dtype=np.float64)

        def operators():
            Aw = A * np.sqrt(w)[:, None]
            return np.concatenate([np.linalg.pinv(Aw), Aw.T])      # (10, N)

        P = self.constant(f"{key}_operators", operators, like)
        b = (d_a * cos + d_d * sin + residuals) * self.constant(f"{key}_sw",
                                                                 lambda: np.sqrt(w), like)
        x = b @ P[:5].T
        r = b - x @ P[5:]
        return (x[..., 0], x[..., 1], x[..., 3], x[..., 4], x[..., 2]), torch.sum(r * r, dim=-1)

    # ------------------------------------------------------------------
    def simulate(self, ctx: SystemObservationContext):
        theta = ctx.theta_system
        theta_obs = ctx.theta_obs
        cat = self.catalog
        pnames = list(theta.planets.keys())
        n_p = len(pnames)
        like = (ctx.solutions[0].raoff_mas if n_p and ctx.solutions[0] is not None
                else torch.as_tensor(theta.pmra))
        rows = row_shape(ctx)
        const = lambda name, make: self.constant(name, make, like)  # noqa: E731
        zero = like.new_zeros(())
        masses = [theta.planets[p].mass * MJUP2MSOL if hasproperty(theta.planets[p], "mass")
                  else zero for p in pnames]

        def obs_value(key, default):
            if isinstance(theta_obs, Params) and key in theta_obs:
                return theta_obs[key]
            return like.new_tensor(default)

        sigma_att = obs_value("σ_att", 0.1)
        sigma_AL = obs_value("σ_AL", 0.1)
        sigma_calib = obs_value("σ_calib", 0.1)
        sigma_formal = torch.sqrt(sigma_att**2 + sigma_AL**2)

        gt = self.gaia_like.table
        absolute = isinstance(ctx.orbits[0], AbsoluteVisualOrbit) if n_p else False

        # ---- per-row epoch-selection weights (`g23h.jl:749-836`) --------
        pr, w_dr3, w_dr2, n_dr3_modeled = self._selection(theta_obs, like)
        use_marg = pr is not None

        # ---- photocentre perturbations over the FULL gaia table ---------
        d_a = d_d = like.new_zeros(self.n_gaia)
        for i in range(n_p):
            sol_g = take_epochs(ctx.solutions[i], ctx.epoch_start + self.n_hip, self.n_gaia)
            da, dd = skypath_perturbations_linear(
                sol_g, ctx.orbits[i], masses[i],
                self._fluxratio(theta_obs, "fluxratio", i, rows, like))
            active = torch.where(torch.as_tensor(masses[i]) != 0, 1.0, 0.0).to(like)[..., None]
            d_a = d_a + active * da
            d_d = d_d + active * dd

        cos_g = const("cosphi_gaia", lambda: gt["cosphi"])
        sin_g = const("sinphi_gaia", lambda: gt["sinphi"])
        if not use_marg:
            # the release windows' scans alone: weight 1 on them, 0 elsewhere
            w_dr3, w_dr2 = (np.isin(np.arange(self.n_gaia), sel).astype(float)
                            for sel in (self._dr3_sel, self._dr2_sel))

        # ---- DR3 window -------------------------------------------------
        # sigma_formal is one value per row: it cancels in the solve and
        # enters chi2 only (the JAX package's scalar sigma)
        (da3, dd3, dpmra3, dpmdec3, _), chi2_dr3 = self._fit(
            "A5_dr3_full", self.A5_dr3_full, w_dr3, d_a, d_d, cos_g, sin_g, like)
        chi2_dr3 = chi2_dr3 / (sigma_formal * sigma_formal)
        if n_p:
            prop = self._propagate_astrom(ctx.orbits[0], theta, like)
        else:
            prop = [(zero, zero, theta.pmra, theta.pmdec)] * len(self._release_epochs())
        ra30, dec30, pmra30, pmdec30 = prop[0]
        mu_dr3 = [pmra30 + dpmra3, pmdec30 + dpmdec3]

        # ---- DR2 window -------------------------------------------------
        (da2, dd2, dpmra2, dpmdec2, _), _ = self._fit(
            "A5_dr2_full", self.A5_dr2_full, w_dr2, d_a, d_d, cos_g, sin_g, like)
        ra20, dec20, pmra20, pmdec20 = prop[1]
        mu_dr2 = [pmra20 + dpmra2, pmdec20 + dpmdec2]

        # ---- Hipparcos --------------------------------------------------
        sigma_infl_hip = None
        iad_resid = None
        if self.has_hip:
            ht = self.hip_like.table
            n_hip = self.n_hip
            sols_h = [take_epochs(s, ctx.epoch_start, n_hip) for s in ctx.solutions]
            frh = [torch.where(torch.as_tensor(masses[i]) != 0,
                               self._fluxratio(theta_obs, "fluxratio_hip", i, rows, like), 0.0)
                   for i in range(n_p)]
            cphi = const("cosphi_hip", lambda: ht["cosphi"])
            sphi = const("sinphi_hip", lambda: ht["sinphi"])
            d_ah, d_dh, sigma_infl_hip = hippacentre_combined(cphi, sphi, sols_h, masses, frh)
            resid_term = const("res_hip", lambda: ht["res"]) if self.include_iad else 0.0
            # the per-scan sigma weights the solve: weights 1 / sres^2
            (dah, ddh, dpmrah, dpmdech, _), _ = self._fit(
                "A5_hip", self.hip_like.A_prepared_5, 1.0 / np.asarray(ht["sres"]) ** 2,
                d_ah, d_dh, cphi, sphi, like, residuals=resid_term)
            # BINARYS-predicted PM bias magnitude for the epistemic
            # catalog-covariance inflation (`g23h.jl:2189`)
            hip_bias_pm_sq = dpmrah**2 + dpmdech**2
            rah0, dech0, pmrah0, pmdech0 = prop[2]
            mu_h = [pmrah0 + dpmrah, pmdech0 + dpmdech]

            # HG channel
            dt_ra_hg = cat["epoch_ra_dr3_mjd"] - _jyear_to_mjd(cat["epoch_ra_hip"])
            dt_dec_hg = cat["epoch_dec_dr3_mjd"] - _jyear_to_mjd(cat["epoch_dec_hip"])
            if absolute:
                d_ra_prop = (ra30 - rah0) * _DEG2MAS * torch.cos(torch.deg2rad((dec30 + dech0) / 2))
                d_dec_prop = (dec30 - dech0) * _DEG2MAS
                pmra_hg = (da3 - dah + d_ra_prop) / dt_ra_hg * JULIAN_YEAR_DAYS
                pmdec_hg = (dd3 - ddh + d_dec_prop) / dt_dec_hg * JULIAN_YEAR_DAYS
            else:
                pmra_hg = (da3 - dah) / dt_ra_hg * JULIAN_YEAR_DAYS + theta.pmra
                pmdec_hg = (dd3 - ddh) / dt_dec_hg * JULIAN_YEAR_DAYS + theta.pmdec
            mu_hg = [pmra_hg, pmdec_hg]

            # IAD residual channel (offset + trend nuisances,
            # `g23h.jl:2222-2280`)
            if self.include_iad:
                iad_dra = obs_value("iad_Δra", 0.0)[..., None]
                iad_ddec = obs_value("iad_Δdec", 0.0)[..., None]
                iad_pmra = obs_value("iad_pmra", 0.0)[..., None]
                iad_pmdec = obs_value("iad_pmdec", 0.0)[..., None]
                plx_ep = (self.hip_like.hip_sol["plx"] + obs_value("iad_Δplx", 0.0))[..., None]
                dt_yr = const("iad_dt_yr",
                              lambda: (ht["epoch"] - HIPPARCOS_EPOCH_MJD) / JULIAN_YEAR_DAYS)
                a_off = (iad_dra - dah[..., None]) + dt_yr * (iad_pmra - dpmrah[..., None]) + d_ah
                d_off = (iad_ddec - ddh[..., None]) + dt_yr * (iad_pmdec - dpmdech[..., None]) + d_dh
                proj_model = (a_off * cphi + d_off * sphi
                              + plx_ep * const("parf_hip", lambda: ht["parallaxFactorAlongScan"]))
                iad_resid = torch.abs(const("proj_meas_hip", lambda: ht["proj_meas_alongscan"])
                                      - proj_model)
        else:
            mu_h = [zero, zero]
            mu_hg = [zero, zero]
            hip_bias_pm_sq = zero

        # ---- DR3-DR2 ----------------------------------------------------
        dt_ra_32 = cat["epoch_ra_dr3_mjd"] - cat["epoch_ra_dr2_mjd"]
        dt_dec_32 = cat["epoch_dec_dr3_mjd"] - cat["epoch_dec_dr2_mjd"]
        if absolute:
            d_ra_prop = (ra30 - ra20) * _DEG2MAS * torch.cos(torch.deg2rad((dec30 + dec20) / 2))
            d_dec_prop = (dec30 - dec20) * _DEG2MAS
            pmra_dr32 = (da3 - da2 + d_ra_prop) / dt_ra_32 * JULIAN_YEAR_DAYS
            pmdec_dr32 = (dd3 - dd2 + d_dec_prop) / dt_dec_32 * JULIAN_YEAR_DAYS
        else:
            pmra_dr32 = (da3 - da2) / dt_ra_32 * JULIAN_YEAR_DAYS + theta.pmra
            pmdec_dr32 = (dd3 - dd2) / dt_dec_32 * JULIAN_YEAR_DAYS + theta.pmdec
        mu_dr32 = [pmra_dr32, pmdec_dr32]

        # ---- UEVA (`g23h.jl:2344-2440`) --------------------------------
        N = cat["astrometric_n_good_obs_al_dr3"]
        N_FoV = cat["astrometric_matched_transits_dr3"]
        N_AL = N / N_FoV
        dof = self.gaia_n_dof
        if self.ueva_mode == "EAN":
            UEVA_gaia = cat["astrometric_excess_noise_dr3"] ** 2 + sigma_att**2 + sigma_AL**2
        elif self.ueva_mode == "RUWE":
            ruwe = cat["ruwe_dr3"]
            u0 = 1.0 / ruwe * math.sqrt(cat["astrometric_chi2_al_dr3"] / (N - dof))
            UEVA_gaia = (ruwe * u0) ** 2 * sigma_formal**2
        else:
            UEVA_gaia = sigma_formal**2

        mu_single = (N_AL / (N - dof)) * ((N_FoV - dof) * sigma_calib**2 + N_FoV * sigma_AL**2)
        sigma_single = torch.sqrt(
            2 * N_AL / (N - dof) ** 2
            * (
                N_AL * (N_FoV - dof) * sigma_calib**4
                + N_FoV * sigma_AL**4
                + 2 * N_FoV * sigma_AL**2 * sigma_calib**2
            )
        )
        mu_1_3 = UEVA_gaia ** (1.0 / 3.0)
        UEVA_unc = sigma_single * mu_single ** (-2.0 / 3.0) / 3.0

        chi2_scaled = chi2_dr3 * N_AL * (N_FoV / n_dr3_modeled)
        UEVA_model_1 = chi2_scaled * sigma_formal**2 / (N_AL * N_FoV - dof)
        # the argument is positive (chi2 >= 0, mu_single > 0): its cube
        # root is a power, as torch has no cbrt
        UEVA_model = (UEVA_model_1 + mu_single) ** (1.0 / 3.0)

        if self.ueva_mode == "none":
            deflation = like.new_ones(())
        else:
            deflation = torch.clamp(torch.sqrt(mu_single / UEVA_gaia), max=1.0)

        return {
            "mu_h": mu_h,
            "mu_hg": mu_hg,
            "mu_dr2": mu_dr2,
            "mu_dr32": mu_dr32,
            "mu_dr3": mu_dr3,
            "UEVA_model": UEVA_model,
            "UEVA_unc": UEVA_unc,
            "mu_1_3": mu_1_3,
            "deflation": deflation,
            "sigma_infl_hip": sigma_infl_hip,
            "iad_resid": iad_resid,
            "sigma_att": sigma_att,
            "sigma_AL": sigma_AL,
            "absolute": absolute,
            "hip_bias_pm_sq": hip_bias_pm_sq,
            "priorities": pr,
            "w_dr3": w_dr3,
            "n_astro_sel": n_dr3_modeled,
            "like": like,
        }

    # ------------------------------------------------------------------
    def _block(self, prefix):
        """The catalog's 2x2 covariance block of one channel pair, as the
        four entries (s1^2, rho s1 s2, rho s1 s2, s2^2)."""
        cat = self.catalog
        s1 = cat[f"pmra_{prefix}_error"]
        s2 = cat[f"pmdec_{prefix}_error"]
        rho = cat[f"pmra_pmdec_{prefix}"]
        return s1**2, rho * s1 * s2, rho * s1 * s2, s2**2

    def _rv_ln_like(self, ctx, sim):
        """The Gaia RV-variability channel (`g23h.jl:1348-1388`): the RV
        model at the Gaia scan epochs, its sample variance over each row's
        RV transits, and the non-central chi^2 of the catalog scatter."""
        cat = self.catalog
        like = sim["like"]
        eps_cat = cat["radial_velocity_error"]
        N_rv = int(cat.get("rv_nb_transits", 8))
        sigma_rv = ctx.theta_obs["σ_rv_per_transit"]
        rv_model = like.new_zeros(self.n_gaia)
        for i, p in enumerate(ctx.theta_system.planets.keys()):
            theta_p = ctx.theta_system.planets[p]
            if not hasproperty(theta_p, "mass"):
                continue
            sol_g = take_epochs(ctx.solutions[i], ctx.epoch_start + self.n_hip, self.n_gaia)
            rv_model = rv_model + radvel(sol_g, theta_p.mass * MJUP2MSOL) / 1e3
        if sim["priorities"] is not None:
            # transits_rv = top-n_rv priorities within the DR3 selection
            # (`g23h.jl:879-897`), as a weight mask per row
            frozen = self._frozen_selection()
            if frozen is not None:
                w_rv = self.constant("w_rv_frozen", lambda: frozen[3], like)
            else:
                w_rv = _rv_weights(sim["priorities"], sim["w_dr3"], N_rv, sim["n_astro_sel"])
            n_eff = torch.clamp(torch.sum(w_rv, dim=-1), min=2.0)
            mean_rv = torch.sum(w_rv * rv_model, dim=-1) / n_eff
            sample_var = (torch.sum(w_rv * (rv_model - mean_rv[..., None]) ** 2, dim=-1)
                          / (n_eff - 1.0))
        else:
            rv_sel = rv_model[..., : min(N_rv, self.n_gaia)]
            sample_var = torch.var(rv_sel, dim=-1, correction=1)
        s_cat_sq = (2 * N_rv / math.pi) * (eps_cat**2 - 0.113**2)
        ncp = (N_rv - 1) * sample_var / sigma_rv**2
        xi_sq = (N_rv - 1) * s_cat_sq / sigma_rv**2
        ll_rv = noncentral_chi2_logpdf(xi_sq, N_rv - 1, ncp) - 2 * torch.log(sigma_rv)
        return torch.where(torch.isfinite(ll_rv), ll_rv, -torch.inf)

    def ln_like(self, ctx: SystemObservationContext):
        cat = self.catalog
        theta_obs = ctx.theta_obs
        sim = self.simulate(ctx)
        ll = 0.0

        # UEVA change-of-variables Jacobian (`g23h.jl:1271-1296`)
        if "ueva_dr3" in self.kinds:
            if self.ueva_mode == "EAN" and cat.get("astrometric_excess_noise_dr3", 0.0) > 0:
                ll = ll - 2 * torch.log(sim["mu_1_3"])
            elif self.ueva_mode == "RUWE":
                ll = ll + (1.0 / 3.0) * torch.log(sim["sigma_att"] ** 2 + sim["sigma_AL"] ** 2)

        # IAD residual channel (`g23h.jl:1301-1326`)
        if self.include_iad and sim["iad_resid"] is not None:
            ht = self.hip_like.table
            like = sim["like"]
            jit = (theta_obs["hip_iad_jitter"] if isinstance(theta_obs, Params)
                   and "hip_iad_jitter" in theta_obs else like.new_zeros(()))
            s = self.constant("sres_renorm_hip", lambda: ht["sres_renorm"], like) \
                * sim["sigma_infl_hip"]
            var = s * s + (jit * jit)[..., None]
            lp = -0.5 * (sim["iad_resid"] ** 2 / var + torch.log(var)) - 0.5 * _LOG_2PI
            keep = self.constant("keep_hip", lambda: ~ht["reject"], like) > 0
            ll = ll + torch.sum(torch.where(keep, lp, 0.0), dim=-1)

        # RV-variability channel; needs the RV model at the gaia scan epochs
        if self.include_rv and isinstance(theta_obs, Params) and "σ_rv_per_transit" in theta_obs:
            ll = ll + self._rv_ln_like(ctx, sim)

        mv, dv, Ssel = self._assemble(ctx, sim)
        L, bad = _gated_cholesky(Ssel)
        alpha = torch.linalg.solve_triangular(L, (mv - dv)[..., None], upper=False)[..., 0]
        ll_cat = (
            -0.5 * torch.sum(alpha**2, dim=-1)
            - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
            - 0.5 * mv.shape[-1] * _LOG_2PI
        )
        # a row whose covariance is not positive definite (the JAX package's
        # Cholesky gives NaN there) is -inf, with a zero gradient row
        ll_cat = torch.where(bad | ~torch.isfinite(ll_cat), -torch.inf, ll_cat)
        return ll + ll_cat

    def _covariance_terms(self):
        """The joint channel covariance as S = C0 + sum_j c_j M_j
        (`g23h.jl:1390-1568`): C0 and the M_j (11 x 11, numpy, from the
        catalog), and the names of the per-row coefficients c_j. Block
        diagonal: Hipparcos (BINARYS inflation x its catalog block, plus the
        epistemic bias eps^2 |dpm_h|^2 I, eps = 0.3, `g23h.jl:1466-1518`),
        HG, DR2, the DR3-DR2 block with the exact deflation-adjusted
        central-position propagation when the catalog carries the
        central-epoch position covariances (B32 + Tr dS Tr^T, dS = (d^2 - 1)
        S_pos3 - (d - 1)(S_cross + S_cross^T), `g23h.jl:1390-1445`; else d^2
        B32), DR3 deflated (d^2 B3), UEVA; and the DR2 x DR3 cross block
        K = rho sqrt(S_dr2) sqrt(d^2 S_dr3)^T = d K0 (`g23h.jl:1561`)."""
        cat = self.catalog
        C0 = np.zeros((11, 11))
        terms = []

        def block(i0, entries):
            m = np.zeros((11, 11))
            m[i0:i0 + 2, i0:i0 + 2] = np.reshape(entries, (2, 2))
            return m

        if self.has_hip:
            terms += [("infl", block(0, self._block("hip"))), ("bias", block(0, (1, 0, 0, 1)))]
            C0 += block(2, self._block("hg"))
        else:
            C0 += block(0, (1, 0, 0, 1)) + block(2, (1, 0, 0, 1))
        C0 += block(4, self._block("dr2"))
        rho_23 = float(cat.get("rho_dr2_dr3", 0.0))
        central_keys = (
            "ra_error_central_dr3", "dec_error_central_dr3",
            "ra_dec_corr_central_dr3", "ra_error_central_dr2",
            "dec_error_central_dr2", "ra_dec_corr_central_dr2",
        )
        if all(np.isfinite(cat.get(k, np.nan)) for k in central_keys):
            sr3, sd3 = cat["ra_error_central_dr3"], cat["dec_error_central_dr3"]
            r3 = cat["ra_dec_corr_central_dr3"]
            sr2, sd2 = cat["ra_error_central_dr2"], cat["dec_error_central_dr2"]
            r2 = cat["ra_dec_corr_central_dr2"]
            S_pos3 = np.array([[sr3**2, r3 * sr3 * sd3], [r3 * sr3 * sd3, sd3**2]])
            S_cross = rho_23 * np.array([[sr3 * sr2, r3 * sr3 * sd2], [r2 * sd3 * sr2, sd3 * sd2]])
            # Tr = diag(1 / dt_ra, 1 / dt_dec) [1/yr]
            Tr = np.diag([JULIAN_YEAR_DAYS / (cat["epoch_ra_dr3_mjd"] - cat["epoch_ra_dr2_mjd"]),
                          JULIAN_YEAR_DAYS / (cat["epoch_dec_dr3_mjd"] - cat["epoch_dec_dr2_mjd"])])
            C0 += block(6, self._block("dr32"))
            terms += [("d2m1", block(6, Tr @ S_pos3 @ Tr.T)),
                      ("dm1", block(6, -(Tr @ (S_cross + S_cross.T) @ Tr.T)))]
        else:
            terms += [("d2", block(6, self._block("dr32")))]
        ueva = np.zeros((11, 11))
        ueva[10, 10] = 1.0
        terms += [("d2", block(8, self._block("dr3"))), ("ueva", ueva)]
        if rho_23 != 0.0:
            K0 = rho_23 * (_sqrt2x2(np.reshape(self._block("dr2"), (2, 2)))
                           @ _sqrt2x2(np.reshape(self._block("dr3"), (2, 2))).T)
            m = np.zeros((11, 11))
            m[4:6, 8:10] = K0
            m[8:10, 4:6] = K0.T
            terms += [("d", m)]
        idx = [_CHANNELS.index(k) for k in self.kinds]
        sel = np.ix_(idx, idx)
        return C0[sel], np.stack([m[sel] for _, m in terms]), [name for name, _ in terms]

    def _assemble(self, ctx, sim):
        """Selected channel model/data vectors (R..., k) and joint covariance
        (R..., k, k), shared by ln_like, debug_pulls, and the correlated
        generator: the covariance is C0 plus one product of each row's
        coefficients with the constant M_j (`_covariance_terms`)."""
        cat = self.catalog
        like = sim["like"]
        mu_h, mu_hg = list(sim["mu_h"]), list(sim["mu_hg"])
        if sim["absolute"] and self.has_hip:
            nl = (cat.get("nonlinear_dpmra", 0.0), cat.get("nonlinear_dpmdec", 0.0))
            mu_hg = [m + c for m, c in zip(mu_hg, nl)]
            mu_h = [m + 2 * c for m, c in zip(mu_h, nl)]
        model = mu_h + mu_hg + list(sim["mu_dr2"]) + list(sim["mu_dr32"]) + list(sim["mu_dr3"]) \
            + [sim["UEVA_model"]]
        idx = [_CHANNELS.index(k) for k in self.kinds]
        mv = torch.stack(torch.broadcast_tensors(*(torch.as_tensor(model[i]).to(like)
                                                   for i in idx)), dim=-1)

        def data_vector():
            if self.has_hip:
                data = [cat["pmra_hip"], cat["pmdec_hip"], cat["pmra_hg"], cat["pmdec_hg"]]
            else:
                data = [0.0, 0.0, 0.0, 0.0]
            data += [cat["pmra_dr2"], cat["pmdec_dr2"], cat["pmra_dr32"], cat["pmdec_dr32"],
                     cat["pmra_dr3"], cat["pmdec_dr3"], 0.0]
            return np.array(data)[idx]

        dv = self.constant("data_vector", data_vector, like)
        if "ueva_dr3" in self.kinds:
            # the UEVA channel's datum is the catalog UEVA's cube root
            ueva = self.constant("ueva_onehot", lambda: np.array(self.kinds) == "ueva_dr3", like)
            dv = dv + ueva * sim["mu_1_3"][..., None]

        d = sim["deflation"]
        coeff = {"d": d, "d2": d**2, "d2m1": d**2 - 1, "dm1": d - 1,
                 "ueva": sim["UEVA_unc"] ** 2}
        if self.has_hip:
            coeff["bias"] = 0.3**2 * sim["hip_bias_pm_sq"]
            coeff["infl"] = like.new_ones(())
            if sim["sigma_infl_hip"] is not None:
                keep = self.constant("keep_hip", lambda: ~self.hip_like.table["reject"], like) > 0
                n_used = max(float(keep.sum()), 1.0)
                coeff["infl"] = torch.sum(torch.where(keep, sim["sigma_infl_hip"] ** 2, 0.0),
                                          dim=-1) / n_used
        if "covariance" not in self._columns:
            self._columns["covariance"] = self._covariance_terms()
        C0, terms, names = self._columns["covariance"]
        terms = self.constant("covariance_terms", lambda: terms, like)
        c = torch.stack(torch.broadcast_tensors(*(torch.as_tensor(coeff[n]).to(like)
                                                  for n in names)), dim=-1)
        k = len(idx)
        S = (self.constant("covariance_c0", lambda: C0, like)
             + (c @ terms.reshape(len(names), k * k)).reshape(c.shape[:-1] + (k, k)))
        rows = torch.broadcast_shapes(mv.shape[:-1], dv.shape[:-1], S.shape[:-2])
        return mv.expand(rows + (k,)), dv.expand(rows + (k,)), S.expand(rows + (k, k))

    def debug_pulls(self, ctx):
        """Per-channel pulls (catalog - model)/sigma and whitened pulls
        L^-1 (catalog - model), per row (`_G23H_DEBUG_PULLS`,
        `g23h.jl:96-100,1570-1586`). At truth, over noise realizations of
        the catalog, both are ~ N(0, 1)."""
        sim = self.simulate(ctx)
        mv, dv, Ssel = self._assemble(ctx, sim)
        L = torch.linalg.cholesky(Ssel)
        return {
            "kinds": list(self.kinds),
            "pull": (dv - mv) / torch.sqrt(torch.diagonal(Ssel, dim1=-2, dim2=-1)),
            "whitened": torch.linalg.solve_triangular(L, (dv - mv)[..., None], upper=False)[..., 0],
        }

    def pointwise_ln_like(self, ctx):
        return self.ln_like(ctx).unsqueeze(-1)

    def likeobj_from_epoch_subset(self, idx):
        new = copy.copy(self)
        new._columns = {}
        new.kinds = [self.kinds[i] for i in np.atleast_1d(idx)]
        return new

    def generate_from_params(self, ctx, rng, add_noise=False):
        """Synthesize catalog channel values from the model at one parameter
        set (`ctx` of a single draw; `g23h.jl:2582-3002`, channel-value
        subset). With add_noise the PM channels are drawn JOINTLY from the
        model's selected channel covariance (including the DR2/DR3 cross
        block and deflation), so that whitened pulls at truth are exactly
        ~ N(0, I)."""
        sim = self.simulate(ctx)
        mv, _, Ssel = self._assemble(ctx, sim)
        mv = mv.detach().cpu().double().numpy()
        Ssel = Ssel.detach().cpu().double().numpy()
        pm_rows = [i for i, k in enumerate(self.kinds) if k != "ueva_dr3"]
        draw = mv.copy()
        if add_noise and pm_rows:
            Spm = Ssel[np.ix_(pm_rows, pm_rows)]
            Lpm = np.linalg.cholesky(Spm)
            draw[pm_rows] = mv[pm_rows] + Lpm @ rng.standard_normal(len(pm_rows))
        cat = dict(self.catalog)
        for i, k in enumerate(self.kinds):
            if k == "ueva_dr3":
                continue
            cat[f"pm{k}"] = float(draw[i])  # kinds are 'ra_dr3' etc.
        new = copy.copy(self)
        new._columns = {}
        new.catalog = cat
        return new


G23HLikelihood = G23HObs
