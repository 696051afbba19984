"""OIFITS file ingestion for interferometric likelihoods.

A numpy copy of `octofitter_tpu/interferometry/oifits.py` (the
reference's OIFITS auto-extraction,
`OctofitterInterferometry.jl:32-118`) over the port's own FITS codec
(`io/fits.py`): reads the OI_WAVELENGTH, OI_VIS2 and OI_T3 binary tables,
converts (u, v) to inverse-wavelength units, clamps closure-phase errors
to >= 2 degrees where any is zero, applies an optional wavelength window,
and resolves the three baseline indices of every closure triangle
(`cp_indices`, reference `:314-341`). Runs on the host.
"""

from __future__ import annotations

import math
import warnings

import numpy as np

from ..io.fits import read_bintable


def cp_indices(vis2_index: np.ndarray, cp_index: np.ndarray):
    """Map each closure triangle to its three baseline rows
    (reference `cp_indices`, `OctofitterInterferometry.jl:314-341`).

    vis2_index: (n_vis2, 2) station pairs; cp_index: (n_cp, 3) station
    triples. A triangle's phase is cp1 + cp2 - cp3. Matches are
    restricted to the same exposure block (same floor(row/block) for
    blocks of nb baselines / ncp triangles).
    Returns 0-based (i1, i2, i3) arrays.
    """
    vis2_index = np.asarray(vis2_index, int)
    cp_index = np.asarray(cp_index, int)
    n_cp = cp_index.shape[0]
    i1 = np.zeros(n_cp, int)
    i2 = np.zeros(n_cp, int)
    i3 = np.zeros(n_cp, int)
    nh = int(vis2_index.max())
    nb = nh * (nh - 1) // 2
    ncp = nh * (nh - 1) * (nh - 2) // 6
    for i in range(n_cp):
        for j in range(vis2_index.shape[0]):
            same_block = (j // nb) == (i // ncp)
            if not same_block:
                continue
            if cp_index[i, 0] == vis2_index[j, 0] and cp_index[i, 1] == vis2_index[j, 1]:
                i1[i] = j
            if cp_index[i, 1] == vis2_index[j, 0] and cp_index[i, 2] == vis2_index[j, 1]:
                i2[i] = j
            if cp_index[i, 0] == vis2_index[j, 0] and cp_index[i, 2] == vis2_index[j, 1]:
                i3[i] = j
    return i1, i2, i3


def load_oifits(
    filename: str,
    epoch: float | None = None,
    wavelength_min_meters: float = -math.inf,
    wavelength_max_meters: float = math.inf,
    use_vis2: bool = True,
    **extra,
):
    """Read one OIFITS file into an InterferometryObs row dict.

    epoch: MJD; defaults to the mean OI_VIS2 MJD column.
    Returns keys epoch, u, v ((n_vis2, n_wave) in 1/wavelength),
    cps_data, dcps ((n_cp, n_wave), degrees, errors clamped >= 2 deg),
    vis2_data, dvis2, index_cps1/2/3, use_vis2, eff_wave.
    """
    wavs = read_bintable(filename, extname="OI_WAVELENGTH")
    vis2s = read_bintable(filename, extname="OI_VIS2")
    cps = read_bintable(filename, extname="OI_T3")

    eff_wave = np.atleast_1d(np.asarray(wavs["EFF_WAVE"], float).reshape(-1))
    n_wave = len(eff_wave)

    def _mat(col):
        a = np.asarray(col, float)
        if a.ndim == 1:
            a = a[:, None]
        return a

    vis2 = _mat(vis2s["VIS2DATA"])
    vis2_err = _mat(vis2s["VIS2ERR"])
    ut = np.asarray(vis2s["UCOORD"], float).reshape(-1)
    vt = np.asarray(vis2s["VCOORD"], float).reshape(-1)
    vis2_index = np.asarray(vis2s["STA_INDEX"], int).reshape(len(ut), -1)
    cp = _mat(cps["T3PHI"])
    cp_err = _mat(cps["T3PHIERR"])
    cp_index = np.asarray(cps["STA_INDEX"], int).reshape(cp.shape[0], -1)

    if vis2.shape[1] != n_wave or cp.shape[1] != n_wave:
        raise ValueError(
            f"{filename}: VIS2/T3 wavelength axes "
            f"({vis2.shape[1]}/{cp.shape[1]}) do not match OI_WAVELENGTH "
            f"({n_wave})"
        )

    # (u, v) in units of inverse wavelength (reference `:85-87`)
    u = ut[:, None] / eff_wave[None, :]
    v = vt[:, None] / eff_wave[None, :]

    # clamp ONLY when zero errors are present (reference
    # `OctofitterInterferometry.jl:88-92`)
    if np.any(cp_err == 0):
        warnings.warn(
            "Some closure phase errors are exactly 0; clamping "
            "uncertainties to at least 2 degrees (provide a "
            "sigma_cp_jitter variable when sampling to calibrate)."
        )
        cp_err = np.maximum(2.0, cp_err)

    mask = (wavelength_min_meters < eff_wave) & (eff_wave < wavelength_max_meters)
    if not mask.any():
        raise ValueError(f"{filename}: wavelength window removes every channel")

    i1, i2, i3 = cp_indices(vis2_index, cp_index)

    if epoch is None:
        mjd = np.asarray(vis2s.get("MJD", np.zeros(len(ut))), float)
        epoch = float(mjd.mean())

    return dict(
        epoch=float(epoch),
        u=u[:, mask],
        v=v[:, mask],
        eff_wave=eff_wave[mask],
        cps_data=cp[:, mask],
        dcps=cp_err[:, mask],
        vis2_data=vis2[:, mask],
        dvis2=vis2_err[:, mask],
        index_cps1=i1,
        index_cps2=i2,
        index_cps3=i3,
        use_vis2=bool(use_vis2),
        **extra,
    )
