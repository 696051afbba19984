"""Gaia scan-law ingestion.

Port of `octofitter_tpu/astrom/scanlaw.py` (numpy only; the GOST forecast
handling of the reference's `gaia-utils.jl:709-953`): load a GOST CSV (as
downloaded from https://gaia.esac.esa.int/gost/; a local file or table is
required, since nothing is fetched), derive scan-projection columns, and
filter known astrometric gaps. CSV files are read with the standard
library's `csv` module: the port depends on neither pandas nor the JAX
package's native reader.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..constants import jd2mjd

# Gaia data-release metadata (`gaia-utils.jl:18-34`)
META_GAIA_DR1 = dict(start_mjd=56863.43751, stop_mjd=57281.0, ref_epoch_mjd=57023.25)
META_GAIA_DR2 = dict(start_mjd=56863.43751, stop_mjd=57531.0, ref_epoch_mjd=57205.875)
META_GAIA_DR3 = dict(start_mjd=56863.43751, stop_mjd=58901.0, ref_epoch_mjd=57388.5)


def obmt2mjd(obmt):
    """On-Board Mission Time (revolutions) -> MJD
    (`gaia-utils.jl:59-68`)."""
    obmt = np.asarray(obmt, dtype=np.float64)
    tcbjy = 2015.0 + (obmt - 1717.6256) / 1461.0
    jd = 2457023.75 + (tcbjy - 2015.0) * 365.25
    return jd - 2400000.5


def tcb_at_gaia_2mjd(tcb_gaia):
    """Gaia TCB (JD - 2455197.5) -> MJD (`gaia-utils.jl:40`)."""
    return jd2mjd(np.asarray(tcb_gaia, dtype=np.float64) + 2455197.5)


# AGIS astrometric input spans (`gaia-utils.jl:85-96`)
GAIA_AGIS_SPAN_DR2 = dict(start_mjd=float(obmt2mjd(1192.13)), stop_mjd=float(obmt2mjd(3750.56)))
GAIA_AGIS_SPAN_DR3 = dict(start_mjd=float(obmt2mjd(1192.13)), stop_mjd=float(obmt2mjd(5230.09)))


def _float_column(values) -> np.ndarray:
    """One CSV column as float64: empty cells are NaN, and a column with a
    cell that is not a number (a name, a UTC time stamp) is all NaN, as a
    column of text is."""
    try:
        return np.asarray([float(v) if v.strip() else np.nan for v in values], dtype=np.float64)
    except ValueError:
        return np.full(len(values), np.nan)


def read_csv_columns(path) -> dict:
    """A CSV file with a header row as {stripped column name: float64
    column} (`_float_column`)."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    header = [c.strip() for c in rows[0]]
    body = [r for r in rows[1:] if r]
    return {name: _float_column([r[j] if j < len(r) else "" for r in body])
            for j, name in enumerate(header)}


def load_gost_csv(path_or_table) -> dict:
    """Load a GOST forecast CSV into a scan table dict with columns:
    epoch (MJD, barycentric), scanAngle_rad, cosphi, sinphi,
    parallaxFactorAlongScan (and AcrossScan when present).

    The scan-projection convention matches the reference
    (`gaia-utils.jl:915-916`): phi is measured such that
    cos(phi) = cos(pi/2 + scanAngle), sin(phi) = sin(pi/2 + scanAngle).
    """
    if isinstance(path_or_table, (str, os.PathLike)):
        cols_map = read_csv_columns(path_or_table)
    else:
        cols_map = {
            str(k).strip(): np.asarray(v, dtype=np.float64)
            for k, v in dict(path_or_table).items()
        }

    def col(*candidates):
        for c in candidates:
            if c in cols_map:
                return np.asarray(cols_map[c], dtype=np.float64)
        raise KeyError(
            f"GOST csv missing column; tried {candidates}: has {list(cols_map)}"
        )

    tcb = col(
        "ObservationTimeAtBarycentre[BarycentricJulianDateInTCB]",
        "ObservationTimeAtBarycentre_BarycentricJulianDateInTCB_",
    )
    epoch = jd2mjd(tcb)
    scan_angle = col("scanAngle[rad]", "scanAngle_rad", "scanAngle_rad_")
    parf_al = col("parallaxFactorAlongScan", "parallaxFactorAlongScan[rad]")
    table = {
        "epoch": epoch,
        "scanAngle_rad": scan_angle,
        "cosphi": np.cos(np.pi / 2 + scan_angle),
        "sinphi": np.sin(np.pi / 2 + scan_angle),
        "parallaxFactorAlongScan": parf_al,
    }
    if "parallaxFactorAcrossScan" in cols_map:
        table["parallaxFactorAcrossScan"] = col("parallaxFactorAcrossScan")
    order = np.argsort(epoch, kind="stable")
    return {k: v[order] for k, v in table.items()}


def scanlaw_from_angles(times_tcb, angles_deg) -> dict:
    """Scanning-law table from (times, angles) pairs, e.g. from the
    scanninglaw python package (`gaia-utils.jl:910-913`). Parallax
    factors must be added separately or via `add_parallax_factors`."""
    epoch = tcb_at_gaia_2mjd(np.asarray(times_tcb, dtype=np.float64))
    scan_angle = np.deg2rad(np.asarray(angles_deg, dtype=np.float64))
    return {
        "epoch": epoch,
        "scanAngle_rad": scan_angle,
        "cosphi": np.cos(np.pi / 2 + scan_angle),
        "sinphi": np.sin(np.pi / 2 + scan_angle),
    }


def add_parallax_factors(table: dict, ra_deg: float, dec_deg: float,
                         earth_table=None, observer="gaia") -> dict:
    """Compute along-scan parallax factors from the ephemeris for tables
    lacking them. Defaults to the Gaia-at-L2 observer; pass
    observer="earth" for strict reference parity."""
    from .ephemeris import geocentre_position_query

    pos = geocentre_position_query(table["epoch"], earth_table,
                                   observer=observer)
    a = np.deg2rad(ra_deg)
    d = np.deg2rad(dec_deg)
    dra = pos["x"] * np.sin(a) - pos["y"] * np.cos(a)
    ddec = (
        pos["x"] * np.cos(a) * np.sin(d)
        + pos["y"] * np.sin(a) * np.sin(d)
        - pos["z"] * np.cos(d)
    )
    out = dict(table)
    out["parallaxFactorAlongScan"] = dra * table["cosphi"] + ddec * table["sinphi"]
    return out


def filter_scan_gaps(table: dict, gaps=None, gap_files=()) -> dict:
    """Drop scans inside known Gaia astrometric gaps
    (`gaia-utils.jl:921-941`). `gaps` is a list of (start_mjd, stop_mjd)
    or None; `gap_files` are CSVs with `start`/`end` OBMT columns (the
    DPAC-published gap lists)."""
    intervals = list(gaps or [])
    for path in gap_files:
        cols = read_csv_columns(path)
        names = list(cols)
        start_col = "start" if "start" in cols else names[0]
        end_col = "end" if "end" in cols else names[1]
        intervals += list(zip(obmt2mjd(cols[start_col]), obmt2mjd(cols[end_col])))
    if not intervals:
        return table
    keep = np.ones(len(table["epoch"]), bool)
    for lo, hi in intervals:
        keep &= ~((table["epoch"] >= lo) & (table["epoch"] <= hi))
    return {k: np.asarray(v)[keep] for k, v in table.items()}


def filter_agis_span(table: dict, release: str = "dr3") -> dict:
    """Keep only scans within the release's AGIS input span."""
    span = GAIA_AGIS_SPAN_DR3 if release == "dr3" else GAIA_AGIS_SPAN_DR2
    keep = (table["epoch"] >= span["start_mjd"]) & (table["epoch"] <= span["stop_mjd"])
    return {k: np.asarray(v)[keep] for k, v in table.items()}
