"""G23H catalog ingestion (Arrow/feather + DR2-transit sidecar).

A copy of `octofitter_tpu/astrom/g23h_catalog.py` (numpy only; pyarrow
and pandas are imported only when a file of theirs is read). Host-side
equivalent of the reference's catalog loading and merging
(`src/likelihoods/g23h.jl:146-241`): the production
G23H catalog ships as a large Arrow/feather table keyed by `gaia_id` /
`hip_id`, with the Gaia DR2 matched-transit counts in a separate
sidecar table. This module selects one source's row, merges the
sidecar, and returns the plain dict `G23HObs(catalog=...)` consumes.

Zero-egress environments point `catalog` at a local file (the reference
keeps the same local-path escape hatch, `g23h.jl:13-14`).
"""

from __future__ import annotations

import numpy as np


def _load_table(path_or_table) -> dict:
    """Feather/Arrow/CSV path or mapping -> dict of numpy columns."""
    if isinstance(path_or_table, dict):
        return {k: np.asarray(v) for k, v in path_or_table.items()}
    path = str(path_or_table)
    if path.endswith((".feather", ".arrow", ".ipc")):
        import pyarrow.feather as feather

        tbl = feather.read_table(path)
        return {
            name: tbl.column(name).to_numpy(zero_copy_only=False)
            for name in tbl.column_names
        }
    if path.endswith(".csv"):
        import pandas as pd

        df = pd.read_csv(path)
        return {c: df[c].to_numpy() for c in df.columns}
    raise ValueError(
        f"unsupported catalog format {path!r} (feather/arrow/ipc/csv)"
    )


def _find_row(table: dict, gaia_id=None, hip_id=None) -> int:
    # the production catalog names the DR3 key `gaia_source_id`
    # (`g23h.jl:274` findfirst on catalog.gaia_source_id); accept the
    # short alias used by in-memory fixtures too
    if gaia_id is not None:
        for key in ("gaia_source_id", "gaia_id"):
            if key in table:
                hits = np.nonzero(np.asarray(table[key]) == gaia_id)[0]
                if len(hits):
                    return int(hits[0])
    if hip_id is not None and "hip_id" in table:
        col = np.asarray(table["hip_id"])
        hits = np.nonzero(col == hip_id)[0]
        if len(hits):
            return int(hits[0])
    raise KeyError(
        f"source gaia_id={gaia_id} hip_id={hip_id} not found in catalog"
    )


def _derive_mjd_epochs(row: dict) -> None:
    """Add `epoch_*_mjd` columns from the catalog's Julian-year epochs
    (`g23h.jl:301-309`), which is the form `G23HObs` consumes."""
    from ..constants import J2000_MJD, JULIAN_YEAR_DAYS

    for axis in ("ra", "dec"):
        for dr in ("dr2", "dr3"):
            src, dst = f"epoch_{axis}_{dr}", f"epoch_{axis}_{dr}_mjd"
            if dst not in row and src in row:
                row[dst] = (row[src] - 2000.0) * JULIAN_YEAR_DAYS + J2000_MJD


def load_g23h_catalog_row(
    catalog,
    *,
    gaia_id=None,
    hip_id=None,
    dr2_transits_catalog=None,
) -> dict:
    """Select one source's G23H catalog row (+ DR2-transit sidecar).

    catalog: path to the G23H feather/arrow/csv catalog or an in-memory
    column mapping. dr2_transits_catalog: optional sidecar with
    `gaia_id` + `astrometric_matched_observations_dr2`
    (`g23h.jl:200-220` requires it for the DR2 epoch-selection model).
    Returns a plain dict of scalars, with missing/masked values dropped
    so `catalog.get(...)` fallbacks engage downstream.
    """
    table = _load_table(catalog)
    i = _find_row(table, gaia_id=gaia_id, hip_id=hip_id)
    row = {}
    for k, col in table.items():
        v = np.asarray(col)[i]
        # drop masked/NaN entries so downstream feature detection
        # (has_hip, has_rv, central-position covariance) works
        if v is None:
            continue
        if isinstance(v, (bytes, str)):
            row[k] = v.decode() if isinstance(v, bytes) else v
            continue
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            # Gaia source IDs exceed float64's 2^53 integer range
            row[k] = int(v)
            continue
        fv = float(v)
        if np.isnan(fv):
            continue
        row[k] = fv
    if gaia_id is not None:
        row.setdefault("gaia_id", gaia_id)
    if "gaia_source_id" in row:
        row.setdefault("gaia_id", row["gaia_source_id"])
    _derive_mjd_epochs(row)

    if dr2_transits_catalog is not None:
        sidecar = _load_table(dr2_transits_catalog)
        try:
            j = _find_row(sidecar, gaia_id=row.get("gaia_id", gaia_id))
            n = sidecar.get("astrometric_matched_observations_dr2")
            if n is not None and np.isfinite(float(np.asarray(n)[j])):
                row["astrometric_matched_observations_dr2"] = float(
                    np.asarray(n)[j]
                )
        except KeyError:
            pass  # no sidecar entry: downstream approximation engages
    return row
