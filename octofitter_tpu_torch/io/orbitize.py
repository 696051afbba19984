"""Orbitize! posterior interoperability.

A copy of `octofitter_tpu/io/orbitize.py` (numpy and `h5py`), the
equivalent of `src/io-orbitize.jl` (`loadhdf5`
`:99-228`, `savehdf5` `:239-281`): read and write Orbitize!-format HDF5
posteriors (as used by whereistheplanet.com). Octofitter and Orbitize
share the same orbital conventions, so this is a column rename plus the
tau <-> tp conversion at `_TAU_REF_EPOCH`. `h5py` is imported inside the
functions that read or write a file, so the package imports without it.
"""

from __future__ import annotations

import numpy as np

from ..chains import Chains
from ..constants import KEPLER_YEAR_DAYS

_TAU_REF_EPOCH = 58849.0

_RENAMES = {}
for i, pk in enumerate(["b", "c", "d", "e"], start=1):
    _RENAMES.update(
        {
            f"sma{i}": f"{pk}_a",
            f"ecc{i}": f"{pk}_e",
            f"inc{i}": f"{pk}_i",
            f"aop{i}": f"{pk}_omega",
            f"pan{i}": f"{pk}_Omega",
            f"tau{i}": f"{pk}_tau",
            f"m{i}": f"{pk}_mass",
        }
    )
_RENAMES.update({"m0": "M_pri", "mtot": "M"})


def loadhdf5(fname, numchains=1, colnames=None) -> Chains:
    """Load an Orbitize! posterior HDF5 into a Chains object."""
    import h5py

    with h5py.File(fname, "r") as f:
        arr = np.asarray(f["post"])
        if arr.shape[0] < arr.shape[1]:
            arr = arr.T  # rows = samples
        if colnames is None:
            for key in ("parameter_labels", "col_names"):
                if key in f.attrs:
                    colnames = [
                        c.decode() if isinstance(c, bytes) else str(c)
                        for c in f.attrs[key]
                    ]
                    break
                if key in f:
                    colnames = [
                        c.decode() if isinstance(c, bytes) else str(c)
                        for c in np.asarray(f[key])
                    ]
                    break
        if colnames is None:
            colnames = ["sma1", "ecc1", "inc1", "aop1", "pan1", "tau1", "plx", "M"]
        tau_ref = float(f.attrs.get("tau_ref_epoch", _TAU_REF_EPOCH))

    # orbitize single-planet files sometimes use unnumbered names
    colnames = [
        {"sma": "sma1", "ecc": "ecc1", "inc": "inc1", "aop": "aop1",
         "pan": "pan1", "tau": "tau1"}.get(c, c)
        for c in colnames
    ]
    names = [_RENAMES.get(c, c) for c in colnames]

    n = arr.shape[0]
    if numchains > 1:
        per = n // numchains
        arr = arr[: per * numchains].reshape(numchains, per, -1)
    else:
        arr = arr[None, :, :]
    data = {name: arr[:, :, j] for j, name in enumerate(names)}

    # derive tp from tau where possible: tp = tau*P + tau_ref (mod P)
    for pk in ("b", "c", "d", "e"):
        if f"{pk}_tau" in data and f"{pk}_a" in data and "M" in data:
            P = np.sqrt(data[f"{pk}_a"] ** 3 / data["M"]) * KEPLER_YEAR_DAYS
            data[f"{pk}_tp"] = data[f"{pk}_tau"] * P + tau_ref
    return Chains(data, {}, {"sampler": "orbitize", "tau_ref_epoch": tau_ref})


def savehdf5(fname, model, chain: Chains, planet_key=None):
    """Save a single-planet chain in Orbitize!/whereistheplanet format."""
    import h5py

    if planet_key is None:
        planet_key = model.system.planets[0].name
    tp = chain.flat(f"{planet_key}_tp")
    a = chain.flat(f"{planet_key}_a")
    M = chain.flat("M")
    period_days = np.sqrt(a**3 / M) * KEPLER_YEAR_DAYS
    tau = np.mod((tp - _TAU_REF_EPOCH) / period_days, 1.0)
    dat = np.stack(
        [
            a,
            chain.flat(f"{planet_key}_e"),
            chain.flat(f"{planet_key}_i"),
            chain.flat(f"{planet_key}_omega"),
            chain.flat(f"{planet_key}_Omega"),
            tau,
            chain.flat("plx"),
            M,
        ],
        axis=0,
    )
    with h5py.File(fname, "w") as f:
        f["col_names"] = np.array(
            ["sma", "ecc", "inc", "aop", "pan", "tau", "plx", "mtot"], dtype="S"
        )
        f.attrs["tau_ref_epoch"] = _TAU_REF_EPOCH
        f.attrs["sampler_name"] = "octofitter_tpu_torch"
        f.create_dataset("post", data=dat.astype(np.float32))


def Whereistheplanet_search(target, catalog_dir=None):
    """Locate a whereistheplanet.com posterior HDF5 by target name
    (`io-orbitize.jl:21-49`). `catalog_dir` is a local mirror of the
    whereistheplanet data; defaults to the registered
    `whereistheplanet` dataset (stage it under the data root, e.g. an
    unpacked GitHub archive). Both flat `{target}.h5` mirrors and the
    reference's `whereistheplanet-master/data/post_{target}.hdf5`
    archive layout are understood; returns the matching file path."""
    import difflib
    import glob
    import os

    if catalog_dir is None:
        from ..datadeps import resolve_dataset

        catalog_dir = resolve_dataset("whereistheplanet")
    files = []
    for root in (
        catalog_dir,
        # the DataDeps archive layout (`io-orbitize.jl:23`)
        os.path.join(catalog_dir, "whereistheplanet-master", "data"),
        os.path.join(catalog_dir, "data"),
    ):
        for pat in ("*.h5", "*.hdf5"):
            files += glob.glob(os.path.join(root, pat))
    names = {}
    for f in files:
        stem = os.path.splitext(os.path.basename(f))[0].lower()
        if stem.startswith("post_"):
            stem = stem[len("post_"):]
        names.setdefault(stem, f)
    key = target.lower().replace(" ", "")
    if key in names:
        return names[key]
    close = difflib.get_close_matches(key, list(names), n=3)
    raise KeyError(f"No posterior for {target!r}; similar: {close}")


def Whereistheplanet_astrom(target, catalog_dir=None, object_num=1):
    """Load astrometry stored alongside a whereistheplanet posterior
    (`io-orbitize.jl:51-97`): returns a dict table with epoch/ra/dec or
    sep/pa columns ready for PlanetRelAstromObs."""
    import h5py

    path = Whereistheplanet_search(target, catalog_dir)
    with h5py.File(path, "r") as f:
        if "data" not in f:
            raise KeyError(f"{path} contains no astrometry 'data' table")
        d = np.asarray(f["data"])
        names = d.dtype.names
        ep = d["epoch"]
        quant1 = d["quant1"]
        quant2 = d["quant2"]
        q1e = d["quant1_err"]
        q2e = d["quant2_err"]
        qtype = (
            np.char.decode(d["quant_type"].astype("S"), "utf-8")
            if "quant_type" in names
            else np.full(len(d), "radec")
        )
        obj = d["object"] if "object" in names else np.ones(len(d), int)
        sel = obj == object_num
        if np.all(qtype[sel] == "radec"):
            return dict(
                epoch=ep[sel], ra=quant1[sel], dec=quant2[sel],
                σ_ra=q1e[sel], σ_dec=q2e[sel],
            )
        return dict(
            epoch=ep[sel], sep=quant1[sel], pa=np.deg2rad(quant2[sel]),
            σ_sep=q1e[sel], σ_pa=np.deg2rad(q2e[sel]),
        )
