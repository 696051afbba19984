"""Dataset registry: the equivalent of the reference's DataDeps
registrations (`src/Octofitter.jl:166-343`).

A copy of `octofitter_tpu/datadeps.py` (importing that package would
import JAX). The reference registers ~15 datasets (HGCA eDR3/DR2,
Hipparcos IAD, DE440 ephemeris, Sonora/BHAC model grids, the G23H Arrow
catalog + DR2 sidecar, whereistheplanet, RV archives) that DataDeps
downloads and caches on first use. The registry resolves every dataset to
a LOCAL file: an explicit path argument, a per-dataset environment
variable, or a file under the data root (config.data_dir /
OCTOFITTER_DATA_DIR), in that order, with the expected filenames, the
upstream URL recorded for provenance, and loader hints, so a user can
stage the same published files the reference downloads. `fetch_dataset`
downloads one over `urllib` (any URL scheme it takes, `file://` too) where
the machine has a network.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    filenames: tuple          # candidate filenames under the data root
    url: str                  # upstream source (provenance; not fetched)
    loader: str               # API entry point that consumes the file
    description: str = ""


REGISTRY: dict[str, Dataset] = {}


def register_dataset(name, filenames, url, loader, description=""):
    REGISTRY[name] = Dataset(name, tuple(filenames), url, loader, description)
    return REGISTRY[name]


# --- the reference's registrations (`Octofitter.jl:166-343`) -------------
register_dataset(
    "HGCA_eDR3",
    ("HGCA_vEDR3.fits",),
    "https://www.cfa.harvard.edu/~gmbrandt/HGCA_vEDR3.fits",
    "likelihoods.hgca.load_hgca",
    "Hipparcos-Gaia Catalog of Accelerations (eDR3 edition)",
)
register_dataset(
    "HGCA_DR2",
    ("HGCA_vDR2_corrected.fits",),
    "https://www.cfa.harvard.edu/~gmbrandt/HGCA_vDR2_corrected.fits",
    "likelihoods.hgca.load_hgca",
    "HGCA DR2 edition",
)
register_dataset(
    "Hipparcos_IAD",
    ("ResRec_JavaTool_2014",),
    "https://www.cosmos.esa.int/web/hipparcos/hipparcos-2",
    "astrom.hipparcos.HipparcosIADObs",
    "van Leeuwen 2014 Java-Tool intermediate astrometric data tree",
)
register_dataset(
    "DE440_ephemeris",
    ("de440.bsp",),
    "https://naif.jpl.nasa.gov/pub/naif/generic_kernels/spk/planets/de440.bsp",
    "astrom.ephemeris.earth_position_from_table",
    "JPL DE440 ephemeris (tabulate Earth positions to an epoch table; "
    "the built-in analytic series is the fallback)",
)
register_dataset(
    "Sonora_Bobcat",
    ("sonora_bobcat.tar.gz", "photometry_tables",),
    "https://zenodo.org/record/5063476",
    "atmosphere.sonora_photometry_interpolator",
    "Sonora Bobcat substellar atmosphere/evolution grids",
)
register_dataset(
    "BHAC15",
    ("BHAC15_tracks+structure",),
    "http://perso.ens-lyon.fr/isabelle.baraffe/BHAC15dir/",
    "atmosphere.bhac15_mass_age_interpolator",
    "Baraffe+2015 isochrones",
)
register_dataset(
    "G23H_catalog",
    ("g23h.feather", "G23H-test-subset.feather"),
    "(G23H release; Thompson et al.)",
    "astrom.load_g23h_catalog_row",
    "G23H composite Hipparcos+DR2+DR3 catalog (Arrow/feather)",
)
register_dataset(
    "G23H_DR2Transits",
    ("g23h_dr2_transits.feather",),
    "(G23H release sidecar)",
    "astrom.load_g23h_catalog_row(dr2_transits_catalog=...)",
    "Gaia DR2 matched-transit counts sidecar",
)
register_dataset(
    "whereistheplanet",
    ("whereistheplanet_posteriors",),
    "https://github.com/semaphoreP/whereistheplanet",
    "io.orbitize.Whereistheplanet_search",
    "Orbitize! posterior archive (local mirror directory)",
)
register_dataset(
    "HARPS_RVBank",
    ("HARPS_RVBank_v1.csv",),
    "https://www2.mpia-hd.mpg.de/homes/trifonov/HARPS_RVBank.html",
    "rv.data_sources.HARPS_RVBank_rvs",
    "HARPS RV bank",
)
register_dataset(
    "gaia_gost",
    ("gost_*.csv",),
    "https://gaia.esac.esa.int/gost/",
    "astrom.scanlaw.load_gost_csv",
    "GOST scanning-law forecasts (cache the CSV per target; also see "
    "config.gost_catalog / OCTO_GOST_CATALOG)",
)


def data_dir() -> str:
    from .config import get_config

    return (
        os.environ.get("OCTOFITTER_DATA_DIR")
        or get_config().data_dir
        or os.path.expanduser("~/.octofitter_tpu/data")
    )


def resolve_dataset(name: str, path: str | None = None) -> str:
    """Resolve a registered dataset to a local file path.

    Resolution order: explicit `path` argument; the
    OCTOFITTER_DATA_<NAME> environment variable; each candidate
    filename under `data_dir()`. Raises FileNotFoundError with staging
    instructions (including the upstream URL) when nothing is found;
    nothing is downloaded here (`fetch_dataset` does that).
    """
    if name not in REGISTRY:
        raise KeyError(
            f"unknown dataset {name!r}; registered: {sorted(REGISTRY)}"
        )
    ds = REGISTRY[name]
    if path is not None:
        if os.path.exists(path):
            return path
        raise FileNotFoundError(f"{name}: explicit path {path!r} not found")
    env_key = f"OCTOFITTER_DATA_{name.upper()}"
    if os.environ.get(env_key):
        p = os.environ[env_key]
        if os.path.exists(p):
            return p
        raise FileNotFoundError(f"{name}: ${env_key}={p!r} not found")
    root = data_dir()
    import glob as _glob

    for fn in ds.filenames:
        hits = sorted(_glob.glob(os.path.join(root, fn)))
        if hits:
            return hits[0]
    raise FileNotFoundError(
        f"dataset {name!r} not staged. Place one of {ds.filenames} under "
        f"{root} (or set ${env_key}). Upstream source: {ds.url}. "
        f"Consumed by octofitter_tpu_torch.{ds.loader}."
    )


def unpack_archive(path: str, root: str | None = None) -> list[str]:
    """The DataDeps `post_fetch_method=unpack` step: the reference's
    archive registrations (Sonora tarballs, Hipparcos IAD tree, RV
    banks — `src/Octofitter.jl:166-343`) extract the
    downloaded archive in place and delete it. Handles .tar[.gz/.bz2],
    .zip and bare .gz; returns the extracted paths. Non-archives are
    returned as-is (no-op), matching DataDeps' identity post-fetch."""
    import gzip
    import shutil
    import tarfile
    import zipfile

    root = root or os.path.dirname(os.path.abspath(path))
    if tarfile.is_tarfile(path):
        with tarfile.open(path) as tf:
            members = tf.getmembers()
            try:
                tf.extractall(root, filter="data")
            except TypeError:  # Python < 3.12: no extraction filter
                tf.extractall(root)
        os.remove(path)
        return [os.path.join(root, m.name) for m in members]
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            zf.extractall(root)
        os.remove(path)
        return [os.path.join(root, n) for n in names]
    if path.endswith(".gz"):
        dest = path[:-3]
        with gzip.open(path, "rb") as src, open(dest, "wb") as out:
            shutil.copyfileobj(src, out)
        os.remove(path)
        return [dest]
    return [path]


def fetch_dataset(
    name: str,
    *,
    url: str | None = None,
    filename: str | None = None,
    sha256: str | None = None,
    force: bool = False,
    unpack: bool = False,
) -> str:
    """Download a registered dataset into `data_dir()` and return its
    local path — the DataDeps `download` step
    (`src/Octofitter.jl:166-343`).

    Already-staged files are returned without re-downloading (unless
    `force`). The transfer goes to a temp file first and is renamed
    into place only after the optional `sha256` verifies, so an
    interrupted download can never leave a corrupt cache entry.
    `url` overrides the registered provenance URL (useful for mirrors;
    `file://` URLs work, which is how the offline test suite exercises
    this path). `unpack=True` runs the DataDeps post-fetch unpack step
    (`unpack_archive`) and re-resolves the dataset so the returned path
    is the extracted payload, not the archive.
    """
    import hashlib
    import shutil
    import tempfile
    import urllib.request

    if name not in REGISTRY:
        raise KeyError(
            f"unknown dataset {name!r}; registered: {sorted(REGISTRY)}"
        )
    ds = REGISTRY[name]
    if not force:
        try:
            return resolve_dataset(name)
        except FileNotFoundError:
            pass
    src = url or ds.url
    if "://" not in src:
        raise ValueError(
            f"dataset {name!r} has no fetchable URL ({src!r}); stage the "
            f"file manually under {data_dir()}"
        )
    fn = filename or next(
        (f for f in ds.filenames if "*" not in f), ds.filenames[0]
    )
    root = data_dir()
    os.makedirs(root, exist_ok=True)
    dest = os.path.join(root, fn)
    fd, tmp = tempfile.mkstemp(dir=root, prefix=f".{fn}.part-")
    try:
        with os.fdopen(fd, "wb") as out, urllib.request.urlopen(src) as resp:
            shutil.copyfileobj(resp, out)
        if sha256 is not None:
            h = hashlib.sha256()
            with open(tmp, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
            if h.hexdigest() != sha256:
                raise IOError(
                    f"dataset {name!r}: checksum mismatch "
                    f"(got {h.hexdigest()}, want {sha256})"
                )
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    if unpack:
        extracted = unpack_archive(dest, root)
        try:
            return resolve_dataset(name)
        except FileNotFoundError:
            return extracted[0] if extracted else dest
    return dest


def list_datasets() -> list[Dataset]:
    return [REGISTRY[k] for k in sorted(REGISTRY)]
