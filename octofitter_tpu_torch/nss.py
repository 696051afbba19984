"""Gaia Non-Single-Star (NSS) catalog integration.

PyTorch port of `octofitter_tpu/nss.py` (the reference's `nss.jl`):
convert Gaia DR3 NSS orbital solutions (Thiele-Innes elements) into model
starting points and pseudo-chains for warm-starting fits. A solution comes
as a row (a dict of NSS columns), from a locally cached CSV of the TAP
result, or live from the Gaia archive by `net.query_nss_tap`, which sends
`NSS_TAP_QUERY`.
"""

from __future__ import annotations

import csv
import math

import numpy as np
import torch

from .chains import Chains
from .constants import KEPLER_YEAR_DAYS, jd2mjd
from .orbits import thiele_innes_to_campbell

# DR3 NSS t_periastron values are JD offsets from this reference
# (`nss.jl:101`)
NSS_DR3_T_PERIASTRON_REF_JD = 2457389.0

NSS_TAP_QUERY = (
    "SELECT * FROM gaiadr3.nss_two_body_orbit WHERE source_id = {gaia_id}"
)

# prior draws whose median mass sets a from the period by Kepler's third law
_FALLBACK_DRAWS = 512
# candidate starting points `initialize_from_nss` evaluates
_NSS_CANDIDATES = 64


def _csv_value(text: str):
    """A CSV cell as pandas would read it: an int, a float (NaN when
    empty) or the string."""
    text = text.strip()
    if text == "":
        return math.nan
    for parse in (int, float):
        try:
            return parse(text)
        except ValueError:
            pass
    return text


def query_nss(gaia_id=None, *, cache_csv=None, row=None) -> dict:
    """Load an NSS two-body-orbit solution.

    Provide `row` (a dict of NSS columns) or `cache_csv` (a locally cached
    TAP result, read with the `csv` module; with `gaia_id` the row of that
    `source_id`); with only `gaia_id` the live TAP path
    (`net.query_nss_tap`, mirroring `nss.jl:29-93`) is used, which itself
    reads its on-disk response cache first, so previously fetched
    solutions work offline. A failed query raises RuntimeError.
    """
    if row is not None:
        return dict(row)
    if cache_csv is not None:
        with open(cache_csv, newline="", encoding="utf-8") as f:
            rows = [{k.strip(): _csv_value(v) for k, v in r.items()} for r in csv.DictReader(f)]
        if gaia_id is not None and rows and "source_id" in rows[0]:
            rows = [r for r in rows if r["source_id"] == gaia_id]
        if not rows:
            raise KeyError(f"source {gaia_id} not found in {cache_csv}")
        return rows[0]
    if gaia_id is not None:
        from .net import query_nss_tap

        try:
            return query_nss_tap(gaia_id)
        except Exception as e:  # any failure of the query or of its reply
            raise RuntimeError(
                f"NSS TAP query for {gaia_id} failed ({e!r}); in "
                "offline environments pass row= (dict of NSS columns) "
                "or cache_csv=."
            ) from e
    raise RuntimeError(
        "Pass gaia_id=, row= (dict of NSS columns), or cache_csv=."
    )


def ti_to_campbell(A, B, F, G, *, device="cuda"):
    """(A,B,F,G) [mas] -> (i, Omega, omega, alpha_mas), angles in
    [0, 2pi) (`_ti_to_campbell`, `nss.jl:495-545`), computed in float64 on
    `device` (the GPU unless the caller says `device="cpu"`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"ti_to_campbell was asked for device {device!s}, but no CUDA device is "
            "available; pass device=\"cpu\""
        )
    alpha, i, omega, Omega = thiele_innes_to_campbell(
        *(torch.as_tensor(float(x), dtype=torch.float64, device=device) for x in (A, B, F, G)))
    return (
        float(i),
        float(torch.remainder(Omega, 2 * math.pi)),
        float(torch.remainder(omega, 2 * math.pi)),
        float(alpha),
    )


def nss_to_starting_point(nss_sol: dict, model, planet_key="b") -> dict:
    """Map an NSS solution onto the model's free parameters
    (`nss_to_starting_point`, `nss.jl:134-...`).

    Returns a dict of flat parameter names -> values covering whatever
    could be mapped (e, tp, TI constants or Campbell angles + a, plx,
    UniformCircular x/y pairs). Without a parallax, a comes from the
    period by Kepler's third law at the median mass of 512 prior draws by
    a generator seeded 42 on the model's device.
    """
    names = model.parameter_names
    prefix = f"{planet_key}_"
    mapped = {}

    def has(n):
        return prefix + n in names

    def put(n, v):
        mapped[prefix + n] = float(v)

    def put_angle(n, val):
        if has(n):
            put(n, val)
            return True
        if has(n + "x") and has(n + "y"):
            put(n + "x", math.cos(val))
            put(n + "y", math.sin(val))
            return True
        return False

    def get(key):
        v = nss_sol.get(key)
        if v is None:
            return None
        v = float(v)
        return v if np.isfinite(v) else None

    e = get("eccentricity")
    if e is not None and has("e"):
        put("e", e)

    period_days = get("period")
    tp_off = get("t_periastron")
    tp_mjd = (
        jd2mjd(tp_off + NSS_DR3_T_PERIASTRON_REF_JD) if tp_off is not None else None
    )
    if tp_mjd is not None and has("tp"):
        put("tp", tp_mjd)

    A = get("a_thiele_innes")
    B = get("b_thiele_innes")
    F = get("f_thiele_innes")
    G = get("g_thiele_innes")
    plx = get("parallax")
    if plx is not None and "plx" in names:
        mapped["plx"] = plx

    if None not in (A, B, F, G):
        if all(has(k) for k in ("A", "B", "F", "G")):
            put("A", A)
            put("B", B)
            put("F", F)
            put("G", G)
        else:
            inc, Omega, omega, alpha = ti_to_campbell(A, B, F, G, device=model.device)
            if has("i"):
                put("i", inc)
            put_angle("Omega", Omega)
            put_angle("omega", omega)
            if has("a") and plx is not None:
                put("a", alpha / plx)
            elif has("a") and period_days is not None:
                # fall back to Kepler's third law with the median prior mass
                generator = torch.Generator(device=model.device).manual_seed(42)
                with torch.no_grad():
                    nts = model.arr2nt(model.sample_priors(generator, _FALLBACK_DRAWS))
                M_med = (float(torch.quantile(torch.as_tensor(nts.M).reshape(-1).double(), 0.5))
                         if "M" in nts else 1.0)
                put("a", (M_med * (period_days / KEPLER_YEAR_DAYS) ** 2) ** (1 / 3))
    return mapped


def initialize_from_nss(model, nss_sol: dict, planet_key="b", generator=None,
                        verbosity=1):
    """Warm-start: map the NSS solution, fill the remaining free parameters
    of 64 candidates with prior draws (`generator`, default seeded 0 on the
    model's device), evaluate them with one batched `ln_post` on the model's
    device and set `model.starting_points` (a tensor there) to the finite
    ones, or to all 64 if none is (`initialize_from_nss!`,
    `nss.jl:298-...`). Returns the mapped values."""
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    mapped = nss_to_starting_point(nss_sol, model, planet_key)
    names = model.parameter_names
    with torch.no_grad():
        draws = model.sample_priors(generator, _NSS_CANDIDATES)
        for k, v in mapped.items():
            draws[:, names.index(k)] = v
        pts_t = model.link(draws)
        good = torch.isfinite(model.ln_post(pts_t))
    n_good = int(good.sum())
    if verbosity >= 1:
        print(
            f"initialize_from_nss: mapped {sorted(mapped)}; "
            f"{n_good}/{_NSS_CANDIDATES} finite starting points"
        )
    model.starting_points = pts_t[good] if n_good else pts_t
    return mapped


def nss_to_model_chain(nss_sol: dict, model, *, n_draws=10_000, planet_key="b",
                       generator=None):
    """Pseudo-chain from the NSS solution's Gaussian uncertainties
    (`nss_to_model_chain`, `nss.jl:364-471`): draw TI constants (and e,
    period, tp) from their quoted errors with numpy's default_rng(0), as
    the JAX package does, convert each to Campbell parameters, and return
    named arrays; the conversion runs in float64 on the model's device.
    `generator` is accepted for the reference's signature and draws
    nothing."""
    rng = np.random.default_rng(0)
    cols = {}

    def draw(name):
        mu = float(nss_sol[name])
        sig = float(nss_sol.get(name + "_error", 0.0) or 0.0)
        return mu + sig * rng.standard_normal(n_draws)

    A = draw("a_thiele_innes")
    B = draw("b_thiele_innes")
    F = draw("f_thiele_innes")
    G = draw("g_thiele_innes")
    alpha, inc, omega, Omega = (x.cpu().numpy() for x in thiele_innes_to_campbell(
        *(torch.as_tensor(x, device=model.device) for x in (A, B, F, G))))
    cols[f"{planet_key}_i"] = inc
    cols[f"{planet_key}_omega"] = np.mod(omega, 2 * math.pi)
    cols[f"{planet_key}_Omega"] = np.mod(Omega, 2 * math.pi)
    if "parallax" in nss_sol:
        plx = draw("parallax")
        cols["plx"] = plx
        cols[f"{planet_key}_a"] = alpha / plx
    if "eccentricity" in nss_sol:
        cols[f"{planet_key}_e"] = draw("eccentricity")
    if "period" in nss_sol:
        cols[f"{planet_key}_P"] = draw("period")
    if "t_periastron" in nss_sol:
        cols[f"{planet_key}_tp"] = jd2mjd(
            draw("t_periastron") + NSS_DR3_T_PERIASTRON_REF_JD
        )
    return Chains({k: v[None, :] for k, v in cols.items()}, {}, {"sampler": "nss_pseudo"})
