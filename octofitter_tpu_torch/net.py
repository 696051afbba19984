"""Live data-acquisition layer (reference layer L9).

A copy of `octofitter_tpu/net.py` (importing that package would import
JAX), with the GOST catalog lookup reading its CSV without pandas. The
reference fetches catalogs and forecasts from web services at runtime:
Gaia TAP catalog rows (`src/likelihoods/gaia-utils.jl:183-288`), the GOST
scanning-law forecast tool (`gaia-utils.jl:700-831`), the Gaia NSS TAP
table (`src/nss.jl:29-93`), and the whereistheplanet archive
(`src/io-orbitize.jl:21-97`). This module implements the same protocols
over `urllib`, with two provisions that make the full HTTP path testable
without a network:

- every function takes a base-URL override, so a localhost server can
  stand in for the real service (tests/test_torch_net.py runs a real
  `http.server` and drives these functions and the JAX package's side by
  side);
- every function caches its response in the same file layout the
  reference and the JAX package use (`GOST-{ra}-{dec}-{baseline}.csv`,
  `_gaia_dr3/source-{id}.csv`, `_gaia_nss/source-{id}.csv`), so files
  downloaded by any of them interoperate and offline runs hit the cache.

Nothing here runs on the GPU; this is host-side IO that feeds the
observation constructors.
"""

from __future__ import annotations

import http.cookiejar
import os
import re
import urllib.parse
import urllib.request

import numpy as np

GAIA_TAP_URL = "https://gea.esac.esa.int/tap-server/tap/sync"
GOST_BASE_URL = "https://gaia.esac.esa.int/gost/"

# GOST forecast windows per data-release baseline
# (`gaia-utils.jl:709-716`)
GOST_FROM = "2014-07-25T10:31:26"
GOST_TO = {
    "dr3": "2017-06-28T00:00:00",
    "dr4": "2020-01-20T00:00:00",
    "dr5": "2025-01-15T06:16:00",
}


def build_opener(cookies=False):
    """An urllib opener; with `cookies`, returns (opener, cookiejar) so
    callers can read session cookies (the GOST flow needs JSESSIONID)."""
    if cookies:
        jar = http.cookiejar.CookieJar()
        opener = urllib.request.build_opener(
            urllib.request.HTTPCookieProcessor(jar)
        )
        opener._octofitter_cookiejar = jar
        return opener, jar
    return urllib.request.build_opener(), None


def http_request(url, params=None, *, data=None, opener=None,
                 timeout=60.0) -> bytes:
    """GET (or POST when `data` is given) and return the response body.

    `params` are URL-encoded into the query string; `data` (a dict)
    is form-encoded into the POST body. Raises `urllib.error.HTTPError`
    on non-2xx statuses.
    """
    if params:
        sep = "&" if urllib.parse.urlparse(url).query else "?"
        url = url + sep + urllib.parse.urlencode(params)
    body = None
    if data is not None:
        body = urllib.parse.urlencode(data).encode("utf-8")
    op = opener or urllib.request.build_opener()
    with op.open(urllib.request.Request(url, data=body), timeout=timeout) as r:
        return r.read()


# ── Gaia TAP ─────────────────────────────────────────────────────────


def tap_query(adql, *, url=None, opener=None, timeout=60.0) -> str:
    """Run a synchronous TAP query, returning the CSV text
    (`gaia-utils.jl:187-196` request shape)."""
    body = http_request(
        url or GAIA_TAP_URL,
        params={
            "REQUEST": "doQuery",
            "LANG": "ADQL",
            "FORMAT": "CSV",
            "QUERY": adql,
        },
        opener=opener,
        timeout=timeout,
    )
    return body.decode("utf-8")


def parse_tap_csv_row(text: str) -> dict:
    """First data row of a TAP CSV response as {column: float|str}
    (`gaia-utils.jl:210-217`: floats where parseable)."""
    import csv
    import io

    rows = [r for r in csv.reader(io.StringIO(text)) if any(
        c.strip() for c in r)]
    if len(rows) < 2:
        raise KeyError("TAP response contains no data row")
    headers = [h.strip() for h in rows[0]]
    cells = rows[1]
    if len(cells) != len(headers):
        raise KeyError("TAP response row length does not match header")
    row = {}
    for k, v in zip(headers, cells):
        try:
            row[k] = float(v)
        except ValueError:
            row[k] = v.strip()
    return row


def _atomic_write(fname, data):
    """Write bytes/str to `fname` via a temp file + os.replace so an
    interrupted write (alarm, Ctrl-C, OOM) can never leave a truncated
    file behind — these caches are trusted by every later run."""
    mode = "wb" if isinstance(data, bytes) else "w"
    tmp = fname + ".part"
    with open(tmp, mode) as f:
        f.write(data)
    os.replace(tmp, fname)


def query_gaia_catalog(gaia_id, release="dr3", *, cache_dir=None,
                       url=None, opener=None) -> dict:
    """Fetch (or load from cache) one gaia_source catalog row.

    Mirrors `_query_gaia_dr1/dr2/dr3` (`gaia-utils.jl:183-288`): the
    response CSV is cached under `{cache_dir}/_gaia_{release}/
    source-{id}.csv` and parsed into a {column: value} dict.
    """
    release = release.lower()
    if release not in ("dr1", "dr2", "dr3"):
        raise ValueError(f"unknown Gaia release {release!r}")
    root = cache_dir or _net_cache_dir()
    sub = os.path.join(root, f"_gaia_{release}")
    fname = os.path.join(sub, f"source-{int(gaia_id)}.csv")
    if os.path.isfile(fname):
        with open(fname, "r") as f:
            text = f.read()
    else:
        text = tap_query(
            f"SELECT * FROM gaia{release}.gaia_source "
            f"WHERE source_id={int(gaia_id)}",
            url=url, opener=opener,
        )
        row = parse_tap_csv_row(text)  # validate before caching
        os.makedirs(sub, exist_ok=True)
        _atomic_write(fname, text)
        return row
    return parse_tap_csv_row(text)


def query_nss_tap(gaia_id, *, url=None, opener=None,
                  cache_dir=None) -> dict:
    """Fetch one gaiadr3.nss_two_body_orbit row (`nss.jl:29-93`).

    The cache keeps the reference's layout, as the JAX package's
    `net.query_nss_tap` does: the TAP response is written verbatim to
    `{cache_dir}/_gaia_nss/source-{id}.csv` (`cache_dir` defaults to
    `datadeps.data_dir()`), and a cached file is read instead of querying,
    so a solution fetched by either package works offline in both."""
    root = cache_dir or _net_cache_dir()
    sub = os.path.join(root, "_gaia_nss")
    fname = os.path.join(sub, f"source-{int(gaia_id)}.csv")
    if os.path.isfile(fname):
        with open(fname, "r") as f:
            return parse_tap_csv_row(f.read())
    from .nss import NSS_TAP_QUERY

    text = tap_query(
        NSS_TAP_QUERY.format(gaia_id=int(gaia_id)), url=url, opener=opener
    )
    row = parse_tap_csv_row(text)
    os.makedirs(sub, exist_ok=True)
    _atomic_write(fname, text)
    return row


def _net_cache_dir() -> str:
    from .datadeps import data_dir

    return data_dir()


# ── GOST scanning-law forecast ───────────────────────────────────────


def GOST_forecast(ra_deg, dec_deg, *, baseline="dr3", cache_dir=None,
                  base_url=None, opener=None, timeout=120.0):
    """Forecast of Gaia visibility windows for a sky position, as a
    scan table dict (see `astrom.scanlaw.load_gost_csv`).

    Protocol matches the reference (`gaia-utils.jl:709-800`):

    1. `OCTO_GOST_CATALOG` (or config.gost_catalog) set → nearest-target
       lookup in that database file (error if > 500 mas away).
    2. cached `GOST-{ra}-{dec}-{baseline}.csv` in `cache_dir` → load.
    3. live: GET the GOST landing page to open a session (JSESSIONID
       cookie), POST the single-target form to `GostServlet`, parse
       the job id from "Submitted with id NNN", then GET
       `export.jsp?id={session}/{job}&format=csv`; the CSV is written
       to the cache file for offline reuse.
    """
    from .astrom.scanlaw import load_gost_csv
    from .config import get_config

    baseline = str(baseline).lstrip(":").lower()
    if baseline not in GOST_TO:
        raise ValueError(f"baseline must be one of {sorted(GOST_TO)}")

    catalog = get_config().gost_catalog
    if catalog:
        return _gost_from_catalog(catalog, ra_deg, dec_deg)

    base_url = base_url or GOST_BASE_URL
    root = cache_dir or "."
    fname = os.path.join(root, f"GOST-{ra_deg}-{dec_deg}-{baseline}.csv")
    if os.path.isfile(fname):
        return _dedup_scan_table(load_gost_csv(fname))

    if opener is None:
        opener, _ = build_opener(cookies=True)
    jar = getattr(opener, "_octofitter_cookiejar", None)
    if jar is None:
        # caller-supplied opener: find its cookie jar, if any
        for h in getattr(opener, "handlers", []):
            if isinstance(h, urllib.request.HTTPCookieProcessor):
                jar = h.cookiejar
                break

    # 1. open a session (sets JSESSIONID)
    http_request(base_url, opener=opener, timeout=timeout)
    # 2. submit the forecast job
    form = {
        "serviceCode": "1",
        "inputmode": "single",
        "srcname": "009",
        "srcra": f"{round(float(ra_deg), 7)}",
        "srcdec": f"{round(float(dec_deg), 7)}",
        "from": GOST_FROM,
        "to": GOST_TO[baseline],
    }
    body = http_request(
        base_url.rstrip("/") + "/GostServlet",
        data=form, opener=opener, timeout=timeout,
    ).decode("utf-8", errors="replace")
    # case-sensitive, matching the reference's contains(body, "error")
    # (`gaia-utils.jl:775`): the success page may legitimately contain
    # "Error"/"onerror" in markup
    m = re.search(r"Submitted with id (\d+)", body)
    if m is None or "error" in body:
        raise IOError(
            f"GOST submission failed; response began: {body[:200]!r}"
        )
    job_id = m.group(1)
    session_id = _session_cookie(jar)
    # 3. export the finished forecast as CSV
    csv_bytes = http_request(
        base_url.rstrip("/") + "/export.jsp",
        params={"id": f"{session_id}/{job_id}", "format": "csv"},
        opener=opener, timeout=timeout,
    )
    if not csv_bytes.strip():
        raise IOError("Empty response from GOST service. Rate limited?")
    os.makedirs(root, exist_ok=True)
    _atomic_write(fname, csv_bytes)
    return _dedup_scan_table(load_gost_csv(fname))


def _session_cookie(jar):
    if jar is not None:
        for c in jar:
            if c.name.upper() == "JSESSIONID":
                return c.value
    raise IOError("GOST service did not set a JSESSIONID session cookie")


def _gost_from_catalog(path, ra_deg, dec_deg, max_sep_mas=500.0):
    """Nearest-target lookup in a bulk GOST database file
    (`gaia-utils.jl:717-737`). The CSV is read without pandas
    (`astrom.scanlaw.read_csv_columns`): cells that are not numbers read
    as NaN, where the JAX package's pandas drops a column of text, and
    the scan table takes only numeric columns either way."""
    from .astrom.scanlaw import load_gost_csv, read_csv_columns

    table = read_csv_columns(path)
    cols = {re.sub(r"[^0-9a-zA-Z]+", "_", str(c)).strip("_"): c
            for c in table}
    ra_col, dec_col = cols.get("ra_rad"), cols.get("dec_rad")
    if ra_col is None or dec_col is None:
        raise KeyError(
            f"GOST catalog {path}: no ra[rad]/dec[rad] columns "
            f"(has {list(table)})"
        )
    ra = np.asarray(table[ra_col], dtype=float)
    dec = np.asarray(table[dec_col], dtype=float)
    # Julia isapprox default: rtol = sqrt(eps(Float64)), atol = 0
    isapprox_rtol = 1.4901161193847656e-08
    # NOTE: the radian differences are scaled by the DEGREE->mas factor
    # (3600e3, not rad2deg*3600e3). This reproduces the reference's
    # arithmetic exactly (`gaia-utils.jl:723-726`), so the 500 "mas"
    # acceptance radius means the same thing against the same catalogs;
    # do not "fix" the units here.
    d_mas = np.hypot(
        (ra - np.deg2rad(ra_deg)) * 3600e3 * np.cos(np.deg2rad(dec_deg)),
        (dec - np.deg2rad(dec_deg)) * 3600e3,
    )
    i = int(np.argmin(d_mas))
    if d_mas[i] > max_sep_mas:
        raise KeyError(
            f"no target within {max_sep_mas} mas of "
            f"({ra_deg}, {dec_deg}) in {path}; closest {d_mas[i]:.0f} mas"
        )
    # match the reference's isapprox tolerance (`gaia-utils.jl:731`):
    # np.isclose's default rtol=1e-5 is loose enough to merge rows from
    # a neighboring target a few arcsec away
    mask = np.isclose(ra, ra[i], rtol=isapprox_rtol, atol=0.0) & np.isclose(
        dec, dec[i], rtol=isapprox_rtol, atol=0.0
    )
    return _dedup_scan_table(
        load_gost_csv({c: np.asarray(v)[mask] for c, v in table.items()})
    )


def _dedup_scan_table(table, min_dt_days=1e-4):
    """Drop duplicate scan rows closer than ~8.6 s in time
    (`_sort_dedup_gost`, `gaia-utils.jl:803-831`): real field-of-view
    transits are >= 1.7 h apart, so anything closer is a duplicated
    catalog block. `load_gost_csv` already time-sorts. The comparison
    is anchored to the last KEPT epoch (reference `:817-822`), so a
    chain of near-duplicates collapses onto its first row rather than
    deleting later distinct scans."""
    t = np.asarray(table["epoch"])
    if len(t) == 0:
        return table
    if (np.diff(t) > min_dt_days).all():
        return table
    keep = []
    last_t = -np.inf
    for i, ti in enumerate(t):
        if ti - last_t > min_dt_days:
            keep.append(i)
            last_t = ti
    keep = np.asarray(keep)
    return {k: np.asarray(v)[keep] for k, v in table.items()}
