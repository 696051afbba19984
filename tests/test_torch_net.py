"""The port's live data layer (`octofitter_tpu_torch/net.py`, `datadeps.py`
and `query_nss(gaia_id=)`) held to the JAX package's, on the CPU.

A real `http.server` on 127.0.0.1 stands in for the Gaia TAP service, the
GOST forecast tool and a dataset mirror (as tests/test_net.py does);
nothing is downloaded from outside. Each function runs in both packages
against the same server: the two must make the same requests (method,
path, query or form, session cookie), write the same cache files byte for
byte and return equal tables. A URL that must not be used points at a
closed local port.
"""

import hashlib
import http.server
import io
import os
import tarfile
import threading
import urllib.parse

import numpy as np
import pytest

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu import datadeps as jdatadeps
from octofitter_tpu import net as jnet
from octofitter_tpu.config import get_config as jget_config
from octofitter_tpu_torch import datadeps as tdatadeps
from octofitter_tpu_torch import net as tnet
from octofitter_tpu_torch.config import get_config as tget_config

import chip_smoke

DEAD = "http://127.0.0.1:1/dead"
GAIA_CSV = (
    "source_id,ra,dec,parallax,pmra,pmdec,phot_g_mean_mag,designation\n"
    "12345,158.307,40.4255,24.5,-51.2,12.25,7.9,Gaia DR3 12345\n"
)
NSS_CSV = (
    "source_id,nss_solution_type,period,eccentricity,t_periastron\n"
    "67890,Orbital,1012.5,0.31,-120.25\n"
)


class _Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _send(self, body, headers=()):
        body = body.encode() if isinstance(body, str) else body
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(parsed.query)
        self.server.calls.append(("GET", parsed.path, qs, self.headers.get("Cookie")))
        if parsed.path == "/tap/sync":
            query = qs["QUERY"][0]
            self._send(NSS_CSV if "nss_two_body_orbit" in query else GAIA_CSV)
        elif parsed.path == "/gost/":
            self._send("<html>GOST</html>",
                       headers=[("Set-Cookie", "JSESSIONID=SESSION1; Path=/")])
        elif parsed.path == "/gost/export.jsp":
            self._send(self.server.gost_csv)
        elif parsed.path.startswith("/files/") and parsed.path[7:] in self.server.files:
            self._send(self.server.files[parsed.path[7:]])
        else:
            self.send_error(404)

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        form = urllib.parse.parse_qs(
            self.rfile.read(int(self.headers.get("Content-Length", 0))).decode())
        self.server.calls.append(("POST", parsed.path, form, self.headers.get("Cookie")))
        if parsed.path == "/gost/GostServlet":
            self._send(self.server.servlet_reply)
        else:
            self.send_error(404)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    srv.calls, srv.files = [], {}
    srv.servlet_reply = "<html>Submitted with id 4242</html>"
    gost = chip_smoke.synth_gost_csv(tmp_path_factory.mktemp("gost"), n=30)
    with open(gost, "rb") as f:
        srv.gost_csv = f.read()
    srv.gost_path = gost
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    srv.base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield srv
    srv.shutdown()
    thread.join(timeout=5)


def _files(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _both(server, tmp_path, call):
    """Run `call(pkg_net, cache_dir)` for JAX, then the port, each with a
    cache directory of its own: (results, requests, cache files) of each."""
    out = []
    for name, mod in (("jax", jnet), ("port", tnet)):
        server.calls.clear()
        root = tmp_path / name
        root.mkdir()
        out.append((call(mod, str(root)), list(server.calls), _files(root)))
    return out


def _same_table(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("which", ["gaia", "nss"])
def test_tap_queries_match_jax(server, tmp_path, which):
    url = server.base + "/tap/sync"
    if which == "gaia":
        def call(mod, root, url=url):
            return mod.query_gaia_catalog(12345, "dr3", cache_dir=root, url=url)
    else:
        def call(mod, root, url=url):
            return mod.query_nss_tap(67890, cache_dir=root, url=url)
    (rj, cj, fj), (rt, ct, ft) = _both(server, tmp_path, call)
    assert rt == rj and ct == cj and len(ct) == 1 and ft == fj and len(ft) == 1
    # the port reads the JAX package's cache without a request
    server.calls.clear()
    assert call(tnet, str(tmp_path / "jax"), url=DEAD) == rj and not server.calls
    assert tnet.parse_tap_csv_row(GAIA_CSV) == jnet.parse_tap_csv_row(GAIA_CSV)
    with pytest.raises(ValueError):
        tnet.query_gaia_catalog(12345, "dr9", cache_dir=str(tmp_path), url=url)


def test_query_nss_live_cached_and_offline(server, tmp_path, monkeypatch):
    """`query_nss(gaia_id=)` goes through `net.query_nss_tap` as the JAX
    package's does, caches under the data directory, reads the cache with
    no service, and raises RuntimeError naming row= and cache_csv= when
    the query fails."""
    url = server.base + "/tap/sync"
    rows = {}
    for name, pkg, mod in (("jax", oc, jnet), ("port", ot, tnet)):
        monkeypatch.setattr(mod, "GAIA_TAP_URL", url)
        monkeypatch.setenv("OCTOFITTER_DATA_DIR", str(tmp_path / name))
        server.calls.clear()
        rows[name] = (pkg.query_nss(67890), list(server.calls))
    assert rows["port"] == rows["jax"] and len(rows["port"][1]) == 1
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    monkeypatch.setattr(tnet, "GAIA_TAP_URL", DEAD)
    server.calls.clear()
    assert ot.query_nss(67890) == rows["jax"][0] and not server.calls
    monkeypatch.setenv("OCTOFITTER_DATA_DIR", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="row=.*cache_csv="):
        ot.query_nss(67890)


def test_gost_forecast_matches_jax_and_load_gost_csv(server, tmp_path):
    """The session flow (landing GET, servlet POST with the session
    cookie, export GET of {session}/{job}), the cache file, the table; a
    second call reads the cache; the table equals `load_gost_csv` of the
    served file."""
    ra, dec = 158.30707896392835, 40.42555422701387

    def call(mod, root, base=server.base + "/gost/"):
        return mod.GOST_forecast(ra, dec, baseline="dr3", cache_dir=root, base_url=base)

    (tj, cj, fj), (tt, ct, ft) = _both(server, tmp_path, call)
    assert ct == cj and [c[:2] for c in ct] == [
        ("GET", "/gost/"), ("POST", "/gost/GostServlet"), ("GET", "/gost/export.jsp")]
    assert ct[2][2]["id"] == ["SESSION1/4242"] and "JSESSIONID=SESSION1" in ct[2][3]
    assert ft == fj == {f"GOST-{ra}-{dec}-dr3.csv": server.gost_csv}
    _same_table(tt, tj)
    _same_table(tt, tnet._dedup_scan_table(ot.astrom.scanlaw.load_gost_csv(server.gost_path)))
    server.calls.clear()
    _same_table(call(tnet, str(tmp_path / "jax"), base=DEAD + "/"), tj)
    assert not server.calls
    with pytest.raises(ValueError):
        tnet.GOST_forecast(ra, dec, baseline="dr99", cache_dir=str(tmp_path))


def test_gost_submission_error(server, tmp_path):
    """A servlet reply without a job id raises IOError in both packages
    and caches nothing."""
    server.servlet_reply = "<html>error: rate limited</html>"
    try:
        for mod in (jnet, tnet):
            with pytest.raises(IOError):
                mod.GOST_forecast(10.0, 20.0, cache_dir=str(tmp_path),
                                  base_url=server.base + "/gost/")
    finally:
        server.servlet_reply = "<html>Submitted with id 4242</html>"
    assert not os.listdir(tmp_path)


def test_gost_catalog_without_pandas(tmp_path, monkeypatch):
    """The bulk-database lookup (`_gost_from_catalog`, reached through
    `GOST_forecast` when config.gost_catalog is set) reads its CSV without
    pandas and picks the nearest target's rows as the JAX package does."""
    ra1, dec1, ra2, dec2 = 2.762979757764773, 0.7055590227334224, 1.0, -0.5
    cat = tmp_path / "gost_catalog.csv"
    lines = ["Target,ra[rad],dec[rad],ObservationTimeAtGaia[UTC],scanAngle[rad],"
             "parallaxFactorAlongScan,parallaxFactorAcrossScan,"
             "ObservationTimeAtBarycentre[BarycentricJulianDateInTCB]"]
    for k in range(8):
        tgt, ra, dec = ("A", ra1, dec1) if k < 4 else ("B", ra2, dec2)
        # the fourth row of A repeats the third 5 s later: a duplicate
        t = 2456950.0 + 10.0 * min(k, 2) + (5.0 / 86400 if k == 3 else 0.0)
        lines.append(f"{tgt},{ra!r},{dec!r},2014-10-19T22:30:37.955,{0.1 * k!r},"
                     f"{-0.5 + 0.1 * k!r},0.7,{t!r}")
    cat.write_text("\n".join(lines) + "\n")
    monkeypatch.setattr(jget_config(), "gost_catalog", str(cat))
    monkeypatch.setattr(tget_config(), "gost_catalog", str(cat))
    want = jnet.GOST_forecast(np.rad2deg(ra1), np.rad2deg(dec1))
    monkeypatch.setitem(__import__("sys").modules, "pandas", None)
    for native_built in (True, False):
        monkeypatch.setattr(ot.native, "available", lambda b=native_built: b)
        got = tnet.GOST_forecast(np.rad2deg(ra1), np.rad2deg(dec1))
        _same_table(got, want)
        assert len(got["epoch"]) == 3
        with pytest.raises(KeyError):
            tnet.GOST_forecast(90.0, -45.0)


@pytest.mark.parametrize("epochs", [[100.0, 100.0 + 2e-5, 101.0, 102.0],
                                    [1.0, 1.0 + 5e-5, 1.0 + 9e-5, 1.0 + 1.5e-4, 3.0],
                                    [5.0, 6.0, 7.0], []])
def test_dedup_scan_table_matches_jax(epochs):
    t = {"epoch": np.asarray(epochs), "parallaxFactorAlongScan": np.arange(len(epochs)) + 1.0}
    got, want = tnet._dedup_scan_table(t), jnet._dedup_scan_table(t)
    _same_table(got, want)
    assert (got is t) == (want is t)


def test_datadeps_registry_matches_jax(tmp_path, monkeypatch):
    assert [d.name for d in tdatadeps.list_datasets()] == [
        d.name for d in jdatadeps.list_datasets()]
    for name, ds in jdatadeps.REGISTRY.items():
        assert (tdatadeps.REGISTRY[name].filenames, tdatadeps.REGISTRY[name].url) == (
            ds.filenames, ds.url)
    monkeypatch.setenv("OCTOFITTER_DATA_DIR", str(tmp_path))
    assert tdatadeps.data_dir() == jdatadeps.data_dir() == str(tmp_path)
    (tmp_path / "de440.bsp").write_bytes(b"x")
    assert tdatadeps.resolve_dataset("DE440_ephemeris") == str(tmp_path / "de440.bsp")
    for mod in (tdatadeps, jdatadeps):
        with pytest.raises(FileNotFoundError):
            mod.resolve_dataset("HGCA_eDR3")
        with pytest.raises(KeyError):
            mod.resolve_dataset("no_such_dataset")


@pytest.mark.parametrize("kind", ["archive", "plain"])
def test_datadeps_fetch_unpack_resolve_match_jax(server, tmp_path, monkeypatch, kind):
    """fetch (sha256 checked, a bad sum stages nothing), unpack and resolve
    in both packages: the same files and the same resolved path; a second
    fetch is a cache hit with no request."""
    if kind == "archive":
        payload = b"Teff  logg  M_J\n500  4.5  12.3\n"
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tf:
            info = tarfile.TarInfo("photometry_tables/sonora_flux_table.txt")
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
        name, fname, body, unpack = "Sonora_Bobcat", "sonora_bobcat.tar.gz", buf.getvalue(), True
    else:
        name, fname, body, unpack = "HGCA_eDR3", "hgca.fits", b"SIMPLE  =    T fake", False
    server.files[fname] = body
    url = server.base + "/files/" + fname
    paths = {}
    for label, mod in (("jax", jdatadeps), ("port", tdatadeps)):
        root = tmp_path / label
        monkeypatch.setenv("OCTOFITTER_DATA_DIR", str(root))
        with pytest.raises(IOError):
            mod.fetch_dataset(name, url=url, sha256="0" * 64)
        assert not root.exists() or not _files(root)
        path = mod.fetch_dataset(name, url=url, sha256=hashlib.sha256(body).hexdigest(),
                                 unpack=unpack)
        assert mod.resolve_dataset(name) == path
        server.calls.clear()
        assert mod.fetch_dataset(name, url=DEAD, unpack=unpack) == path and not server.calls
        paths[label] = os.path.relpath(path, root)
    assert paths["port"] == paths["jax"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    if kind == "archive":
        assert paths["port"] == "photometry_tables"
        assert not (tmp_path / "port" / fname).exists()
