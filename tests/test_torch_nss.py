"""The port's Gaia NSS warm start (`octofitter_tpu_torch.nss`) against the
JAX package, on the CPU in float64.

A synthetic DR3 two-body row of the headline truth (`chip_smoke.nss_row`)
is mapped onto the headline model and onto a Thiele-Innes-basis model in
both packages; the Kepler's-third-law fallback, the pseudo-chain and the
CSV reader are compared with JAX's, and the conversion round-trips. The
JAX models are built in a thread started with the module.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import octofitter_tpu as oc
from octofitter_tpu import nss as jnss

import octofitter_tpu_torch as ot
from octofitter_tpu_torch import nss as tnss
from octofitter_tpu_torch.orbits.elements import _thiele_innes_unit

import chip_smoke

TABLE = chip_smoke.bench_table(ot)
ROW = chip_smoke.nss_row(ot)
NO_PLX = {k: v for k, v in ROW.items() if not k.startswith("parallax")}


def build_ti_model(pkg, **model_kw):
    """The headline data on a ThieleInnesOrbit planet (A, B, F, G, e and tp
    free; D = 8)."""
    d = pkg.distributions
    b = pkg.Planet(name="b", basis="ThieleInnesOrbit",
                   variables={**{k: d.Uniform(-1000.0, 1000.0) for k in "ABFG"},
                              "e": d.Uniform(0.0, 0.99), "tp": d.Uniform(55000.0, 62000.0)},
                   observations=[pkg.PlanetRelAstromObs(TABLE, name="simdata")])
    system = pkg.System(name="ti", variables=dict(M=d.truncated(d.Normal(1.2, 0.1), lower=0.1),
                                                  plx=d.truncated(d.Normal(50.0, 0.02), lower=0.1)),
                        companions=[b])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


BUILD = {"headline": lambda pkg, **kw: chip_smoke.build_model(pkg, TABLE, **kw),
         "thiele_innes": build_ti_model}


def _jax_side():
    models = {label: build(oc) for label, build in BUILD.items()}
    return {"mapped": {label: jnss.nss_to_starting_point(ROW, m) for label, m in models.items()},
            "fallback": jnss.nss_to_starting_point(NO_PLX, models["headline"]),
            "chain": jnss.nss_to_model_chain(ROW, models["headline"])}


_POOL = ThreadPoolExecutor(1)
_JAX = _POOL.submit(_jax_side)


@pytest.fixture(scope="module")
def jax_side():
    return _JAX.result()


def test_query_nss_row_csv_and_offline(tmp_path, monkeypatch):
    """A row comes back as a dict; a cached CSV read with the csv module
    gives the row of the asked source_id as pandas reads it in the JAX
    package; gaia_id alone queries the TAP service (here a closed local
    port, with an empty cache) and raises RuntimeError naming row= and
    cache_csv= when the query fails."""
    from octofitter_tpu_torch import net

    monkeypatch.setattr(net, "GAIA_TAP_URL", "http://127.0.0.1:1/tap/sync")
    monkeypatch.setenv("OCTOFITTER_DATA_DIR", str(tmp_path / "data"))
    assert tnss.query_nss(row=ROW) == ROW
    other = dict(ROW, source_id=42, eccentricity=0.5)
    path = tmp_path / "nss.csv"
    cols = list(ROW)
    path.write_text(",".join(cols) + "\n" + "\n".join(
        ",".join(str(r[c]) for c in cols) for r in (other, ROW)) + "\n")
    got = tnss.query_nss(ROW["source_id"], cache_csv=path)
    ref = jnss.query_nss(ROW["source_id"], cache_csv=path)
    assert set(got) == set(ref) == set(ROW)
    for k, v in ref.items():
        assert got[k] == v and type(got[k]) is type(v.item() if hasattr(v, "item") else v), k
    assert tnss.query_nss(cache_csv=path)["source_id"] == 42
    with pytest.raises(KeyError):
        tnss.query_nss(7, cache_csv=path)
    with pytest.raises(RuntimeError, match="row=.*cache_csv="):
        tnss.query_nss(ROW["source_id"])
    with pytest.raises(RuntimeError):
        tnss.query_nss()


def test_ti_to_campbell_round_trips():
    """Campbell angles and a semi-major axis -> Thiele-Innes constants ->
    `ti_to_campbell` returns them within 1e-8 and equals JAX's within
    1e-12; plain numbers need device="cpu" without a GPU."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        i, om, Om = rng.uniform(0.05, 3.0), rng.uniform(0.1, 3.0), rng.uniform(0.1, 3.0)
        alpha = rng.uniform(1.0, 500.0)
        elem = ot.VisualOrbit(**{k: torch.tensor(v, dtype=torch.float64) for k, v in dict(
            a=1.0, e=0.1, i=i, omega=om, Omega=Om, tp=57000.0, M=1.0, plx=1.0).items()})
        abfg = [alpha * float(x) for x in _thiele_innes_unit(elem)]
        got = tnss.ti_to_campbell(*abfg, device="cpu")
        # the branch with omega +- Omega in (-pi, pi]: omega + pi and Omega + pi otherwise
        if abs(om + Om) > math.pi or abs(om - Om) > math.pi:
            om, Om = (om + math.pi) % (2 * math.pi), (Om + math.pi) % (2 * math.pi)
        np.testing.assert_allclose(got, (i, Om, om, alpha), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(got, jnss.ti_to_campbell(*abfg), rtol=1e-12, atol=1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            tnss.ti_to_campbell(*abfg)


@pytest.mark.parametrize("label", list(BUILD))
def test_nss_to_starting_point_matches_jax(jax_side, label):
    """The mapped names and values equal JAX's within 1e-12: the Campbell
    angles (UniformCircular pairs), a and plx on the headline model, the
    constants themselves, e, tp and plx on the Thiele-Innes basis."""
    mt = BUILD[label](ot, device="cpu")
    got, ref = tnss.nss_to_starting_point(ROW, mt), jax_side["mapped"][label]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-12, err_msg=k)
    if label == "headline":
        np.testing.assert_allclose(got["b_a"], chip_smoke.TRUE["a"], rtol=1e-12)
    else:
        assert {"b_A", "b_B", "b_F", "b_G", "b_e", "b_tp", "plx"} == set(got)


def test_third_law_fallback_near_jax(jax_side):
    """Without a parallax, a comes from the period at the median mass of 512
    prior draws: within 0.5% of JAX's (their draws differ)."""
    got = tnss.nss_to_starting_point(NO_PLX, BUILD["headline"](ot, device="cpu"))
    ref = jax_side["fallback"]
    assert "plx" not in got and abs(got["b_a"] / ref["b_a"] - 1) <= 5e-3


def test_nss_to_model_chain_matches_jax(jax_side):
    """The 10,000-draw pseudo-chain equals JAX's column by column within
    1e-12."""
    got = tnss.nss_to_model_chain(ROW, BUILD["headline"](ot, device="cpu"))
    ref = jax_side["chain"]
    assert set(got.data) == set(ref.data)
    for k in ref.data:
        assert got[k].shape == (1, 10_000)
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-12, atol=1e-12, err_msg=k)


def test_initialize_from_nss_sets_finite_starting_points():
    """64 candidates, the mapped values in place, evaluated by one batched
    ln_post: finite starting points, a tensor on the model's device."""
    mt = BUILD["headline"](ot, device="cpu")
    mapped = tnss.initialize_from_nss(mt, ROW, verbosity=0)
    pts = mt.starting_points
    assert isinstance(pts, torch.Tensor) and pts.device == mt.device
    assert pts.shape[1] == mt.D and 0 < pts.shape[0] <= 64 and bool(torch.isfinite(pts).all())
    nat = mt.invlink(pts)
    for k, v in mapped.items():
        np.testing.assert_allclose(nat[:, mt.parameter_names.index(k)].numpy(), v, rtol=1e-9)
    with torch.no_grad():
        assert bool(torch.isfinite(mt.ln_post(pts)).all())
