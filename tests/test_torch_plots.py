"""The port's plots (`octofitter_tpu_torch/plots/`) held to the JAX
package's, artist for artist, on the CPU in float64.

Models come from chip_smoke's model functions in both packages, built once per
module; no sampler runs: each chain is made from seeded numpy draws near
the model's truth (`chip_smoke.points_chain`, one table for both
packages). Every figure is drawn by both packages from the same chain and
the same draws (both choose them with `default_rng(0)`), and every line's
`get_xydata()`, every collection's offsets and segments, and every text
are compared: arrays in float64 within rtol 1e-9 of the JAX package's
value, with an absolute floor of 1e-9 times the largest magnitude in that
array (a track that crosses zero has entries far below its scale).
"""

import importlib
import os
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import octofitter_tpu as oc  # noqa: E402
import octofitter_tpu_torch as ot  # noqa: E402
from octofitter_tpu import plots as jplots  # noqa: E402
from octofitter_tpu_torch import plots as tplots  # noqa: E402
from octofitter_tpu_torch.plots import panels as tpanels  # noqa: E402

import chip_smoke  # noqa: E402

# the module, not the function `plots.octoplot` that shadows its name
toctoplot = importlib.import_module("octofitter_tpu_torch.plots.octoplot")

RTOL = 1e-9
N_DRAWS = 6  # JAX solves each draw by itself, op by op: keep its loops short


def _chains(model_t, theta_t, n_chains=2):
    """The same Chains in both packages from unconstrained points."""
    ch = chip_smoke.points_chain(ot, model_t, theta_t, n_chains)
    return (oc.Chains(ch.data, ch.internals, ch.info),
            ot.Chains(ch.data, ch.internals, ch.info))


@pytest.fixture(scope="module")
def headline():
    table = chip_smoke.bench_table(ot)
    mj = chip_smoke.build_model(oc, table)
    mt = chip_smoke.build_model(ot, table, device="cpu")
    cj, ct = _chains(mt, chip_smoke.headline_points(ot, mt, n=24))
    return mj, mt, cj, ct


@pytest.fixture(scope="module")
def joint():
    data = chip_smoke.joint_data(ot)
    mj = chip_smoke.build_joint_model(oc, data)
    mt = chip_smoke.build_joint_model(ot, data, device="cpu")
    cj, ct = _chains(mt, chip_smoke.joint_points_near_truth(ot, mt, 24, seed=0))
    return mj, mt, cj, ct


@pytest.fixture(scope="module")
def rvgp():
    data = chip_smoke.rvgp_data(ot)
    mj = chip_smoke.build_rvgp_model(oc, data)
    mt = chip_smoke.build_rvgp_model(ot, data, device="cpu")
    cj, ct = _chains(mt, chip_smoke.rvgp_points_near_truth(ot, mt, 24, seed=0))
    return mj, mt, cj, ct


@pytest.fixture(scope="module")
def dr4():
    table = chip_smoke.dr4_data(ot)
    mj = chip_smoke.build_dr4_model(oc, table)
    mt = chip_smoke.build_dr4_model(ot, table, device="cpu")
    theta = mt.link(mt.tensor([[chip_smoke.DR4_TRUTH[n] for n in mt.parameter_names]]))
    rng = np.random.default_rng(0)
    cj, ct = _chains(mt, theta + torch.as_tensor(1e-3 * rng.standard_normal((24, mt.D))))
    return mj, mt, cj, ct


# ---------------------------------------------------------------------------
def _all_axes(fig):
    axes = list(fig.axes)
    for sub in getattr(fig, "subfigs", []):
        axes += [a for a in _all_axes(sub) if a not in axes]
    return axes


def _close(got, want, what):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size:
        scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0.0
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def assert_same_figure(fig_t, fig_j):
    """Every axes' lines, collections, patches' count and texts alike."""
    axes_t, axes_j = _all_axes(fig_t), _all_axes(fig_j)
    assert len(axes_t) == len(axes_j)
    for k, (at, aj) in enumerate(zip(axes_t, axes_j)):
        assert len(at.lines) == len(aj.lines), (k, len(at.lines), len(aj.lines))
        for i, (lt, lj) in enumerate(zip(at.lines, aj.lines)):
            _close(lt.get_xydata(), lj.get_xydata(), f"axes {k} line {i}")
            assert lt.get_color() == lj.get_color() and lt.get_alpha() == lj.get_alpha()
            assert lt.get_label() == lj.get_label()
        assert len(at.collections) == len(aj.collections)
        for i, (ct, cj) in enumerate(zip(at.collections, aj.collections)):
            _close(ct.get_offsets(), cj.get_offsets(), f"axes {k} collection {i}")
            if hasattr(cj, "get_segments"):
                for s_t, s_j in zip(ct.get_segments(), cj.get_segments()):
                    _close(s_t, s_j, f"axes {k} collection {i} segment")
            assert ct.get_label() == cj.get_label()
        assert len(at.patches) == len(aj.patches)
        for p_t, p_j in zip(at.patches, aj.patches):
            _close(p_t.get_path().vertices, p_j.get_path().vertices, f"axes {k} patch")
        assert [t.get_text() for t in at.texts] == [t.get_text() for t in aj.texts]
        assert (at.get_xlabel(), at.get_ylabel()) == (aj.get_xlabel(), aj.get_ylabel())
        assert at.xaxis_inverted() == aj.xaxis_inverted()


def _fig(out):
    while isinstance(out, (list, tuple, np.ndarray)):
        out = out[0]
    return out if isinstance(out, matplotlib.figure.Figure) else out.get_figure()


def _both(fn_t, fn_j, *args, **kwargs):
    fig_t, fig_j = _fig(fn_t(*args[0], **kwargs)), _fig(fn_j(*args[1], **kwargs))
    try:
        assert_same_figure(fig_t, fig_j)
    finally:
        plt.close("all")


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["headline", "joint"])
def test_octoplot_matches_jax(case, request):
    mj, mt, cj, ct = request.getfixturevalue(case)
    _both(ot.octoplot, oc.octoplot, (mt, ct), (mj, cj), n_draws=N_DRAWS, fname="")


def test_astromplot_marks_match_jax(headline, capsys):
    mj, mt, cj, ct = headline
    marks = [58000.0, 59000.5]
    tplots.astromplot(mt, ct, n_draws=N_DRAWS, mark_epochs_mjd=marks)
    printed_t = capsys.readouterr().out
    plt.close("all")
    oc.plots.astromplot(mj, cj, n_draws=N_DRAWS, mark_epochs_mjd=marks)
    printed_j = capsys.readouterr().out
    plt.close("all")
    assert printed_t == printed_j and printed_t.count("epoch MJD") == 2
    _both(tplots.astromplot, jplots.astromplot, (mt, ct), (mj, cj), n_draws=N_DRAWS,
          mark_epochs_mjd=marks, verbosity=0)


@pytest.mark.parametrize("name", ["physorbitplot", "astromtimeplot", "skytrackplot",
                                  "dotplot", "masspostplot"])
def test_panel_matches_jax(name, joint):
    mj, mt, cj, ct = joint
    kwargs = {} if name in ("skytrackplot", "dotplot", "masspostplot") else {"n_draws": N_DRAWS}
    _both(getattr(tplots, name), getattr(jplots, name), (mt, ct), (mj, cj), **kwargs)


@pytest.mark.parametrize("name", ["hgcaplot", "rvtimeplot", "pmaplot"])
def test_joint_pm_and_rv_panels_match_jax(name, joint):
    mj, mt, cj, ct = joint
    _both(getattr(tplots, name), getattr(jplots, name), (mt, ct), (mj, cj), n_draws=N_DRAWS)


@pytest.mark.parametrize("name", ["rvpostplot", "rvtimeplot"])
def test_rv_gp_panels_match_jax(name, rvgp):
    """examples/03's RadialVelocityOrbit model: the Keplerian draws and,
    for rvpostplot, the MAP draw's GP prediction (`gp_predict`)."""
    mj, mt, cj, ct = rvgp
    _both(getattr(tplots, name), getattr(jplots, name), (mt, ct), (mj, cj), n_draws=N_DRAWS)


@pytest.mark.parametrize("name", ["gaiatimeplot", "gaiastarplot"])
def test_dr4_panels_match_jax(name, dr4):
    mj, mt, cj, ct = dr4
    kwargs = {"n_draws": N_DRAWS} if name == "gaiatimeplot" else {}
    _both(getattr(tplots, name), getattr(jplots, name), (mt, ct), (mj, cj), **kwargs)


def test_per_draw_tracks_of_absolute_visual_match_jax():
    """The one-period tracks of a basis without the per-orbit-epoch solve
    (one `orbitsolve` per draw): chip_smoke's AbsoluteVisual{KepOrbit}
    model at prior draws."""
    table = chip_smoke.bench_table(ot)
    mj = chip_smoke.build_basis_model(oc, chip_smoke.ABSOLUTE, table)
    mt = chip_smoke.build_basis_model(ot, chip_smoke.ABSOLUTE, table, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cj, ct = _chains(mt, mt.link(mt.sample_priors(gen, 8)))
    for name in ("astromplot", "physorbitplot"):
        _both(getattr(tplots, name), getattr(jplots, name), (mt, ct), (mj, cj), n_draws=4)


def test_octocorner_matches_jax(headline):
    """The histogram heights (patches) and the `small=True` variables."""
    mj, mt, cj, ct = headline
    fig_t = ot.octocorner(mt, ct, small=True)
    fig_j = oc.octocorner(mj, cj, small=True)
    try:
        labels = lambda f: [a.get_xlabel() for a in f.axes if a.get_visible()]  # noqa: E731
        assert labels(fig_t) == labels(fig_j) and len(labels(fig_t)) > 2
        assert_same_figure(fig_t, fig_j)
    finally:
        plt.close("all")


def test_sbc_plots_match_jax():
    rng = np.random.default_rng(0)
    results = {"a": {"ranks": rng.uniform(size=64), "ks_distance": 0.1},
               "e": rng.uniform(size=64), "M": {"ranks": rng.uniform(size=64)}}
    _both(tplots.calibrationplots, jplots.calibrationplots, (results,), (results,))
    _both(tplots.sbc_corner, jplots.sbc_corner, (results,), (results,))


def test_completenessplot_matches_jax():
    rng = np.random.default_rng(1)
    seps, masses = np.linspace(1.0, 10.0, 6), np.linspace(1.0, 20.0, 5)
    comp = np.clip(rng.uniform(size=(5, 6)) + np.linspace(0, 1, 6), 0, 1)
    kw = dict(separations=seps, masses=masses, completeness=comp,
              n_detected=np.round(comp * 5), n_total=np.full(comp.shape, 5))
    cmap_t, cmap_j = ot.CompletenessMap(**kw), oc.CompletenessMap(**kw)
    _both(tplots.completenessplot, jplots.completenessplot, (cmap_t,), (cmap_j,))


def test_plots_exports_match_jax():
    assert tplots.__all__ == jplots.__all__ and len(tplots.__all__) == 19
    assert all(callable(getattr(tplots, n)) for n in tplots.__all__)


def test_one_orbitsolve_per_shared_grid(joint, monkeypatch):
    """A CPU model's panel solves all its draws at once: one `orbitsolve`
    per planet for each grid of epochs the draws share, and the per-draw
    tracks in one composed solve with per-orbit epochs (calls counted by
    wrappers)."""
    _, mt, _, ct = joint
    calls = []
    real, real_tracks = ot.orbits.orbitsolve, toctoplot._kep_visual_fields

    def counting(elem, t, **kw):
        calls.append(tuple(torch.as_tensor(t).shape))
        return real(elem, t, **kw)

    def counting_tracks(elem, t, **kw):
        calls.append(("tracks",) + tuple(t.shape))
        return real_tracks(elem, t, **kw)

    monkeypatch.setattr(toctoplot, "orbitsolve", counting)
    monkeypatch.setattr(tpanels, "orbitsolve", counting)
    monkeypatch.setattr(toctoplot, "_kep_visual_fields", counting_tracks)
    for name, fn, want in (
            ("rvtimeplot", toctoplot._rvtimeplot_arrays, [(500,)]),
            ("pmaplot", toctoplot._pmaplot_arrays, [(400,)]),
            ("hgcaplot", tpanels._hgcaplot_arrays, [(400,)]),
            ("astromtimeplot", tpanels._astromtimeplot_arrays, [(400,)]),
            ("physorbitplot", tpanels._physorbitplot_arrays, [("tracks", N_DRAWS, 200)]),
            ("astromplot", lambda m, c, n_draws: toctoplot._astromplot_arrays(
                m, c, n_draws=n_draws, mark_epochs_mjd=[57000.0, 58000.0]),
             [("tracks", N_DRAWS, 200), (2,)])):
        calls.clear()
        out = fn(mt, ct, n_draws=N_DRAWS)
        assert calls == want, name
        assert all(np.isfinite(np.asarray(v, dtype=float)).all()
                   for v in out.values() if isinstance(v, np.ndarray)), name


def test_import_without_matplotlib_h5py_pandas(tmp_path):
    """The package imports with matplotlib, h5py and pandas unavailable; a
    drawing function then raises an ImportError that names it."""
    script = tmp_path / "blocked.py"
    script.write_text(
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'h5py', 'pandas'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})\n"
        "import octofitter_tpu_torch as ot\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'h5py', 'pandas', 'jax')]\n"
        "try:\n"
        "    ot.plots.completenessplot(None)\n"
        "except ImportError as e:\n"
        "    assert 'completenessplot' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
