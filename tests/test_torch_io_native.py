"""The port's Orbitize! HDF5 I/O (`octofitter_tpu_torch/io/orbitize.py`)
and native table reader (`octofitter_tpu_torch/native/`) held to the JAX
package's, on the CPU.

Files written by either package are read by both, with equal columns;
whereistheplanet mirrors are laid out under `tmp_path` in the flat and the
archive layout. The native reader (built with g++ into the package's
git-ignored `_build/`) is held to numpy's text parser, NaN cells
included, and `load_gost_csv` of its columns to `load_gost_csv` of the
file (the `csv`-module path) bit for bit.
"""

import numpy as np
import pytest

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu import native as jnative
from octofitter_tpu.astrom import scanlaw as jscanlaw
from octofitter_tpu_torch import native as tnative
from octofitter_tpu_torch.astrom import scanlaw as tscanlaw
from octofitter_tpu_torch.io import orbitize as torbitize

import chip_smoke

h5py = pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def headline():
    """The headline model (port, CPU) and a chain near its truth."""
    model = chip_smoke.build_model(ot, chip_smoke.bench_table(ot), device="cpu")
    chain = chip_smoke.points_chain(ot, model, chip_smoke.headline_points(ot, model, n=40), 2)
    return model, chain


def _same_chains(got, want):
    assert sorted(got.data) == sorted(want.data)
    for k in want.data:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got.info == want.info


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_orbitize_files_read_alike(headline, tmp_path, writer):
    """A file written by either package: both `loadhdf5` give equal
    columns (tau to tp at the reference epoch 58849), one or two chains;
    the round trip keeps the elements (float32 on disk)."""
    model, chain = headline
    path = tmp_path / "post.hdf5"
    if writer == "port":
        ot.savehdf5(path, model, chain)
    else:
        oc.savehdf5(path, None, oc.Chains(chain.data, chain.internals, chain.info),
                    planet_key="b")
    with h5py.File(path, "r") as f:
        assert f.attrs["tau_ref_epoch"] == torbitize._TAU_REF_EPOCH == 58849.0
    for numchains in (1, 2):
        got = ot.loadhdf5(path, numchains=numchains)
        _same_chains(got, oc.loadhdf5(path, numchains=numchains))
        assert got.n_chains == numchains
    back = ot.loadhdf5(path)
    for col in ("b_a", "b_e", "b_i", "b_omega", "b_Omega", "plx", "M"):
        np.testing.assert_allclose(back.flat(col), chain.flat(col), rtol=1e-6, err_msg=col)
    # tp comes back within one period of the chain's, at the same phase
    P = np.sqrt(chain.flat("b_a") ** 3 / chain.flat("M")) * ot.constants.KEPLER_YEAR_DAYS
    phase = np.mod((back.flat("b_tp") - chain.flat("b_tp")) / P + 0.5, 1.0) - 0.5
    np.testing.assert_allclose(phase, 0.0, atol=1e-5)


def test_orbitize_column_names_and_layouts(tmp_path):
    """Attribute and dataset column names, unnumbered single-planet names
    and a samples-by-row array: the same Chains from both packages."""
    rng = np.random.default_rng(0)
    post = rng.uniform(0.1, 1.0, size=(8, 50))
    variants = {
        "attrs.hdf5": (post, lambda f: f.attrs.__setitem__(
            "parameter_labels", np.array(["sma1", "ecc1", "inc1", "aop1", "pan1", "tau1",
                                          "plx", "mtot"], dtype="S"))),
        "dataset.hdf5": (post.T, lambda f: f.__setitem__(
            "col_names", np.array(["sma", "ecc", "inc", "aop", "pan", "tau", "plx", "mtot"],
                                  dtype="S"))),
        "default.hdf5": (post, lambda f: None),
    }
    for name, (arr, label) in variants.items():
        path = tmp_path / name
        with h5py.File(path, "w") as f:
            f.create_dataset("post", data=arr)
            label(f)
        _same_chains(ot.loadhdf5(path), oc.loadhdf5(path))
        assert "b_tp" in ot.loadhdf5(path).data


def _astrom_table(quant_type):
    dt = np.dtype([("epoch", "f8"), ("object", "i4"), ("quant1", "f8"), ("quant1_err", "f8"),
                   ("quant2", "f8"), ("quant2_err", "f8"), ("quant_type", "S5")])
    rows = [(55000.0 + 10 * k, 1 + (k % 2), 100.0 + k, 1.0, 30.0 + k, 0.5, quant_type)
            for k in range(6)]
    return np.array(rows, dtype=dt)


@pytest.mark.parametrize("layout", ["flat", "archive"])
@pytest.mark.parametrize("quant_type", ["radec", "seppa"])
def test_whereistheplanet_mirror(tmp_path, layout, quant_type):
    """`Whereistheplanet_search` finds a target in a flat `{target}.h5`
    mirror and in the archive's `whereistheplanet-master/data/post_*.hdf5`
    layout; `Whereistheplanet_astrom` reads its table; both as JAX."""
    if layout == "flat":
        path = tmp_path / "hr8799b.h5"
    else:
        (tmp_path / "whereistheplanet-master" / "data").mkdir(parents=True)
        path = tmp_path / "whereistheplanet-master" / "data" / "post_hr8799b.hdf5"
    with h5py.File(path, "w") as f:
        f.create_dataset("post", data=np.ones((8, 4)))
        f.create_dataset("data", data=_astrom_table(quant_type))
    for target in ("HR8799b", "hr 8799 b"):
        assert ot.Whereistheplanet_search(target, tmp_path) == oc.Whereistheplanet_search(
            target, tmp_path) == str(path)
    for obj in (1, 2):
        got = ot.Whereistheplanet_astrom("HR8799b", tmp_path, object_num=obj)
        want = oc.Whereistheplanet_astrom("HR8799b", tmp_path, object_num=obj)
        assert list(got) == list(want) == (
            ["epoch", "ra", "dec", "σ_ra", "σ_dec"] if quant_type == "radec"
            else ["epoch", "sep", "pa", "σ_sep", "σ_pa"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(KeyError, match="similar"):
        ot.Whereistheplanet_search("HR8799c", tmp_path)


def test_native_builds_into_the_build_directory():
    assert tnative.available()
    lib = tnative.library_path()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "octofitter_tpu_torch"
    assert lib.exists()
    assert not list(tnative.SOURCE.parent.glob("*.so"))


@pytest.mark.parametrize("delimiter", [",", None])
def test_native_parser_matches_numpy(tmp_path, delimiter):
    """A numeric table with comments, blank lines and cells that are not
    numbers (NaN): the port's parser, the JAX package's and numpy's
    `genfromtxt` give the same array; a ragged file raises."""
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((40, 5)) * 10.0 ** rng.integers(-8, 8, (40, 5))
    sep = delimiter or "  "
    lines = ["a,b,c,d,e" if delimiter else "a b c d e", "# a comment", ""]
    for k, row in enumerate(arr):
        cells = [repr(float(v)) for v in row]
        if k % 7 == 3:
            cells[k % 5] = "n/a"
        lines.append(sep.join(cells))
    path = tmp_path / "table.txt"
    path.write_text("\n".join(lines) + "\n")
    got = tnative.parse_numeric_table(path, delimiter=delimiter, skip=1)
    want = np.genfromtxt(path, delimiter=delimiter, skip_header=1, comments="#")
    assert np.isnan(want).sum() == 6
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.parse_numeric_table(
        str(path), delimiter=delimiter, skip=1))
    ragged = tmp_path / "ragged.txt"
    ragged.write_text("1,2,3\n4,5\n")
    with pytest.raises(RuntimeError, match="ragged"):
        tnative.parse_numeric_table(ragged, delimiter=",")


def test_load_gost_csv_native_equals_csv_path(tmp_path):
    """`load_gost_csv` of the native reader's columns equals `load_gost_csv`
    of the file (the `csv`-module path) bit for bit, and the JAX package's,
    on `chip_smoke.synth_gost_csv`; `read_csv_columns` alike on its numeric
    columns."""
    path = chip_smoke.synth_gost_csv(tmp_path, n=64, seed=4)
    cols_fast = tnative.read_csv_columns(path)
    fast = tscanlaw.load_gost_csv(cols_fast)
    slow = tscanlaw.load_gost_csv(path)
    cols_slow = tscanlaw.read_csv_columns(path)
    assert list(fast) == list(slow)
    for k in fast:
        np.testing.assert_array_equal(fast[k], slow[k], err_msg=k)
        np.testing.assert_array_equal(fast[k], jscanlaw.load_gost_csv(path)[k], err_msg=k)
    assert list(cols_fast) == list(cols_slow)
    # the columns of numbers; a column of text is all NaN by the csv module
    # and strtod's reading of each cell's leading number by the native one
    numeric = [k for k in cols_slow if np.isfinite(cols_slow[k]).all()]
    assert len(numeric) == 6
    for k in numeric:
        np.testing.assert_array_equal(cols_fast[k], cols_slow[k], err_msg=k)
