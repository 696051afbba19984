"""The port's profiling hooks (`utils/profiling.py`) and
`octofit(profile_dir=)`, on the CPU: the JAX package's
tests/test_misc_components.py:350-370 checks, and a trace of a fit that
names the evaluation's operators."""

import functools
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octofitter_tpu.utils import timing_probe as jax_timing_probe

import octofitter_tpu_torch as ot
from octofitter_tpu_torch.utils import profile_trace, timing_probe

import chip_smoke


def _trace_names(directory) -> set:
    files = os.listdir(directory)
    assert len(files) == 1 and files[0].startswith("trace_rank0_pid"), files
    with open(os.path.join(directory, files[0])) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_timing_probe_returns_jax_keys():
    """The first call is timed apart from the steady state: here it builds
    a table, as the port's models do for their lookup tables at first use."""

    @functools.cache
    def table():
        time.sleep(0.05)
        return torch.arange(1000.0)

    def f(x):
        return torch.sum(x * x * table())

    out = timing_probe(f, torch.arange(1000.0), n_iter=5)
    want = jax_timing_probe(lambda x: jnp.sum(x * x), jnp.arange(1000.0), n_iter=5)
    assert out.keys() == want.keys()
    assert out["compile_s"] > 0 and out["per_iter_s"] > 0
    assert out["compile_s"] > out["per_iter_s"]
    np.testing.assert_allclose(out["per_iter_s"] * 5, out["exec_s"])


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        (torch.arange(100.0) ** 2).sum()
    assert "aten::pow" in _trace_names(tmp_path / "prof")


def test_profile_trace_writes_when_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profile_trace(str(tmp_path / "prof")):
            torch.arange(10.0).sum()
            1 / 0
    assert "aten::sum" in _trace_names(tmp_path / "prof")


@pytest.fixture(scope="module")
def headline():
    model = chip_smoke.build_model(ot, chip_smoke.bench_table(ot), device="cpu")
    return model, chip_smoke.headline_points(ot, model)[:8]


def test_octofit_profile_dir_traces_the_evaluation(headline, tmp_path):
    model, pts = headline
    chain = ot.octofit(model, chains=8, adaptation=3, iterations=2, starting_points=pts,
                       verbosity=0, profile_dir=str(tmp_path))
    assert chain.info["n_grad_evals"] > 0
    names = _trace_names(tmp_path)
    # the orbit solve forward and backward (on a CPU tensor, its plain
    # version) and the Kepler solve inside it
    assert {"_OrbitSolve", "_OrbitSolveBackward", "_KeplerSolve"} <= names


def test_profile_dir_from_the_config(headline, tmp_path):
    """OCTOFITTER_PROFILE_DIR sets `profile_dir` (the config's field);
    profile_dir="" turns it off for one call."""
    model, pts = headline
    old = ot.get_config().profile_dir
    try:
        ot.set_config(profile_dir=str(tmp_path / "cfg"))
        ot.octofit(model, chains=8, adaptation=2, iterations=1, starting_points=pts, verbosity=0)
        ot.octofit(model, chains=8, adaptation=2, iterations=1, starting_points=pts, verbosity=0,
                   profile_dir=str(tmp_path / "arg"))
        ot.octofit(model, chains=8, adaptation=2, iterations=1, starting_points=pts, verbosity=0,
                   profile_dir="")
    finally:
        ot.set_config(profile_dir=old)
    assert "_OrbitSolve" in _trace_names(tmp_path / "cfg")
    assert "_OrbitSolve" in _trace_names(tmp_path / "arg")
    assert sorted(os.listdir(tmp_path)) == ["arg", "cfg"]
    from octofitter_tpu_torch.config import config_from_env

    assert config_from_env({"OCTOFITTER_PROFILE_DIR": "/x"}).profile_dir == "/x"
