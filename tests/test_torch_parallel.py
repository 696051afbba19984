"""The port's `parallel/` on `torch.distributed`, on the CPU in float64.

Four gloo ranks, started once for the file through a file:// store
(`tests/_torch_parallel_child.py`, which imports no JAX), run every
multi-rank check: epoch sharding, the one-replica-per-rank DEO swap,
`octofit_pigeons(mesh=)` over (walkers, rungs) = (2, 2) ranks with the HMC
explorer and over four walker ranks with NUTS, a resume under the mesh, a
one-rank mesh, and `octofit_sharded` on the headline model over two ranks.
Meanwhile this process runs the JAX package's side on its 8-device CPU mesh
(tests/conftest.py). The sharded runs are held to the port's own unsharded
ones at the bounds of tests/test_parallel.py:304-359, and to JAX's
functions and JAX's mesh run; `resolve_distributed_config` to JAX's on the
same environments.
"""

import math
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import octofitter_tpu as oc
from octofitter_tpu import parallel as jpar
from octofitter_tpu.astrom.fitting import prepare_A_5param
from octofitter_tpu.samplers.tempering import octofit_pigeons as jax_pigeons

import octofitter_tpu_torch as ot
from octofitter_tpu_torch import parallel as tpar
from tests import _torch_parallel_child as child

LOGZ_TRUE = -0.5 * (1.0 / 1.25) - 0.5 * math.log(2 * math.pi * 1.25)
# the bounds of tests/test_torch_tempering.py:218-235 for the HMC explorer
MEAN_TOL, VAR_TOL, LOGZ_TOL = 0.05, 0.05, 0.2
SPAWN_TIMEOUT_S = 300


def _jax_uniforms():
    """The uniform each replica draws from its key in
    tests/test_parallel.py:test_sharded_pt_swap_collective."""
    keys = jax.random.split(jax.random.PRNGKey(0), child.WORLD)
    return [float(jax.random.uniform(k)) for k in keys]


def _jax_side():
    """JAX's epoch-sharding results on its 8-device mesh, its swap on 4
    devices, and its octofit_pigeons(mesh=) over a (4, 2) mesh."""
    mesh8 = Mesh(np.array(jax.devices()[:8]), axis_names=("epochs",))
    d = child.epoch_data()

    def term(x, s):
        return -0.5 * (x / s) ** 2 - jnp.log(s)

    x, s = jnp.asarray(d["x"]), jnp.asarray(d["s"])
    out = {"epoch_sum": float(jpar.sharded_epoch_sum(term, (x, s), mesh8)),
           "epoch_sum_w": float(jpar.sharded_epoch_sum(term, (x, s), mesh8,
                                                       weights=jnp.asarray(d["w"])))}
    f = d["fit"]
    A = prepare_A_5param(f["epochs"], f["cphi"], f["sphi"], f["parf"], 58000.0, 58000.0)
    fit = jpar.sharded_fit_5param(A, jnp.asarray(f["cphi"]), jnp.asarray(f["sphi"]),
                                  jnp.asarray(f["dalpha"]), jnp.asarray(f["ddelta"]), mesh8,
                                  weights=jnp.asarray(f["w"]), include_chi2=True, sigma=0.25,
                                  n_rows=len(f["epochs"]))
    out["fit"] = dict(parameters=[float(p) for p in fit["parameters"]],
                      chi2=float(fit["chi_squared_astro"]))
    out["dr4_ll"] = float(jpar.sharded_gaia_dr4_ll(d["table"], jnp.asarray(d["model_al"]),
                                                   jnp.asarray(d["jitter"]), mesh8))

    # the swap, one replica per device, as test_sharded_pt_swap_collective
    mesh4 = Mesh(np.array(jax.devices()[:child.WORLD]), axis_names=("temps",))
    theta, ll, betas = child.swap_data()
    keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(0), child.WORLD))
    swap = jpar.sharded_pt_swap_step("temps")
    out["swap"] = {}
    for even in (True, False):
        def per_device(th, l, b, k, even=even):
            t2, l2, sw = swap(th[0], l[0], b[0], jnp.asarray(even),
                              jax.random.wrap_key_data(k[0]))
            return t2[None], l2[None], sw[None]

        f_sm = shard_map(per_device, mesh=mesh4, in_specs=(P("temps"),) * 4,
                         out_specs=(P("temps"),) * 3)
        out["swap"][even] = tuple(np.asarray(v) for v in jax.jit(f_sm)(
            jnp.asarray(theta), jnp.asarray(ll), jnp.asarray(betas), keys))

    mesh42 = Mesh(np.array(jax.devices()).reshape(4, 2), axis_names=("walkers", "rungs"))
    chain, info = jax_pigeons(child.conjugate(oc), key=jax.random.PRNGKey(0), mesh=mesh42,
                              **child.PT_SLICE)
    out["pt_slice"] = dict(x=chain.flat("x"), logz=info["logevidence"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results (list by rank) and JAX's, computed together:
    JAX in a thread of this process while the ranks run."""
    directory = tmp_path_factory.mktemp("ranks")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(_jax_side)
        ctx = torch.multiprocessing.spawn(
            child.run_rank, args=(f"file://{directory}/store", str(directory), _jax_uniforms()),
            nprocs=child.WORLD, join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"the ranks did not end within {SPAWN_TIMEOUT_S} s")
        ranks = []
        for r in range(child.WORLD):
            with open(directory / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        assert all(not p.is_alive() for p in ctx.processes)
        t_ranks = time.perf_counter() - t0
        jax_res = jax_side.result()
    print(f"ranks {t_ranks:.1f} s, with JAX's side {time.perf_counter() - t0:.1f} s")
    return {"ranks": ranks, "jax": jax_res}


# --------------------------------------------------------------------------
# the runtime wiring (no ranks)
# --------------------------------------------------------------------------

CONFIG_ENVS = [
    {},
    {"OCTOFITTER_COORDINATOR": "10.0.0.1:1234", "OCTOFITTER_NUM_PROCESSES": "4",
     "OCTOFITTER_PROCESS_ID": "2"},
    {"SLURM_NTASKS": "8", "SLURM_PROCID": "3", "SLURM_JOB_NODELIST": "tpu-host[0-7]"},
    {"OCTOFITTER_COORDINATOR": "h:1", "SLURM_NTASKS": "2", "SLURM_PROCID": "1"},
]


@pytest.mark.parametrize("env", CONFIG_ENVS)
def test_resolve_distributed_config_matches_jax(env):
    assert tpar.resolve_distributed_config(env=env) == jpar.resolve_distributed_config(env=env)


@pytest.mark.parametrize("env", [{"OCTOFITTER_NUM_PROCESSES": "4"}, {"SLURM_NTASKS": "4"},
                                 {"WORLD_SIZE": "4"}])
def test_incomplete_config_raises(env):
    jax_env = {k.replace("WORLD_SIZE", "JAX_NUM_PROCESSES"): v for k, v in env.items()}
    with pytest.raises(ValueError, match="incomplete"):
        jpar.resolve_distributed_config(env=jax_env)
    with pytest.raises(ValueError, match="incomplete"):
        tpar.resolve_distributed_config(env=env)


def test_torchrun_names_resolve_as_jax_names():
    torchrun = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "4", "RANK": "2"}
    jax_env = {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4",
               "JAX_PROCESS_ID": "2"}
    assert tpar.resolve_distributed_config(env=torchrun) == \
        jpar.resolve_distributed_config(env=jax_env)


def test_initialize_distributed_without_a_card_or_a_group():
    # one process: nothing to join, as in the JAX package
    assert tpar.initialize_distributed(dict(coordinator_address="x:1", num_processes=1,
                                            process_id=0)) is False
    # several, with no GPU and no device="cpu": raises before joining
    with pytest.raises(RuntimeError, match="no GPU"):
        tpar.initialize_distributed(dict(coordinator_address="localhost:1", num_processes=2,
                                         process_id=0))
    with pytest.raises(RuntimeError, match="initialize_distributed first"):
        tpar.global_mesh(("chains",))


_LAUNCHER_NAMES = ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE",
                   "SLURM_TASKS_PER_NODE")


@pytest.mark.parametrize("env, n, pid, cards, device, want", [
    # torchrun, 4 hosts x 4 cards
    ({"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "3"}, 16, 7, 4, None, ("cuda:3", "nccl")),
    # Slurm, 4 nodes x 4 tasks, with and without --ntasks-per-node
    ({"SLURM_NTASKS_PER_NODE": "4", "SLURM_LOCALID": "2"}, 16, 6, 4, None, ("cuda:2", "nccl")),
    ({"SLURM_TASKS_PER_NODE": "4(x4)", "SLURM_LOCALID": "1"}, 16, 5, 4, None, ("cuda:1", "nccl")),
    # a node with 5 tasks for 4 cards: every rank picks gloo
    ({"SLURM_TASKS_PER_NODE": "5,4(x2)", "SLURM_LOCALID": "4"}, 13, 4, 4, None, ("cuda:0", "gloo")),
    # two ranks on one card
    ({"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "1"}, 2, 1, 1, None, ("cuda:0", "gloo")),
    # OCTOFITTER_* names: a world no larger than one host's cards
    ({}, 4, 2, 4, None, ("cuda:2", "nccl")),
    # the CPU, asked for, with or without cards
    ({}, 16, 3, 0, "cpu", ("cpu", "gloo")),
    ({"LOCAL_WORLD_SIZE": "4"}, 16, 3, 4, "cpu", ("cpu", "gloo")),
    # more ranks than one host's cards, and nothing says how they share hosts
    ({}, 16, 3, 4, None, "LOCAL_WORLD_SIZE"),
    ({}, 16, 3, 4, "cuda:1", "LOCAL_WORLD_SIZE"),
    # hosts known, but not which card is this rank's
    ({"LOCAL_WORLD_SIZE": "4"}, 16, 3, 4, None, "LOCAL_RANK"),
])
def test_initialize_distributed_places_ranks_by_the_launcher(monkeypatch, env, n, pid, cards,
                                                             device, want):
    """The backend and device rule over torchrun's, Slurm's and the
    OCTOFITTER_* environments, with the card count stubbed and the group's
    start captured."""
    import torch.distributed as dist

    for name in _LAUNCHER_NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    started = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: started.update(backend=backend, **kw))
    placed = []
    monkeypatch.setattr(tpar.distributed, "_record_placement", placed.append)
    config = dict(coordinator_address="node0:8476", num_processes=n, process_id=pid)
    if isinstance(want, str):
        with pytest.raises(RuntimeError, match=want):
            tpar.initialize_distributed(config, device=device)
        assert not started
        return
    assert tpar.initialize_distributed(config, device=device) is True
    assert (str(placed[0]), started["backend"]) == want
    assert started["init_method"] == "tcp://node0:8476"
    assert (started["world_size"], started["rank"]) == (n, pid)
    assert started.get("device_id") == (placed[0] if want[1] == "nccl" else None)


def test_chain_mesh_outside_a_group():
    """No card: the default raises, device="cpu" gives a one-rank gloo mesh
    on the CPU whose group the caller ends; octofit_sharded with no mesh
    runs on the model's device and ends the group it started."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no GPU"):
        tpar.chain_mesh()
    mesh = tpar.chain_mesh(device="cpu")
    try:
        assert (mesh.device_type, mesh.size(), mesh.mesh_dim_names) == ("cpu", 1, ("chains",))
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="process group on cpu"):
            tpar.chain_mesh(device="cuda")
    finally:
        dist.destroy_process_group()
    m = child.conjugate(ot, device="cpu")
    chain = tpar.octofit_sharded(m, chains=4, adaptation=2, iterations=2, verbosity=0)
    x = np.asarray(chain.data["x"])
    assert x.size == 8 and np.isfinite(x).all()
    assert not dist.is_initialized()


def test_mesh_that_is_no_device_mesh_raises():
    m = child.conjugate(ot, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ot.octofit_pigeons(m, explorer="hmc", mesh=object(), verbosity=0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ot.octofit(m, chains=4, mesh=object(), verbosity=0)


# --------------------------------------------------------------------------
# epoch sharding and the swap against JAX's functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["epoch_sum", "epoch_sum_w", "dr4_ll"])
def test_epoch_sums_match_jax(runs, key):
    for res in runs["ranks"]:
        np.testing.assert_allclose(res[key], runs["jax"][key], rtol=1e-12)


def test_sharded_fit_5param_matches_jax(runs):
    want = runs["jax"]["fit"]
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["fit"]["parameters"], want["parameters"], rtol=1e-12)
        np.testing.assert_allclose(res["fit"]["chi2"], want["chi2"], rtol=1e-12)


@pytest.mark.parametrize("even", [True, False])
def test_sharded_pt_swap_step_matches_jax(runs, even):
    th_j, ll_j, sw_j = runs["jax"]["swap"][even]
    got = [res["swap"][even] for res in runs["ranks"]]
    np.testing.assert_allclose(np.stack([g[0] for g in got]), th_j, rtol=1e-12)
    np.testing.assert_allclose([g[1] for g in got], ll_j, rtol=1e-12)
    swapped = [g[2] for g in got]
    assert swapped == list(sw_j)
    # both partners of every active pair swap, or neither
    for i in range(0 if even else 1, child.WORLD - 1, 2):
        assert swapped[i] == swapped[i + 1]


def test_swap_passes_exchange_replicas(runs):
    """Some pair swaps in the two passes, so the comparison above holds
    moved states as well as kept ones."""
    assert any(res["swap"][even][2] for res in runs["ranks"] for even in (True, False))


# --------------------------------------------------------------------------
# octofit_pigeons(mesh=) against the port's mesh=None and JAX's mesh run
# --------------------------------------------------------------------------

def test_pigeons_mesh_one_round_matches_unsharded(runs):
    got, want = runs["ranks"][0]["pt1"], runs["ranks"][0]["pt1_none"]
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-12)
    assert got["round_trips"] == want["round_trips"]
    np.testing.assert_array_equal(got["rejection"], want["rejection"])


def test_pigeons_mesh_four_rounds_match_unsharded(runs):
    got, want = runs["ranks"][0]["pt4"], runs["ranks"][0]["pt4_none"]
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-6)
    assert got["round_trips"] == want["round_trips"] > 0
    np.testing.assert_allclose(got["rejection"], want["rejection"], atol=1e-12)
    np.testing.assert_allclose(got["logz"], want["logz"], atol=1e-6)
    # the swap and the reads went through the group
    assert got["collectives"]["calls"] > 0 and want["collectives"]["calls"] == 0


def test_pigeons_nuts_over_the_walker_axis_matches_unsharded(runs):
    """Trees stop when no chain of any rank is building: the ranks draw
    what the unsharded ladder draws."""
    got, want = runs["ranks"][0]["pt_nuts"], runs["ranks"][0]["pt_nuts_none"]
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-12)
    assert got["n_grad_evals"] == want["n_grad_evals"]
    assert got["rank_grad_evals"] == [want["n_grad_evals"]] * child.WORLD
    assert got["round_trips"] == want["round_trips"]
    np.testing.assert_array_equal(got["rejection"], want["rejection"])


def test_pigeons_mesh_resume_is_bit_identical(runs):
    for res in runs["ranks"]:
        np.testing.assert_array_equal(res["pt_resumed"]["x"], res["pt_ckpt"]["x"])
        assert res["pt_resumed"]["logz"] == res["pt_ckpt"]["logz"]
        assert res["pt_resumed"]["round_trips"] == res["pt_ckpt"]["round_trips"]


def test_pigeons_one_rank_mesh_gives_the_bits_of_no_mesh(runs):
    for res in runs["ranks"]:
        got, want = res["pt_one_rank"], res["pt_one_rank_none"]
        np.testing.assert_array_equal(got["x"], want["x"])
        np.testing.assert_array_equal(got["logpost"], want["logpost"])
        assert got["logz"] == want["logz"]
        assert got["collectives"]["calls"] > 0


@pytest.mark.parametrize("key", ["pt1", "pt4", "pt_slice", "pt_nuts", "pt_ckpt"])
def test_pigeons_mesh_result_is_the_same_on_every_rank(runs, key):
    first = runs["ranks"][0][key]
    for res in runs["ranks"][1:]:
        np.testing.assert_array_equal(res[key]["x"], first["x"])
        np.testing.assert_array_equal(res[key]["logpost"], first["logpost"])
        assert res[key]["logz"] == first["logz"]
        assert res[key]["round_trips"] == first["round_trips"]


def test_pigeons_mesh_agrees_with_jax_mesh_run(runs):
    """JAX over its (4, 2) mesh and the port over (2, 2) ranks, on the
    conjugate model: posterior mean, variance and evidence at the bounds of
    tests/test_torch_tempering.py, against each other and the truth."""
    got, want = runs["ranks"][0]["pt_slice"], runs["jax"]["pt_slice"]
    assert abs(got["x"].mean() - want["x"].mean()) < MEAN_TOL
    assert abs(got["x"].var() - want["x"].var()) < VAR_TOL
    assert abs(got["logz"] - want["logz"]) < LOGZ_TOL
    assert abs(got["x"].mean() - 0.8) < MEAN_TOL
    assert abs(got["x"].var() - 0.2) < VAR_TOL
    assert abs(got["logz"] - LOGZ_TRUE) < LOGZ_TOL


# --------------------------------------------------------------------------
# octofit_sharded: 2 ranks x 8 chains against octofit at 16
# --------------------------------------------------------------------------

# measured on the CPU: ChEES 10 + 5 draws within 3.1e-13, step size within
# 4.8e-12 (relative 1e-10 here), metric within 1.1e-18: the ranks' sums
# differ from one sum in their last bits, and 15 adaptive transitions carry
# that forward
SHARDED_TOL = dict(draws=1e-10, step_size=1e-10, sigma=1e-12)


@pytest.mark.parametrize("sampler", ["chees", "nuts", "hmc"])
def test_octofit_sharded_matches_octofit(runs, sampler):
    got, want = runs["ranks"][0][f"sharded_{sampler}"], runs["ranks"][0][f"single_{sampler}"]
    assert got["data"].keys() == want["data"].keys()
    for k in want["data"]:
        np.testing.assert_allclose(got["data"][k], want["data"][k], rtol=SHARDED_TOL["draws"],
                                   atol=SHARDED_TOL["draws"])
    np.testing.assert_allclose(got["step_size"], want["step_size"], rtol=SHARDED_TOL["step_size"])
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=0, atol=SHARDED_TOL["sigma"])
    assert got["n_grad_evals"] == want["n_grad_evals"]
    np.testing.assert_array_equal(got["internals"]["tree_depth"], want["internals"]["tree_depth"])
    np.testing.assert_array_equal(got["internals"]["n_steps"], want["internals"]["n_steps"])
    # equal acceptance decisions: each chain moves at the same draws
    x_g, x_w = got["data"]["b_a"], want["data"]["b_a"]
    np.testing.assert_array_equal(np.diff(x_g, axis=1) != 0, np.diff(x_w, axis=1) != 0)


@pytest.mark.parametrize("sampler", ["chees", "nuts", "hmc"])
def test_octofit_sharded_chains_are_the_same_on_every_rank(runs, sampler):
    first = runs["ranks"][0][f"sharded_{sampler}"]
    assert next(iter(first["data"].values())).shape[0] == child.SHARDED["chains"]
    for res in runs["ranks"][1:]:
        got = res[f"sharded_{sampler}"]
        for part in ("data", "internals"):
            for k, v in first[part].items():
                np.testing.assert_array_equal(got[part][k], v)
        np.testing.assert_array_equal(got["step_size"], first["step_size"])
