"""The ranks of tests/test_torch_parallel.py: every multi-rank check of the
port's `parallel/` in one process group of four gloo ranks on the CPU.

`run_rank` joins the group through a file:// store, runs each check, and
pickles what it computed into `<out_dir>/rank<r>.pkl`; the test module
compares those with the JAX package's results and with the port's own
unsharded runs. This module imports no JAX, so that the ranks never load
it; the data the JAX side needs comes from the functions below, which
both sides call.
"""

import os
import pickle
import sys
import traceback

import numpy as np

WORLD = 4
SWAP_D = 3
# the conjugate model's ladders: one round and four (tests/test_parallel.py:
# 304-359), the slice against JAX (tests/test_torch_tempering.py's HMC case)
PT_SMALL = dict(n_chains=4, n_walkers=8, explorer="hmc", explorer_n_leapfrog=8, verbosity=0)
PT_SLICE = dict(n_rounds=6, n_walkers=32, n_chains=8, explorer="hmc", explorer_n_leapfrog=8,
                verbosity=0)
PT_NUTS = dict(n_rounds=1, n_chains=4, n_walkers=8, explorer="nuts", explorer_max_depth=5,
               verbosity=0)
PT_ONE_RANK = dict(n_rounds=2, n_chains=4, n_chains_variational=4, n_walkers=8,
                   explorer="chees", verbosity=0)
SHARDED = dict(chains=16, adaptation=10, iterations=5, verbosity=0)


def epoch_data():
    """tests/test_parallel.py's epoch-sharding inputs (numpy seeds 0-2)."""
    rng = np.random.default_rng(0)
    n = 10_007  # no multiple of 4 or 8
    x, s = rng.standard_normal(n), rng.uniform(0.5, 2.0, n)
    w = rng.uniform(0, 2, n)

    rng = np.random.default_rng(1)
    m = 12_345
    epochs = np.sort(rng.uniform(57000, 60000, m))
    phi = rng.uniform(0, 2 * np.pi, m)
    fit = dict(epochs=epochs, cphi=np.cos(phi), sphi=np.sin(phi),
               parf=rng.uniform(-0.7, 0.7, m))
    fit.update(dalpha=rng.standard_normal(m) * 0.3, ddelta=rng.standard_normal(m) * 0.3,
               w=rng.integers(0, 3, m).astype(float))

    rng = np.random.default_rng(2)
    k = 20_011
    table = dict(centroid_pos_al=rng.standard_normal(k) * 0.1,
                 centroid_pos_error_al=rng.uniform(0.02, 0.2, k))
    model_al = rng.standard_normal(k) * 0.05
    return dict(x=x, s=s, w=w, fit=fit, table=table, model_al=model_al, jitter=0.03)


def swap_data():
    """One replica per rank: theta (4, 3), ll (4,), betas (4,)."""
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((WORLD, SWAP_D))
    ll = rng.standard_normal(WORLD) * 5
    return theta, ll, np.linspace(0.0, 1.0, WORLD)


def conjugate(pkg, **model_kw):
    """Prior x ~ N(0, 1), one observation y = 1 ~ N(x, 0.5)."""
    obs = pkg.UserLikelihood(pkg.distributions.Normal(1.0, 0.5), "x", name="obs1")
    system = pkg.System(name="conj_mesh", variables=dict(x=pkg.distributions.Normal(0.0, 1.0)),
                        observations=[obs])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def _pt(chain, info):
    """What a PT run is compared by."""
    return dict(x=chain.flat("x"), logpost=chain.internals["logpost"],
                round_trips=info["n_round_trips"], rejection=np.asarray(info["swap_rejection"]),
                logz=info["logevidence"], betas=np.asarray(info["betas"]),
                n_grad_evals=info["n_grad_evals"], rank_grad_evals=info["rank_grad_evals"],
                collectives=info["collectives"])


def _chain(chain):
    """What an octofit run is compared by."""
    return dict(data={k: np.asarray(v) for k, v in chain.data.items()},
                internals={k: np.asarray(v) for k, v in chain.internals.items()},
                step_size=np.asarray(chain.info["step_size"]),
                sigma=np.asarray(chain.info["sigma"]),
                n_grad_evals=chain.info["n_grad_evals"])


def _checks(rank, out_dir, uniforms):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch import parallel
    from octofitter_tpu_torch.astrom.fitting import prepare_A_5param

    res = {}

    def gen():
        return torch.Generator().manual_seed(0)

    def pigeons(mesh, **kw):
        return _pt(*ot.octofit_pigeons(conjugate(ot, device="cpu"), generator=gen(), mesh=mesh,
                                       **kw))

    # --- epoch sharding over four ranks
    mesh4 = parallel.global_mesh(("epochs",))
    d = epoch_data()
    tt = {k: torch.as_tensor(d[k]) for k in ("x", "s", "w")}

    def term(x, s):
        return -0.5 * (x / s) ** 2 - torch.log(s)

    res["epoch_sum"] = float(parallel.sharded_epoch_sum(term, (tt["x"], tt["s"]), mesh4))
    res["epoch_sum_w"] = float(parallel.sharded_epoch_sum(term, (tt["x"], tt["s"]), mesh4,
                                                          weights=tt["w"]))
    f = d["fit"]
    A = prepare_A_5param(f["epochs"], f["cphi"], f["sphi"], f["parf"], 58000.0, 58000.0)
    out = parallel.sharded_fit_5param(torch.as_tensor(A), f["cphi"], f["sphi"],
                                      torch.as_tensor(f["dalpha"]), torch.as_tensor(f["ddelta"]),
                                      mesh4, weights=f["w"], include_chi2=True, sigma=0.25,
                                      n_rows=len(f["epochs"]))
    res["fit"] = dict(parameters=[float(p) for p in out["parameters"]],
                      chi2=float(out["chi_squared_astro"]))
    res["dr4_ll"] = float(parallel.sharded_gaia_dr4_ll(
        {k: torch.as_tensor(v) for k, v in d["table"].items()}, torch.as_tensor(d["model_al"]),
        d["jitter"], mesh4))

    # --- the DEO swap, one replica per rank, on JAX's uniforms
    swap = parallel.sharded_pt_swap_step(parallel.global_mesh(("temps",)), "temps")
    theta, ll, betas = swap_data()
    res["swap"] = {}
    for even in (True, False):
        th, l, swapped = swap(torch.as_tensor(theta[rank]), torch.as_tensor(ll[rank]),
                              torch.as_tensor(betas[rank]), even, uniforms[rank])
        res["swap"][even] = (th.numpy(), float(l), bool(swapped))

    # --- octofit_pigeons over a (walkers, rungs) = (2, 2) mesh
    mesh22 = parallel.global_mesh(("walkers", "rungs"), (2, 2))
    res["pt1"] = pigeons(mesh22, n_rounds=1, **PT_SMALL)
    res["pt4"] = pigeons(mesh22, n_rounds=4, **PT_SMALL)
    res["pt_slice"] = pigeons(mesh22, **PT_SLICE)
    # a checkpointed run and its resume from the file rank 0 wrote
    ck = os.path.join(out_dir, "pt_mesh.npz")
    res["pt_ckpt"] = pigeons(mesh22, n_rounds=3, checkpoint=ck, **PT_SMALL)
    res["pt_resumed"] = pigeons(mesh22, n_rounds=3, resume=ck, **PT_SMALL)
    # the NUTS explorer with the walkers over all four ranks
    res["pt_nuts"] = pigeons(parallel.global_mesh(("walkers",)), **PT_NUTS)
    # a one-rank mesh on each rank, against mesh=None in the same process
    one, _ = dist.new_subgroups(group_size=1)
    mesh1 = DeviceMesh.from_group(one, "cpu", mesh_dim_names=("walkers",))
    res["pt_one_rank"] = pigeons(mesh1, **PT_ONE_RANK)
    res["pt_one_rank_none"] = pigeons(None, **PT_ONE_RANK)

    # --- octofit_sharded on the headline model: 2 ranks x 8 chains (each
    # half of the world runs the same sharded fit)
    import chip_smoke

    model = chip_smoke.build_model(ot, chip_smoke.bench_table(ot), device="cpu")
    model.starting_points = chip_smoke.headline_points(ot, model)
    chains_mesh = parallel.global_mesh(("chains", "copy"), (2, 2))["chains"]
    for sampler, kw in (("chees", SHARDED),
                        ("nuts", dict(SHARDED, adaptation=0, iterations=1, max_depth=6)),
                        ("hmc", dict(SHARDED, adaptation=0, iterations=1, max_depth=4))):
        res[f"sharded_{sampler}"] = _chain(parallel.octofit_sharded(
            model, mesh=chains_mesh, generator=gen(), sampler=sampler, **kw))
        if rank == 0:
            pts = model.starting_points[torch.as_tensor(np.resize(np.arange(64), kw["chains"]))]
            res[f"single_{sampler}"] = _chain(ot.octofit(
                model, generator=gen(), sampler=sampler, starting_points=pts, **kw))
    if rank == 0:
        res["pt1_none"] = pigeons(None, n_rounds=1, **PT_SMALL)
        res["pt4_none"] = pigeons(None, n_rounds=4, **PT_SMALL)
        res["pt_nuts_none"] = pigeons(None, **PT_NUTS)
    return res


def run_rank(rank, init, out_dir, uniforms):
    """One rank: join the group, run the checks, write rank<r>.pkl; on a
    failure write the traceback instead and exit non-zero."""
    import torch

    torch.set_num_threads(1)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from octofitter_tpu_torch import parallel

    parallel.initialize_distributed(dict(coordinator_address=init, num_processes=WORLD,
                                         process_id=rank), device="cpu")
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        res = _checks(rank, out_dir, uniforms)
    except BaseException:
        with open(path, "wb") as f:
            pickle.dump({"error": traceback.format_exc()}, f)
        raise
    with open(path, "wb") as f:
        pickle.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
