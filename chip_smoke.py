#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on lines of its own; any failure raises and exits
non-zero:

1. device: needs a CUDA device; prints its name and what
   `nvidia-smi --query-gpu=name,power.limit` reports;
2. build: compiles the three kernel libraries (`kepler.cu`,
   `orbit_solve.cu` and the header `kepler.cuh` under
   `octofitter_tpu_torch/orbits/kernels/csrc/`, and
   `octofitter_tpu_torch/rv/csrc/celerite.cu` with its header
   `celerite.cuh`) with nvcc, one process
   each, started together, into the git-ignored build directory; prints
   ptxas's register and spill lines;
3. Kepler kernel vs twin: the kernel against its plain PyTorch twin on
   the card, in float32 and float64, on 2^20 random (M, e) plus edge
   cases, then at the main path's (chains, 12) shape and at 2^23
   elements, where both are also timed with CUDA events;
4. orbit-solve kernels vs plain: the fused forward against the composed
   torch ops, and the fused backward against autograd through them, in
   both precisions, at the headline's (chains, 12), at the joint fit's
   (chains, 70) with epochs drawn over MJD 47,600-58,500 (in float32 the
   forward's one-epoch-per-thread instantiation, since 70 is no multiple
   of 4), at the partial-arc ladder's (65,536, 12) on its 600-day arc and
   at 2^17 chains x 64 epochs, on elements drawn from the
   benchmark priors' ranges plus edge chains; the backward runs twice and
   must repeat its bits; all are timed (plain, kernel, kernel, plain);
5. main path: the benchmark's headline model (`bench.py:build_model`:
   quick-start relative astrometry, 12 epochs, 2 mas noise, seed 0) in
   float32 on the GPU, checked against a float64 CPU model, then
   `octofit` with initialization at 4096 chains, ADAPTATION steps and
   ITERATIONS draws (the bench's 700 and 3000, cut to keep the whole script
   inside its time limit); checks finite draws, max split-R-hat < 1.05
   by the device diagnostics, the posterior median of b_a within 5 sd of
   the true 7.0, and that all three kernels were launched (the standalone
   Kepler kernel by the Laplace step, the fused pair on every gradient
   evaluation);
6. Kepler kernel at the main path's shapes: the main path reaches the
   standalone kernel only from the Laplace step's Hessian, with a
   handful of elements whose eccentricity arrives expanded; the kernel is
   held against its twin, through `kepler_solver`, at every shape that
   run launched it with, in both precisions, and timed there;
7. fused vs composed: one batched `ln_post_and_grad` at 4096 chains
   through the fused kernels and through the composed path, in turns,
   with CUDA events and the host clock;
8. NUTS and HMC: `octofit(sampler="nuts")` on the headline model that 5
   initialized, 32 chains, 100 adaptation steps + 50 draws, max_depth
   NUTS_MAX_DEPTH, float32, each chain adapting its own step size and dense metric; prints
   the batched evaluations per transition beside the mean leaves per chain
   (the cost of the lockstep); gates: max split-R-hat < 1.05 by the device
   diagnostics, finite draws, the medians of b_a and b_e within 5 sd of the
   truth, the fused pair launched on every evaluation; then a short
   `sampler="hmc"` run (32 chains, HMC_ADAPTATION + HMC_ITERATIONS, max_depth 4) with finite draws and
   acceptance in (0, 1];
9. joint path: `examples/02_joint_astrom_pma_rv.py`'s model (relative
   astrometry, HGCA with N_ave = 5, zero-point-marginalized RV; 70 epochs,
   D = 15), its data made from seed 0 with the port's orbitsolve on the
   CPU in float64, in float32 on the GPU, checked against a float64 CPU
   model, then `octofit` as in 5 with the same gates at JOINT_ADAPTATION
   steps + JOINT_ITERATIONS draws, the posterior
   medians of b_mass and b_a within 5 sd of 12 Mjup and 9 AU, and the
   Kepler kernel held to its twin at the shapes this run launched it with;
10. partial-arc parallel tempering (`bench.py:218-296`): the headline
   model on a 600-day arc (MJD 56,800-57,400) in float32 on the GPU,
   checked against a float64 CPU model, `initialize` with the default
   sizes, then `octofit_pigeons` with the bench's `_PA_KWARGS` (4096
   walkers x (8 + 8) rungs, ChEES explorer capped at 512 leapfrog steps)
   for PT_ROUNDS rounds (the bench's 9, cut); prints each round's sweeps,
   seconds, leapfrog counts, barriers and round trips, the device
   diagnostics of the 2W recorded chains and the bench's
   `partial_arc_pt_ess_per_sec`; gates: finite draws, a round trip, finite
   log-evidence and barriers, swap rejections in (0, 1), the ridge covered
   (q5(b_a) < 12, q95(b_a) > 25), the Kepler kernel launched by the
   Laplace step and the fused pair on every annealed evaluation and
   components pass; then the Kepler kernel held to its twin at the shapes
   this run launched it with;
11. PT with the NUTS explorer: `octofit_pigeons` on the partial-arc model
   that 10 initialized, the same ladder at 256 walkers, explorer="nuts"
   with explorer_max_depth 8, PT_NUTS_ROUNDS rounds; gates: finite draws, log-evidence
   and barriers, every rung's explorer acceptance in (0, 1], the fused pair
   on every annealed evaluation;
12. OFTI rejection (`examples/09_ofti_rejection.py`): the model with the
   Thiele-Innes constants marginalized by `ofti_linear_solve`, float64 on
   the GPU checked against the CPU model, `octofit_rejection` with 20,000
   draws in batches of 500,000; gates: 20,000 draws, the medians of e, a, M
   and plx within 5 sd of the truth, the standalone Kepler kernel launched
   once per batch at (500,000, 8); then the Kepler kernel held to its twin
   at the shapes this run launched it with, in both precisions, and timed;
13. diagnostics: `ess_rhat_batch_device` on the card against the numpy
   oracle `ess_rhat_batch`, both timed, on the headline and joint draws
   and on a synthetic case past S = 2^23 draws with ties;
14. calibration fit (a discrete prior marginalized): the headline model
   with cal ~ Categorical(0.5, 0.5) choosing a plate scale of 1 or
   CAL_SCALE for data recorded at CAL_SCALE (K = 2), float32 on the GPU
   checked against a float64 CPU model, then `octofit` with
   initialization at 4096 chains, CAL_ADAPTATION + CAL_ITERATIONS, with the
   gates of 5 and the posterior mean of the discrete column above 0.9;
   then the Kepler kernel held to its twin at the shapes its Laplace step
   launched it with;
15. outlier fit (Gibbs-within-HMC): the headline model at 13 epochs, one
   displaced, with one Categorical(0.9, 0.1) outlier flag per epoch
   widening that epoch's errors (K = 2^13), checked against a float64 CPU
   model, `octofit` at 4096 chains from 14's starting points, which must
   switch to Gibbs by itself; gates: finite draws, max split-R-hat < 1.05,
   the displaced epoch's flag mean above 0.9 and the others below 0.2,
   the median of b_a within 5 sd of 7, the fused pair on every gradient
   evaluation and the fused forward once per flag per sweep;
16. cap case: the outlier model at 12 epochs (K = 4096, the most that
   are marginalized), one float32 value-and-gradient evaluation at 256
   chains (1,048,576 rows), its peak memory and chunks printed, held
   against the float64 CPU model, then forced into 8 chunks (each
   recomputed in the backward pass) and held against the one pass;
17. the fused pair against its plain versions, and timed, in float32 at
   the discrete paths' shapes;
18. the RV-GP path (`examples/03_rv_gp.py`: a RadialVelocityOrbit planet in
   80 absolute RVs with an SHOTerm Gaussian process, D = 11), its data made
   from seed 0 with the port's orbitsolve on the CPU in float64: the
   float32 GPU model checked against a float64 CPU model; one batched
   value-and-gradient at 4096 chains through the celerite kernel pair
   (`rv/csrc/celerite.cu`) and through the plain recursion
   (`ln_post(..., fused=False)`), held to each other, with each path's
   host and device time and device operations; the Laplace step (the
   plain recursion under `torch.func.hessian`) timed, with its device
   operations and launches; the pair against its plain
   version in both precisions (float32 within 4 times the plain version's
   own error against float64, float64 within 1e-10) at (4096, 80) with one
   and two terms, (2^17, 80) and (8, 2048), with non-positive-definite
   rows, each timed (plain, kernel, kernel, plain) beside the dense route
   by library calls and read from torch.profiler's kernel events; the associative method against the pair at (8, 2048)
   and a QuasiPeriodicKernel's dense `gp_loglike` at (4096, 80) against
   float64 on the CPU; then `octofit` with initialization at 4096 chains,
   ChEES, RVGP_ADAPTATION + RVGP_ITERATIONS, with the gates of 5, the
   celerite pair and the standalone Kepler kernel launched on every
   gradient evaluation, the medians of b_mass and b_a within 5 sd of 1.2
   Mjup and 0.25 AU, and the Kepler kernel held to its twin at every shape
   the fit launched it with. Every phase from 14 on prints its seconds;
19. the other orbit bases: one float64 value-and-gradient at 4096 prior
   draws of the headline's relative astrometry on each of
   AbsoluteVisual{KepOrbit}, CartesianOrbit, Visual{FixedPosition} and
   Hyperbolic{KepOrbit}, on the card and on the CPU, held to each other
   (`hold_values_and_gradients`); the standalone Kepler kernel launched
   once where the basis solves Kepler's equation, the hyperbolic solve on
   the card;
20. the Hipparcos path (`docs/hipparcos.md`), float64 on AbsoluteVisual{KepOrbit}
   over a synthetic 120-abscissa IAD, `octofit` with initialization (the
   tutorial's guess, INIT_OPT_STEPS Adam steps) at 4096 chains: the
   tutorial's straight-line fit (D = 5, HIP_LINE_ADAPTATION +
   HIP_LINE_ITERATIONS) with the gates of 5, the Kepler kernel on every
   evaluation and the tutorial's catalog test (|pull| < 3 on plx, pmra,
   pmdec); then its companion-mass fit with the tutorial's 14
   relative-astrometry epochs (D = 16, HIP_ADAPTATION + HIP_ITERATIONS),
   the same gates and catalog test but R-hat reported, not gated (the
   tutorial's short arc does not mix at this length, nor at 300 + 150 in
   the JAX package: `scripts/hip_mass_mixing.py`, PERF.md), and
   the card's evaluation at its last draws held to the CPU's; then the
   Kepler kernel held to its twin, in float64, at the shapes both fits
   launched it with;
21. the HGCA linear-fit path: `HGCAObs` (include_iad=True) over the IAD and
   a 60-transit GOST scan law with the headline planet (D = 14) and its 12
   epochs, its catalog row made by `generate_from_params` at 30 Mjup on the
   CPU in float64; float32 on the card checked against a float64 CPU
   model, `octofit` with initialization at 4096 chains, HGCA_ADAPTATION +
   HGCA_ITERATIONS, with the gates of 5 (the fused pair on every gradient
   evaluation) and the medians of b_mass and b_a within 5 sd of the truth;
   then one float64 evaluation of the same model on AbsoluteVisual{KepOrbit}
   held to the CPU's;
22. the Gaia DR4 path at 620 epochs (Gaia BH3's count): on the Visual and
   the AbsoluteVisual branch, with and without `primary_star_perturbation`,
   one float64 value-and-gradient at 4096 prior draws held to the CPU's;
   then the Kepler kernel held to its twin at the shapes 19, 21 and 22
   launched it with, and the fused pair against its plain versions at the
   HGCA fit's (4096, 192) in float32 and at (4096, 620) in float64. Each
   new path prints its launches, its microseconds per evaluation on the
   host clock and by CUDA events, and its device operations and device time
   per evaluation;
23. the G23H composite likelihood (`examples/06_g23h_absolute_astrometry.py`
   on its synthetic catalog row, DR2+DR3 scan law and IAD: 140 epochs,
   marginalized epochs and the automatic variables, D = 98): one float64
   value-and-gradient at 4096 points (half near a point, half prior draws)
   on Visual{KepOrbit} and on AbsoluteVisual{KepOrbit}, held to the CPU
   (on AbsoluteVisual within 1e-9 plus 16 ulp-moves, two of the draws
   aligned with ln_post's gradient in the degrees), with the fused pair
   once (Visual) or the Kepler kernel once (AbsoluteVisual) per
   evaluation, and each evaluation's profile;
24. the G23H injection-recovery fit (tests/test_g23h.py:381): the frozen
   model on the catalog generated at a 40 Mjup companion with noise from
   numpy's seed 5, float32, `octofit` with initialization at 4096 chains,
   G23H_ADAPTATION + G23H_ITERATIONS; gates: the JAX test's (b_mass pull
   under 5, relative error under 5%, split-R-hat under 1.1) and the fused
   forward on every evaluation (the orbit is fixed: no backward);
25. `examples/06` through `octofit_pigeons` with the variational leg and
   the ChEES explorer, 512 walkers x (8 + 8) rungs, G23H_PT_ROUNDS rounds
   of at most 64 leapfrog steps, float32; gates: finite draws and
   evidence, swaps accepted between annealed rungs, the fused pair on
   every evaluation and sweep; prints R-hat, the barriers and b_mass;
26. the observable and stability priors with photometry: the two-planet
   headline model (ObsPriorAstromONeil2019, NonCrossingPrior,
   HillStabilityPrior, PlanetOrderPrior, a PhotometryObs through a
   Sonora-format grid written to a temporary directory), one float64
   value-and-gradient at 4096 points held to the CPU, the rows that break
   each hard prior -inf with finite gradients; then the Kepler kernel at
   the AbsoluteVisual evaluation's (4096, 140) in float64 and the fused
   pair at (4096, 140) in both precisions, against their plain versions;
27. `examples/05_images_interferometry_transits.py`'s three fits on the
   example's data (`ex05_data`: the image's blob at the image frame's
   -RA, see EX05_TRUE), each checked against a float64 CPU model at 64
   prior draws, then `octofit` with initialization at 4096 chains,
   EX05_ADAPTATION + EX05_ITERATIONS, ChEES at most 2^8 leapfrog steps: the
   101 x 101 image (`ImageObs`, a and the flux free) and the OIFITS closure
   phases (`InterferometryObs` from a file the port's `write_bintables`
   wrote, a and the contrast free) in float32, the 120-epoch transit
   (`LightCurveObs`, quadratic limb darkening, the radius ratio free) in
   float64 (EX05_DTYPE says why); gates: those of 5 (the forward alone for
   the transit's fixed orbit) and each posterior mean within EX05_GATES of
   the injected value, the interferometry's also within EX05_IF_REF_SD
   standard deviations of its posterior on a grid without the port's
   likelihood (`ex05_if_reference`); each fit's evaluation profile at 4096
   prior draws; then the planted faults (`ex05_planted_fault`: RA's sign
   in the image frame, the closure phases' sign) fitted the same way at
   1,024 chains, which must fail those gates;
28. one float64 value-and-gradient at 4096 prior draws of a likelihood map
   (`LogLikelihoodMapObs`, two 51 x 51 maps at 25 mas/px) and of GRAVITY
   kernel phases (`GRAVITYWideKPObs`, 6 baselines, 4 triangles, 14
   wavelengths) on the card, held to the CPU: rows off the map at the fill
   value, GRAVITY's rows whose covariance is not positive definite -inf
   with zero gradients, the fused pair once each way;
29. the Kepler kernel at each fit's Laplace shape in its dtype, and the
   fused pair at (4096, 1) in both precisions, (4096, 2) and (4096, 120) in
   float64, against their plain versions;
30. nested sampling against an exact evidence: `examples/10`'s model (6
   epochs at 2 mas, a and e free) in float64, held to the CPU, its logZ,
   information and posterior moments by a 1000 x 1000 grid quadrature of
   the CPU model's composed likelihood, then `octofit_nested` at
   NESTED_LIVE live points (1024 walkers, NESTED_STEPS steps); gates: logZ
   within max(0.15, 4 sqrt(H / n_live)) of the grid's, the means of a and e
   within 0.1 posterior sd, the fused forward on every walker step and no
   backward;
31. `examples/04`'s eccentric and circular models (12 epochs at 1 mas) in
   float32 by `octofit_nested` at the example's 600 live points, the
   eccentric under two seeds; gates: finite logZ and draws, the forward on
   every walker step, no backward; the runs' agreement, b_a against the
   truth and the Bayes factor printed, not gated (`ex04_nested_phase`
   says why);
32. cross-validation on the main path's chain: `pointwise_like` over its
   4096 x ITERATIONS draws (row sums against ln_like less the prior-only
   terms; one forward per chunk), a float64 card-vs-CPU check at 256 draws,
   `psis_loo` (finite elpd, p_loo and Pareto k), the k-fold and per-epoch
   systems and `prior_only_model`;
33. `calibrate` on `examples/10`'s model (SBC_TRIALS trials at the truth,
   SBC_KWARGS) and `examples/11`'s --fast completeness map on a synthetic
   70-transit scan law (COMPLETENESS_FIT); gates: ranks in [0, 1], finite
   draws, distinct truths, one trial per cell, the 20 Mjup at 5 AU cell
   detected, the fused pair launched;
34. the Gaia NSS warm start from a synthetic row of the headline truth:
   `initialize_from_nss` on the headline model (finite starting points on
   the card), then on the headline with tp free a fit from its starting
   points without `initialize` (R-hat < 1.05, b_a within 5 sd of 7, the
   pair on every evaluation) and `nss_to_model_chain` (mean b_e within
   0.01 of the row's); then the fused pair against its plain versions at
   the shapes 30-34 launched it with;
35. the ladder and the chains across processes (`parallel/` on
   `torch.distributed`), in the `evidence` job after 34: the partial-arc
   model initialized once, its starting points and Laplace sigma handed to
   every rank; (a) a one-rank NCCL mesh (`chain_mesh()` outside any process
   group) running `octofit_pigeons` with PA_KWARGS for PARALLEL_PT_ROUNDS
   rounds in float32, which must give `mesh=None`'s bits (draws, round
   trips, swap rejections, log-evidence); then one world of PARALLEL_RANKS
   spawned ranks that share the card over gloo (a file:// store; NCCL
   refuses two ranks on one card), which runs (b) the ladder's walkers over
   both ranks (2 x 2048 walkers x 16 rungs) and (c) its rungs over both
   ranks (4096 x 2 x 8), each in float64 for one round (every swap
   decision as `mesh=None`'s, draws within PARALLEL_F64_DRAW_TOL) and in
   float32 for two (phase 10's gates that two rounds allow), (d)
   `octofit_sharded` on the headline model at 2 x 2048 chains,
   PARALLEL_SHARDED (max split-R-hat < 1.05, b_a within 5 sd of 7, each
   rank's fused pair on every evaluation; the draws' distance from
   `octofit` at 4096 chains printed) and (e) epoch sharding in float64 at
   620 and 20,000 scans against one rank's sum and fit
   (PARALLEL_EPOCH_TOL); each rank reports its launches per part; then (f)
   `octofit(profile_dir=)` on the headline model for PARALLEL_PROFILE,
   whose trace must hold the fused pair's kernel events, with the device's
   busy share of the traced span printed. Each run prints its seconds per
   sweep, collectives per sweep and their bytes beside `mesh=None`'s.
   After the joins, (g) the fused pair against its plain versions at the
   ranks' shapes (PARALLEL_SHAPES).
36. plots (`octofitter_tpu_torch/plots/`, after the joins; imports neither
   matplotlib nor h5py): each orbit-drawing panel's arrays (its private
   `_*_arrays` function, all draws in one batch) in float32 on the card
   and in float64 on the CPU from the same chain and draws, each array
   within a limit derived from the fused pair's per-field tolerances
   (`_field_tolerances`) plus float32's rounding of the epochs and
   elements, each panel's launches printed (no backward; the orbits
   through a kernel) with its ms on the card and on the CPU: (a)
   octoplot's panels of 5's fit at PLOT_DRAWS draws; (b) those of 9's
   model and rvtimeplot's and rvpostplot's (`gp_predict` included) of
   18's, on chains of points near their truths; (c) astromplot's
   mark_epochs_mjd sep/PA summary; (d) the native table reader builds and
   `load_gost_csv` through it equals the csv module's bit for bit; (e) the
   forward kernel and the Kepler kernel against their plain versions at
   every shape (a)-(c) launched them with (the forward on the inputs a
   panel gave it there, the Kepler kernel on `kepler_path_phase`'s draws).

Phases 1-7 run in this process alone. Then six jobs start, each in a
process of its own on the same card (`_Workers`): 8 and 9; 14 and 15; the
RV-GP fit of 18 and 19-22; 27 and 28; 30, 31, 34 and 35 (whose ranks are
processes of their own); 33. Beside them this
process runs 10-12, 16, 23-26 and 32. An evaluation keeps the card busy
for under a fifth of its host time, so the processes' host dispatch
overlaps; their fits' times are taken with the card shared. Once the jobs
have ended, with the card to this process again: every kernel check and
timing against a plain version that 9, 10, 12, 14, 18, 22, 26, 29, 34 and
35 call for, 13, 17, and the checks of 18.
A job that fails fails the script, with its log printed; the processes
end with the script. 36 runs last, in this process.

The second-to-last line is a JSON object describing each kernel in
float32 at the shape the main path launches it with (`max_abs_err`: of E
for `kepler_solve`, the largest over the 14 fields in their own units for
`orbit_solve_fwd`, the worst chain's scaled gradient error for
`orbit_solve_bwd`; `kepler_solve` also carries the composed path's
(chains, 12) shape under `composed_*` keys), and at the joint path's
shape under `joint_*` keys, and at the partial-arc PT path's under `pt_*`
keys, each with that path's launches, with the launches of the NUTS, HMC,
PT-NUTS and rejection paths, the fused pair at the NUTS path's shape under
`nuts_*` keys and the Kepler kernel at the rejection path's bulk shape, in
float64, under `rejection_*` keys, and for the discrete paths the launches
of the calibration, outlier and cap runs under `marg_launches`,
`gibbs_launches` and `cap_launches`, the Kepler kernel at the calibration
fit's Laplace shape under `marg_*` and the fused pair at each discrete
shape under `marg_*`, `gibbs_*` (the HMC leg), `gibbs_sweep_*` and `cap_*`,
the Kepler kernel at the RV-GP fit's (4096, 80) under `rvgp_*` (every
kernel carries the RV-GP fit's launches as `rvgp_launches`), and the
celerite pair, `celerite_fwd` and `celerite_bwd`, at (4096, 80) with one
term, with its other shapes under `shapes` (the library time is the dense
route: the dense matrix, `cholesky_ex` and `solve_triangular`, several
calls; the bound counts the function's inputs and outputs, and each shape
gives each kernel's own device time per launch from torch.profiler's
kernel events as `device_us`, since at (4096, 80) the CUDA-event time is
the host's cost per launch; the log gives the forward's checkpoint bytes
and their time at the memory rate, computed, not measured; `occupancy`
holds the kernels' rows, threads, shared memory and resident blocks per
SM), and the Laplace step of the RV-GP model under `rvgp_laplace`; every
kernel carries the launches of 19-22 (`bases_launches`, `hip_launches`,
`hgca_launches`, `hgca_absolute_launches`, `dr4_launches`), the Kepler
kernel its rows at the Hipparcos fit's shape (`hip_*`, float64) and at the
other new paths' shapes (`absolute_shapes`), the fused pair its rows at the
HGCA fit's shape (`hgca_*`) and at the DR4 evaluations' (`dr4_*`, float64);
every kernel carries the launches of 23-26 (`g23h_launches` by basis,
`g23h_fit_launches`, `g23h_pt_launches`, `obs_prior_launches`), the Kepler
kernel and the fused pair their rows at (4096, 140) (`g23h_*`, float64; the
pair also `g23h_f32_*`); every kernel carries the launches of 27-28
(`ex05_launches`), the Kepler kernel its rows at the fits' Laplace shapes
(`ex05_kepler`), the fused pair its rows at 29's shapes (`ex05_*`,
`ex05_f64_*`, `ex05_map_*`, `ex05_transit_*`); every kernel carries the
launches of 30-34 (`nested_launches` by run, `cv_launches`,
`sbc_launches`, `completeness_launches`, `nss_launches`), the fused pair
its rows at their shapes (`nested_*` float64, `nested_ex04_*`, `cv_*`,
`cv_last_*`, `sbc_*`, `completeness_*`, `nss_*`); every kernel carries
the launches of 35 by part and, for (b)-(d), by rank (`parallel_launches`),
the fused pair its rows at a rank's half of the ladder (`parallel_*`,
`parallel_f64_*`) and of the sharded chains (`parallel_sharded_*`);
every kernel carries the launches of 36 by panel (`plots_launches`), the
Kepler kernel and the forward kernel their rows at the shapes 36 launched
them with (`plots_shapes`); the last is `{"ok": true, "device": {...}}`. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TRUE = dict(a=7.0, e=0.2, i=0.6, omega=1.0, Omega=2.0, tp=57000.0, M=1.2, plx=50.0)
N_EPOCHS = 12
# the joint fit (`examples/02_joint_astrom_pma_rv.py`): a beta-Pic-like
# companion of 12 Mjup; 10 astrometry + 20 HGCA + 40 RV epochs
JOINT_TRUE = dict(a=9.0, e=0.1, i=0.6, omega=1.0, Omega=2.0, tp=56500.0, M=1.6, plx=51.0)
JOINT_MASS = 12.0
JOINT_EPOCHS = 70
JOINT_SPAN = (47600.0, 58500.0)  # MJD: the Hipparcos window to the last RV
# the headline and joint fits' adaptation and draws (the bench's 700 +
# 3000), cut to keep the whole script inside its time limit
CHAINS, ADAPTATION, ITERATIONS = 4096, 200, 100
JOINT_ADAPTATION, JOINT_ITERATIONS = 150, 75
# NUTS and jittered HMC (`octofit(sampler="nuts" | "hmc")`) on the headline
# model the ChEES phase initialized: every chain adapts its own step size
# and dense metric, all chains step in lockstep
NUTS_CHAINS, NUTS_ADAPTATION, NUTS_ITERATIONS, NUTS_MAX_DEPTH = 32, 100, 50, 6
HMC_ADAPTATION, HMC_ITERATIONS, HMC_MAX_DEPTH = 50, 50, 4
# the partial-arc parallel-tempering fit (`bench.py:218-296`): the
# headline model with its 12 epochs on a 600-day arc, sampled with the
# bench's `_PA_KWARGS` (4096 walkers x (8 + 8) rungs, ChEES explorer); the
# bench's 9 rounds cut to PT_ROUNDS
PA_SPAN = (56800.0, 57400.0)
PA_KWARGS = dict(n_chains=8, n_chains_variational=8, n_walkers=4096,
                 explorer="chees", explorer_n_leapfrog=512)
PT_ROUNDS = 5
# No replica completes a round trip on this ladder in the rounds that fit
# (an NVIDIA H100 run, 5 to 7 rounds): the prior rung's IID draws lie
# 1e4-1e6 nats below rung 1, so the pair at either reference rejects every
# swap while the Syed update shrinks the next beta by about a third per
# round. The round trips are printed; the gate is that every pair between
# two annealed rungs (neither reference, not the always-accepted
# target|target pair) accepts at least 1% of its swaps.
SWAP_REJECTION_MAX = 0.99
PT_CHAINS = PA_KWARGS["n_walkers"] * (PA_KWARGS["n_chains"] + PA_KWARGS["n_chains_variational"])
# the same ladder with the JAX package's default explorer, NUTS, at fewer
# walkers and rounds
PT_NUTS_KWARGS = dict(PA_KWARGS, explorer="nuts", explorer_max_depth=8, n_walkers=256)
PT_NUTS_ROUNDS = 2
PT_NUTS_CHAINS = PT_CHAINS // PA_KWARGS["n_walkers"] * PT_NUTS_KWARGS["n_walkers"]

# Discrete priors on the headline model. The calibration fit: a choice of
# plate scale, 1 or CAL_SCALE, for data recorded at CAL_SCALE; K = 2
# combinations, marginalized. A plate scale s trades against a / s and
# M / s^3, which the M prior sets apart: at 1.2 the cal = 0 mode lies more
# than 10 nats below (tests/test_torch_discrete.py), at 1.05 within one. The outlier fit: one flag per epoch of 13,
# the epoch at OUTLIER_INDEX displaced by OUTLIER_SHIFT mas; K = 2^13, the
# Gibbs mode. The cap case: the outlier model at 12 epochs, K = 4096
# combinations, the most that are marginalized, at CAP_CHAINS chains.
CAL_SCALE = 1.2
CAL_ADAPTATION, CAL_ITERATIONS = 150, 75
OUTLIER_EPOCHS, OUTLIER_INDEX, OUTLIER_SHIFT = 13, 5, (60.0, -40.0)
# Gibbs-within-HMC adapts each chain's dense metric in Stan's windows, which
# below 150 warmup steps are one window over the middle 75% of the warmup:
# 149 steps is the longest such warmup (a 112-draw window). A 100-step
# warmup's 75-draw window left R-hat at 1.19 after 50 draws (PERF.md)
GIBBS_ADAPTATION, GIBBS_ITERATIONS = 149, 150
CAP_EPOCHS, CAP_CHAINS = 12, 256

# the RV-GP fit (`examples/03_rv_gp.py`): a 1.2 Mjup planet on a 0.25 AU
# orbit in 80 absolute RVs with quasi-periodic activity, modelled by an
# SHOTerm Gaussian process (the celerite recursion)
RVGP_TRUE = dict(a=0.25, e=0.15, omega=0.8, tp=57000.0, M=1.0)
RVGP_MASS = 1.2
RVGP_EPOCHS = 80
RVGP_ADAPTATION, RVGP_ITERATIONS = 200, 100

# the OFTI workflow (`examples/09_ofti_rejection.py`): 8 epochs of relative
# astrometry, the Thiele-Innes constants marginalized analytically, sampled
# by rejection from the prior in float64 at the example's sizes
OFTI_TRUE = dict(a=10.0, e=0.3, i=1.0, omega=0.5, Omega=2.0, tp=50000.0, M=1.2, plx=50.0)
OFTI_EPOCHS = 8
REJECTION_KWARGS = dict(num_samples=20_000, batch_size=500_000, max_batches=20)

# Tolerances for kernel vs twin, absolute on E. The float32 bound is the
# Pallas kernel's test bound (tests/test_kepler.py). Both grow with |M|/50
# beyond |M| = 50 because E carries |M|'s magnitude, so one rounding of E
# is an ulp of |M|.
TOL = {torch.float32: 5e-6, torch.float64: 1e-12}
# Bounds on |E - e sin E - M| (evaluated in float64 on the kernel's E),
# scaled the same way. In float32 the range reduction itself (M + pi and
# the float32 2 pi) moves M by a few ulps of |M| (about 4e-6 at |M| = 50),
# which the residual picks up times (1 + e).
RESID_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}


# Orbit-solve kernels vs their plain versions. Here the mean anomaly is
# computed on both sides, and may differ by two ulps of |M| (MA_TOL, at
# |M| = 50): the plain version forms the mean motion as 2 pi times a
# reciprocal and the kernel as a quotient, one ulp apart, and the product
# with t - tp rounds once more. E then differs by that over 1 - e cos E,
# on top of the Kepler tolerance TOL; both grow with |M|/50. A field's
# tolerance is E's carried through the field's derivative with respect to
# E, plus OWN for the roundings of the field's own arithmetic: positions
# scale with a, the true anomaly with sqrt(1 - e^2) / (1 - e cos E), and
# the sky fields with the parallax and the unit factors on top. The
# velocity vector's derivative with respect to E has length
# a n / (1 - e cos E), and rounding 1 - e cos E moves the velocity by
# a n / (1 - e cos E)^2 times an ulp: velocities scale with
# a n / min(1 - e cos E, (1 - e cos E)^2), the first term near apoapsis
# (1 - e cos E up to 1 + e), the second near periapsis.
MA_TOL = {torch.float32: 1.2e-5, torch.float64: 2.5e-14}
OWN = {torch.float32: 1e-6, torch.float64: 1e-13}
# Backward: for each chain, the largest error over the 8 element rows
# against the chain's largest gradient entry (at least 1), every row first
# divided by its median magnitude over chains so that rows of different
# units compare. Float32 sums 12 to 64 epochs of terms that cancel.
BWD_TOL = {torch.float32: 1e-3, torch.float64: 1e-10}
BIG_CHAINS, BIG_EPOCHS = 2**17, 64

# For the bounds: an H100 SXM moves 3.35 TB/s and does 67 TFLOP/s in
# float32 outside the tensor cores (NVIDIA's data sheet; float64 is half
# that). Arithmetic operations per element, each divide, sqrt, cbrt,
# sincos and atan2 counted as one: the Kepler solve about 90 (kepler.cuh),
# the other 13 fields of the forward about 110 more, the backward's sweep
# about 250.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}
OPS_KEPLER, OPS_ORBIT_FWD, OPS_ORBIT_BWD = 90, 200, 250
# the kernels of the `kernels` line, in its order
KERNEL_NAMES = ("kepler_solve", "orbit_solve_fwd", "orbit_solve_bwd", "celerite_fwd", "celerite_bwd")


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; nothing was run")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    log(f"nvidia-smi name, power.limit: {smi}")
    return name, smi


def build_phase(sources) -> float:
    from octofitter_tpu_torch.orbits.kernels.build import build_all, source_files

    t0 = time.perf_counter()
    built = build_all(sources)
    dt = time.perf_counter() - t0
    for source, (path, nvcc_log) in zip(sources, built):
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {source.name}: {line.strip()}")
        log(f"build: {' + '.join(f.name for f in source_files(source))} -> {path.name}")
    log(f"build: {len(sources)} libraries in {dt:.2f} s (one nvcc each, in parallel)")
    return dt


def _inputs(dtype):
    rng = np.random.default_rng(0)
    n = 2**20
    M = rng.uniform(-50.0, 50.0, n)
    e = rng.uniform(0.0, 0.99, n)
    pi = np.pi
    edge_M = np.array([0.0, pi, -pi, 2 * pi, -2 * pi, 1e-9, 3.0, -3.0,
                       100.0, -100.0, 1000.0, -1000.0, 999.0 * pi])
    edge_e = np.array([0.0, 0.5, 0.99])
    gM, ge = np.meshgrid(edge_M, edge_e, indexing="ij")
    M = np.concatenate([M, gM.ravel()])
    e = np.concatenate([e, ge.ravel()])
    # the 2^20 random points also run at e = 0 and e = 0.99 exactly
    M = np.concatenate([M, M[:4096], M[:4096]])
    e = np.concatenate([e, np.zeros(4096), np.full(4096, 0.99)])
    to = lambda x: torch.as_tensor(x, dtype=dtype, device="cuda")  # noqa: E731
    return to(M), to(e)


def _time_both(fn, n_iter):
    """ms per call of `fn` over `n_iter` back-to-back calls after one
    warm-up: by CUDA events, and by the host clock around a synchronize."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_iter):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n_iter, (time.perf_counter() - t0) / n_iter * 1e3


def _time_ms(fn, n_iter):
    return _time_both(fn, n_iter)[0]


def kernel_phase(kk, twin, chains: int) -> dict:
    errs = {}
    for dtype in (torch.float32, torch.float64):
        M, e = _inputs(dtype)
        E_k = kk.kepler_solve_cuda(M, e)
        E_t = twin(M, e)
        torch.cuda.synchronize()
        scale = torch.clamp(M.abs().double() / 50.0, min=1.0)
        err = (E_k.double() - E_t.double()).abs()
        E64 = E_k.double()
        resid = (E64 - e.double() * torch.sin(E64) - M.double()).abs()
        if not bool(torch.isfinite(E_k).all()):
            raise AssertionError(f"kernel returned non-finite E in {dtype}")
        worst = float((err / scale).max())
        worst_resid = float((resid / scale).max())
        log(f"kernel vs twin {dtype}: max |dE| {float(err.max()):.3e} "
            f"(scaled {worst:.3e}, tol {TOL[dtype]:.0e}); "
            f"max |E - e sin E - M| {float(resid.max()):.3e} (scaled {worst_resid:.3e}, tol {RESID_TOL[dtype]:.0e})")
        if worst > TOL[dtype]:
            raise AssertionError(f"kernel disagrees with its twin in {dtype}: {worst:.3e}")
        if worst_resid > RESID_TOL[dtype]:
            raise AssertionError(f"kernel residual too large in {dtype}: {worst_resid:.3e}")
        errs[dtype] = float(err[: 2**20].max())

    # then at the main path's (chains, epochs) shape and at 2^23 elements:
    # checked against the twin again (|M| <= 50, so unscaled), then timed
    timing = {}
    rng = np.random.default_rng(1)
    for label, shape in ((f"({chains}, {N_EPOCHS})", (chains, N_EPOCHS)), ("2^23", (2**23,))):
        n = int(np.prod(shape))
        for dtype in (torch.float32, torch.float64):
            M = torch.as_tensor(rng.uniform(-50, 50, shape), dtype=dtype, device="cuda")
            e = torch.as_tensor(rng.uniform(0, 0.99, shape), dtype=dtype, device="cuda")
            err = float((kk.kepler_solve_cuda(M, e).double() - twin(M, e).double()).abs().max())
            log(f"kernel vs twin {label} {dtype}: max |dE| {err:.3e} (tol {TOL[dtype]:.0e})")
            if not err <= TOL[dtype]:
                raise AssertionError(f"kernel disagrees with its twin at {label} in {dtype}: {err:.3e}")
            errs[dtype] = max(errs[dtype], err)
            n_iter = 200 if n < 2**20 else 20
            ms_twin_a = _time_ms(lambda: twin(M, e), n_iter)
            ms_k_a = _time_ms(lambda: kk.kepler_solve_cuda(M, e), n_iter)
            ms_k_b = _time_ms(lambda: kk.kepler_solve_cuda(M, e), n_iter)
            ms_twin_b = _time_ms(lambda: twin(M, e), n_iter)
            ms_k, ms_t = min(ms_k_a, ms_k_b), min(ms_twin_a, ms_twin_b)
            timing[(label, dtype)] = (ms_k, ms_t)
            log(f"timing {label} {dtype}: kernel {ms_k:.4f} ms, twin {ms_t:.4f} ms "
                f"(runs: kernel {ms_k_a:.4f}/{ms_k_b:.4f}, twin {ms_twin_a:.4f}/{ms_twin_b:.4f}; "
                f"kernel {n / ms_k / 1e6:.3f} Gsolves/s)")
    return {"errs": errs, "timing": timing}


def _orbit_inputs(n_chains: int, n_epochs: int, dtype, span=None, grid=(55000.0, 59500.0)):
    """Elements (8, B) and epochs (T,) on the card: drawn with numpy from
    the benchmark priors' ranges (a from 2 AU up, so that the bulk stays
    within a few periods of tp), then edge chains: e = 0, e = 0.99, i = 0,
    i = pi / 2, an epoch exactly at tp, and two chains of a = 0.3 AU whose
    epochs lie up to 120 periods from tp (one of them at e = 0.99). The
    epochs are an even grid over `grid` (the headline's by default), or
    drawn over `span` (MJD)."""
    rng = np.random.default_rng(2)
    if span is None:
        epochs = np.linspace(*grid, n_epochs)
    else:
        epochs = rng.uniform(*span, n_epochs)
    a = rng.uniform(2.0, 100.0, n_chains)
    e = rng.uniform(0.0, 0.99, n_chains)
    inc = np.arccos(rng.uniform(-1.0, 1.0, n_chains))
    omega = rng.uniform(-np.pi, np.pi, n_chains)
    Omega = rng.uniform(-np.pi, np.pi, n_chains)
    tp = rng.uniform(53000.0, 61000.0, n_chains)
    mass = np.clip(rng.normal(1.2, 0.1, n_chains), 0.1, None)
    plx = np.clip(rng.normal(50.0, 0.02, n_chains), 0.1, None)
    e[0], e[1], inc[2], inc[3] = 0.0, 0.99, 0.0, np.pi / 2
    tp[4] = epochs[n_epochs // 2]
    a[5], a[6], e[6] = 0.3, 0.3, 0.99
    elems = np.stack([a, e, inc, omega, Omega, tp, mass, plx])
    return (torch.as_tensor(elems, dtype=dtype, device="cuda"),
            torch.as_tensor(epochs, dtype=dtype, device="cuda"))


def _field_tolerances(elems, t, EA, dtype, d_ma=0.0):
    """(14, B, T) absolute tolerances, evaluated in float64 (see OWN). The
    epochs t are (T,), or (B, T) for per-chain epochs. `d_ma`: what
    rounding the inputs moves the mean anomaly by, where the two sides of a
    comparison did not start from the same inputs (phase 36)."""
    from octofitter_tpu_torch.constants import AUDAY_TO_MS, JULIAN_YEAR_DAYS, KEPLER_YEAR_DAYS

    a, e, _, _, _, tp, mass, plx = (x.double()[:, None] for x in elems)
    n = 2 * math.pi / (torch.sqrt(a**3 / mass) * KEPLER_YEAR_DAYS)
    scale = torch.clamp((n * (t.double() - tp)).abs() / 50.0, min=1.0)
    f1 = 1 - e * torch.cos(EA.double())
    d_E = (TOL[dtype] + (MA_TOL[dtype] + d_ma) / f1) * scale
    own = OWN[dtype]
    nu = d_E * torch.sqrt(1 - e * e) / f1 + own
    pos = a * (d_E + own)
    vel = a * n / torch.minimum(f1, f1 * f1) * (d_E + own)
    return torch.stack([d_E, nu, pos, pos, pos, pos, vel, vel, vel, pos * plx, pos * plx,
                        vel * plx * JULIAN_YEAR_DAYS, vel * plx * JULIAN_YEAR_DAYS,
                        vel * AUDAY_TO_MS])


def _worst_chain_error(g_kernel, g_plain) -> float:
    """The backward kernel's error as BWD_TOL measures it."""
    unit = g_plain.double().abs().median(dim=1, keepdim=True).values
    err = ((g_kernel.double() - g_plain.double()).abs() / unit).amax(dim=0)
    ref = torch.clamp((g_plain.double().abs() / unit).amax(dim=0), min=1.0)
    return float((err / ref).max())


def forward_instantiation(t, out) -> int:
    """The N of the `orbit_fwd_kernel<T, N>` that `launch_fwd` in
    orbit_solve.cu picks for these tensors: 16 bytes of consecutive epochs
    per thread when the epoch count is a multiple of them and both
    pointers are 16-byte aligned, else one epoch per thread."""
    n = 16 // t.element_size()
    packed = t.shape[0] % n == 0 and t.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return n if packed else 1


HEADLINE_GRID = (55000.0, 59500.0)


def orbit_phase(osk, elements, chains: int) -> dict:
    """Fused forward and backward kernels against their plain versions on
    the card, then their timings. Returns, per kernel, the float32 error
    and timings at the headline's shape (also the NUTS explorer's ladder's,
    256 walkers x 16 rungs), the NUTS path's, the joint fit's, the
    partial-arc ladder's (all its walkers and rungs, on its 600-day arc) and
    the large one."""
    shapes = ((f"({chains}, {N_EPOCHS})", chains, N_EPOCHS, None, HEADLINE_GRID),
              (f"({NUTS_CHAINS}, {N_EPOCHS})", NUTS_CHAINS, N_EPOCHS, None, HEADLINE_GRID),
              (f"({chains}, {JOINT_EPOCHS})", chains, JOINT_EPOCHS, JOINT_SPAN, None),
              (f"({PT_CHAINS}, {N_EPOCHS})", PT_CHAINS, N_EPOCHS, None, PA_SPAN),
              (f"({BIG_CHAINS}, {BIG_EPOCHS})", BIG_CHAINS, BIG_EPOCHS, None, HEADLINE_GRID))
    res = orbit_shapes_phase(osk, elements, shapes, (torch.float32, torch.float64))
    kep_orbit_phase(osk, elements, chains)
    return res


def orbit_shapes_phase(osk, elements, shapes, dtypes) -> dict:
    """The fused pair against its plain versions, then timed, at each of
    `shapes` ((label, chains, epochs, span, grid), see `_orbit_inputs`) in
    each of `dtypes`: {"fwd"|"bwd": {(label, dtype): numbers}}."""
    res = {"fwd": {}, "bwd": {}}
    for label, n_chains, n_epochs, span, grid in shapes:
        for dtype in dtypes:
            elems, t = _orbit_inputs(n_chains, n_epochs, dtype, span, grid)
            leaf = elems.clone().requires_grad_(True)
            plain = torch.stack(elements._kep_visual_fields(elements.VisualOrbit(*leaf), t))
            out = osk.orbit_solve_forward_cuda(elems, t)
            torch.cuda.synchronize()
            n_inst = forward_instantiation(t, out)
            log(f"orbit_solve forward {label} {dtype}: ran orbit_fwd_kernel<T, {n_inst}> "
                f"({'16-byte packs' if n_inst > 1 else 'one epoch per thread'})")
            if n_epochs == JOINT_EPOCHS and dtype == torch.float32 and n_inst != 1:
                raise AssertionError("the joint's float32 shape was meant to run the N = 1 forward")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"orbit_solve forward returned non-finite values in {dtype}")
            err = (out.double() - plain.detach().double()).abs()
            # the true anomaly is an angle: compare it modulo 2 pi
            err[1] = (torch.remainder(err[1] + math.pi, 2 * math.pi) - math.pi).abs()
            ratio = err / _field_tolerances(elems, t, plain[0].detach(), dtype)
            worst = ratio.amax(dim=(1, 2))
            k = int(worst.argmax())
            log(f"orbit_solve forward vs plain {label} {dtype}: worst field {elements.FIELD_ROWS[k]} at "
                f"{float(worst[k]):.3f} of its tolerance; max |dE| {float(err[0].max()):.3e}, "
                f"max |d raoff| {float(err[9].max()):.3e} mas, max |d pmra| "
                f"{float(err[11].max()):.3e} mas/yr")
            if not float(worst.max()) <= 1.0:
                raise AssertionError(
                    f"orbit_solve forward disagrees with its plain version at {label} in "
                    f"{dtype}: {dict(zip(elements.FIELD_ROWS, worst.tolist()))}")

            # backward: a cotangent of order 1 / |field| on every field
            rng = np.random.default_rng(3)
            g = torch.as_tensor(rng.standard_normal((len(elements.FIELD_ROWS), n_chains, n_epochs)),
                                dtype=dtype, device="cuda")
            g = (g / plain.detach().abs().amax(dim=(1, 2), keepdim=True)).contiguous()
            (g_plain,) = torch.autograd.grad(plain, leaf, g, retain_graph=True)
            EA = plain[0].detach().contiguous()
            g_k = osk.orbit_solve_backward_cuda(elems, t, EA, g, True)
            g_k2 = osk.orbit_solve_backward_cuda(elems, t, EA, g, True)
            torch.cuda.synchronize()
            if not torch.equal(g_k, g_k2):
                raise AssertionError(f"orbit_solve backward is not bitwise repeatable in {dtype}")
            if not bool(torch.isfinite(g_k).all()):
                raise AssertionError(f"orbit_solve backward returned non-finite values in {dtype}")
            worst_b = _worst_chain_error(g_k, g_plain)
            log(f"orbit_solve backward vs autograd of plain {label} {dtype}: worst chain "
                f"{worst_b:.3e} of its largest gradient entry (tol {BWD_TOL[dtype]:.0e}); "
                f"two runs bitwise equal")
            if not worst_b <= BWD_TOL[dtype]:
                raise AssertionError(
                    f"orbit_solve backward disagrees with autograd at {label} in {dtype}: {worst_b:.3e}")

            n_iter = 100 if n_chains * n_epochs < 2**20 else 10
            orbit = elements.VisualOrbit(*elems)

            def plain_fwd():
                with torch.no_grad():
                    return torch.stack(elements._kep_visual_fields(orbit, t))

            def plain_bwd():
                return torch.autograd.grad(plain, leaf, g, retain_graph=True)

            for name, f_plain, f_kernel in (
                    ("fwd", plain_fwd, lambda: osk.orbit_solve_forward_cuda(elems, t)),
                    ("bwd", plain_bwd, lambda: osk.orbit_solve_backward_cuda(elems, t, EA, g, True))):
                ms_p_a = _time_ms(f_plain, n_iter)
                ms_k_a = _time_ms(f_kernel, n_iter)
                ms_k_b = _time_ms(f_kernel, n_iter)
                ms_p_b = _time_ms(f_plain, n_iter)
                ms_k, ms_p = min(ms_k_a, ms_k_b), min(ms_p_a, ms_p_b)
                log(f"timing orbit_solve {name} {label} {dtype}: kernel {ms_k:.4f} ms, plain "
                    f"{ms_p:.4f} ms (runs: kernel {ms_k_a:.4f}/{ms_k_b:.4f}, plain "
                    f"{ms_p_a:.4f}/{ms_p_b:.4f})")
                res[name][(label, dtype)] = dict(
                    ms=ms_k, plain_ms=ms_p,
                    err=float(err.max()) if name == "fwd" else worst_b,
                    err_over_tol=float(worst.max()) if name == "fwd" else worst_b / BWD_TOL[dtype])
            del plain, leaf, g, g_plain, out, err, ratio
            torch.cuda.empty_cache()
    return res


def kep_orbit_phase(osk, elements, chains: int) -> None:
    """A KepOrbit (no parallax): NaN sky fields forward, and a backward that
    leaves them out, against autograd through the plain version."""
    for dtype in (torch.float32, torch.float64):
        elems, t = _orbit_inputs(chains, N_EPOCHS, dtype)
        elems[7] = math.nan
        leaf = elems[:7].clone().requires_grad_(True)
        sky = [9, 10, 11, 12]
        rest = [k for k in range(len(elements.FIELD_ROWS)) if k not in sky]
        fields = elements._kep_visual_fields(elements.KepOrbit(*leaf), t)
        # only the finite fields enter the graph: a zero cotangent times
        # the NaN parallax would be NaN
        plain = torch.stack([fields[k] for k in rest])
        out = osk.orbit_solve_forward_cuda(elems, t)
        if not (bool(torch.isnan(out[sky]).all()) and bool(torch.isfinite(out[rest]).all())):
            raise AssertionError(f"KepOrbit forward: wrong NaN pattern in {dtype}")
        rng = np.random.default_rng(4)
        g = torch.as_tensor(rng.standard_normal(tuple(out.shape)), dtype=dtype, device="cuda")
        g[rest] /= plain.detach().abs().amax(dim=(1, 2), keepdim=True)
        (g_plain,) = torch.autograd.grad(plain, leaf, g[rest])
        g_k = osk.orbit_solve_backward_cuda(elems, t, plain[0].detach().contiguous(), g, False)
        worst_b = _worst_chain_error(g_k[:7], g_plain)
        log(f"orbit_solve KepOrbit ({chains}, {N_EPOCHS}) {dtype}: NaN sky fields; backward worst "
            f"chain {worst_b:.3e} (tol {BWD_TOL[dtype]:.0e}), plx row max |g| "
            f"{float(g_k[7].abs().max()):.1e}")
        if not (worst_b <= BWD_TOL[dtype] and float(g_k[7].abs().max()) == 0.0):
            raise AssertionError(f"KepOrbit backward disagrees with autograd in {dtype}")


def build_model(ot, table, name="bench", astrom_variables=None, tp=None, **model_kw):
    """The headline model (`bench.py:build_model`) with either package's
    API (`ot` is the package), with optional variables on its astrometry;
    with `tp` (a distribution) the periastron epoch is a free parameter in
    place of the position angle theta at MJD 57000."""
    dist = ot.distributions
    astrom = ot.PlanetRelAstromObs(table, variables=astrom_variables, name="simdata")
    phase = dict(tp=tp) if tp is not None else dict(
        theta=ot.UniformCircular(),
        tp=lambda sys, pl: ot.theta_at_epoch_to_tperi(
            pl.theta, 57000.0, M=sys.M, e=pl.e, a=pl.a,
            i=pl.i, omega=pl.omega, Omega=pl.Omega,
        ),
    )
    b = ot.Planet(
        name="b",
        basis="Visual{KepOrbit}",
        variables=dict(
            a=dist.Uniform(0.001, 100.0),
            e=dist.Uniform(0.0, 0.99),
            i=dist.Sine(),
            omega=ot.UniformCircular(),
            Omega=ot.UniformCircular(),
            **phase,
        ),
        observations=[astrom],
    )
    system = ot.System(
        name=name,
        variables=dict(
            M=dist.truncated(dist.Normal(1.2, 0.1), lower=0.1),
            plx=dist.truncated(dist.Normal(50.0, 0.02), lower=0.1),
        ),
        companions=[b],
    )
    return ot.LogDensityModel(system, verbosity=0, **model_kw)


def bench_table(ot, t0=55000.0, t1=59500.0, n_epochs=N_EPOCHS):
    """`bench.py:build_model(t0, t1)`'s data, simulated with the port's
    orbitsolve: the headline's by default, the partial arc's for PA_SPAN."""
    return astrom_table(ot, TRUE, (t0, t1), n_epochs, 2.0, 0)


def calibration_table(ot, scale=CAL_SCALE) -> dict:
    """The headline's data as an instrument whose plate scale is `scale`
    would record them: the offsets divided by `scale`."""
    t = bench_table(ot)
    return dict(t, ra=t["ra"] / scale, dec=t["dec"] / scale)


def build_calibration_model(pkg, table, scale=CAL_SCALE, **model_kw):
    """The headline model (either package, `pkg`) with a choice between two
    instrument calibrations: cal ~ Categorical(0.5, 0.5) picks a plate
    scale of 1 or `scale`. K = 2 combinations: marginalized."""
    variables = dict(cal=pkg.distributions.Categorical(probs=(0.5, 0.5)),
                     platescale=lambda s, pl, o: 1.0 + (scale - 1.0) * o.cal)
    return build_model(pkg, table, name="bench_calibration", astrom_variables=variables,
                       **model_kw)


def outlier_table(ot, n_epochs=OUTLIER_EPOCHS) -> dict:
    """The headline's orbit and noise at `n_epochs` epochs, the epoch at
    OUTLIER_INDEX displaced by OUTLIER_SHIFT (mas in ra, dec)."""
    t = bench_table(ot, n_epochs=n_epochs)
    ra, dec = t["ra"].copy(), t["dec"].copy()
    ra[OUTLIER_INDEX] += OUTLIER_SHIFT[0]
    dec[OUTLIER_INDEX] += OUTLIER_SHIFT[1]
    return dict(t, ra=ra, dec=dec)


def build_outlier_model(pkg, table, **model_kw):
    """The headline model (either package, `pkg`) with one outlier flag per
    epoch: flag ~ IIDVector(Categorical(0.9, 0.1), T), and a flagged
    epoch's errors widened by a jitter of 100 mas. K = 2^T combinations:
    marginalized up to T = 12, the Gibbs mode from T = 13."""
    n = len(table["epoch"])
    variables = dict(flag=pkg.IIDVector(pkg.distributions.Categorical(probs=(0.9, 0.1)), n),
                     jitter=lambda s, pl, o: 100.0 * o.flag)
    return build_model(pkg, table, name="bench_outlier", astrom_variables=variables, **model_kw)


def joint_data(ot) -> dict:
    """`examples/02_joint_astrom_pma_rv.py:build_model`'s data, made line by
    line as there (seed 0) with the port's orbitsolve on the CPU in float64:
    the astrometry table, the HGCA row and the RV table."""
    from octofitter_tpu_torch.constants import J2000_MJD, JULIAN_YEAR_DAYS, MJUP2MSOL

    o = ot.orbits
    pm = dict(pmra=4.6, pmdec=83.0)
    rng = np.random.default_rng(0)
    orbit = ot.VisualOrbit.from_params(**JOINT_TRUE, device="cpu")
    m = JOINT_MASS * MJUP2MSOL

    epochs = np.linspace(55000.0, 58500.0, 10)
    s = ot.orbitsolve(orbit, epochs)
    astrom = dict(epoch=epochs,
                  ra=o.raoff(s).numpy() + rng.standard_normal(10) * 3.0,
                  dec=o.decoff(s).numpy() + rng.standard_normal(10) * 3.0,
                  σ_ra=np.full(10, 3.0), σ_dec=np.full(10, 3.0))

    t_hip = (1991.25 - 2000.0) * JULIAN_YEAR_DAYS + J2000_MJD
    t_gaia = (2016.0 - 2000.0) * JULIAN_YEAR_DAYS + J2000_MJD
    s_h = ot.orbitsolve(orbit, t_hip)
    s_g = ot.orbitsolve(orbit, t_gaia)
    hgca_row = dict(
        pmra_hip=pm["pmra"] + float(o.pmra(s_h, m)) + rng.standard_normal() * 0.4,
        pmdec_hip=pm["pmdec"] + float(o.pmdec(s_h, m)) + rng.standard_normal() * 0.4,
        pmra_hip_error=0.4, pmdec_hip_error=0.4, pmra_pmdec_hip=0.1,
        pmra_gaia=pm["pmra"] + float(o.pmra(s_g, m)) + rng.standard_normal() * 0.03,
        pmdec_gaia=pm["pmdec"] + float(o.pmdec(s_g, m)) + rng.standard_normal() * 0.03,
        pmra_gaia_error=0.03, pmdec_gaia_error=0.03, pmra_pmdec_gaia=-0.2,
        pmra_hg=pm["pmra"]
        + (float(o.raoff(s_g, m)) - float(o.raoff(s_h, m))) / (t_gaia - t_hip) * JULIAN_YEAR_DAYS,
        pmdec_hg=pm["pmdec"]
        + (float(o.decoff(s_g, m)) - float(o.decoff(s_h, m))) / (t_gaia - t_hip) * JULIAN_YEAR_DAYS,
        pmra_hg_error=0.03, pmdec_hg_error=0.03, pmra_pmdec_hg=0.0,
        epoch_ra_hip=1991.25, epoch_dec_hip=1991.25,
        epoch_ra_gaia=2016.0, epoch_dec_gaia=2016.0,
        parallax_gaia=JOINT_TRUE["plx"], parallax_gaia_error=0.1,
        nonlinear_dpmra=0.0, nonlinear_dpmdec=0.0,
    )

    rv_epochs = np.sort(rng.uniform(56500.0, 58500.0, 40))
    rv_star = o.radvel(ot.orbitsolve(orbit, rv_epochs), m).numpy()
    rv = dict(epoch=rv_epochs, rv=rv_star + 30.0 + rng.standard_normal(40) * 5.0,
              σ_rv=np.full(40, 5.0))
    return {"astrom": astrom, "hgca": hgca_row, "rv": rv}


def build_joint_model(ot, data, **model_kw):
    """`examples/02_joint_astrom_pma_rv.py:build_model`'s model with the
    port's API: relative astrometry (10 epochs) on planet b, HGCA with
    N_ave = 5 (20 epochs) and the zero-point-marginalized RV (40 epochs) on
    the system; 70 epochs, D = 15."""
    dist = ot.distributions
    astrom = ot.PlanetRelAstromObs(data["astrom"], name="astrom")
    hgca = ot.HGCAInstantaneousObs(hgca=data["hgca"], N_ave=5)
    rvobs = ot.MarginalizedStarAbsoluteRVObs(
        data["rv"], dict(jitter=dist.LogUniform(0.01, 30.0)), name="rvs")
    b = ot.Planet(
        name="b",
        basis="Visual{KepOrbit}",
        variables=dict(
            a=dist.Uniform(1.0, 50.0),
            e=dist.Uniform(0.0, 0.9),
            i=dist.Sine(),
            omega=ot.UniformCircular(),
            Omega=ot.UniformCircular(),
            theta=ot.UniformCircular(),
            mass=dist.LogUniform(0.1, 100.0),
            tp=lambda sys, pl: ot.theta_at_epoch_to_tperi(
                pl.theta, 57000.0, M=sys.M, e=pl.e, a=pl.a,
                i=pl.i, omega=pl.omega, Omega=pl.Omega,
            ),
        ),
        observations=[astrom],
    )
    system = ot.System(
        name="betapic-like",
        variables=dict(
            M=dist.truncated(dist.Normal(1.6, 0.05), lower=0.1),
            plx=ot.gaia_plx(hgca_row=data["hgca"]),
            pmra=dist.Normal(0.0, 200.0),
            pmdec=dist.Normal(0.0, 200.0),
        ),
        companions=[b],
        observations=[hgca, rvobs],
    )
    return ot.LogDensityModel(system, verbosity=0, **model_kw)


def ofti_data(ot) -> dict:
    """`examples/09_ofti_rejection.py:build_model`'s data, made line by line
    as there (seed 42, 8 epochs, 10 mas noise) with the port's orbitsolve
    on the CPU in float64."""
    epochs = np.linspace(50000.0, 50840.0, OFTI_EPOCHS)
    sol = ot.orbitsolve(ot.VisualOrbit.from_params(**OFTI_TRUE, device="cpu"), epochs)
    rng = np.random.default_rng(42)
    ra = ot.orbits.raoff(sol).numpy() + rng.standard_normal(OFTI_EPOCHS) * 10.0
    dec = ot.orbits.decoff(sol).numpy() + rng.standard_normal(OFTI_EPOCHS) * 10.0
    return dict(epochs=epochs, ra=ra, dec=dec, s_ra=np.full(OFTI_EPOCHS, 10.0),
                s_dec=np.full(OFTI_EPOCHS, 10.0), cor=np.zeros(OFTI_EPOCHS))


def build_ofti_model(ot, data, **model_kw):
    """`examples/09_ofti_rejection.py:build_model`'s model with the port's
    API: 5 nonlinear parameters (M, plx, e, a, tau), the Thiele-Innes
    constants marginalized by `ofti_linear_solve` (prior width 1000 mas)
    into a `DirectLL`, and tp derived from tau."""
    from octofitter_tpu_torch.constants import KEPLER_YEAR_DAYS

    dist = ot.distributions
    epochs = data["epochs"]

    def tp(s):
        return epochs[0] + s.tau * torch.sqrt(s.a**3 / s.M) * KEPLER_YEAR_DAYS

    def ofti(s):
        return ot.ofti_linear_solve(epochs, data["ra"], data["dec"], data["s_ra"], data["s_dec"],
                                    data["cor"], 1000.0, s.e, s.a, tp(s), s.M, s.plx)

    system = ot.System(
        name="OFTI_Demo",
        variables=dict(
            M=dist.truncated(dist.Normal(1.2, 0.1), lower=0.1),
            plx=dist.truncated(dist.Normal(50.0, 0.5), lower=0.1),
            e=dist.Uniform(0.0, 0.99),
            a=dist.LogUniform(1.0, 100.0),
            tau=dist.Uniform(0.0, 1.0),
            ll=lambda s: ofti(s)["log_marginal_likelihood"],
            tp=tp,
        ),
        observations=[ot.DirectLL("ll")],
    )
    return ot.LogDensityModel(system, verbosity=0, **model_kw)


def rvgp_data(ot) -> dict:
    """`examples/03_rv_gp.py`'s data, made line by line as there (seed 0)
    with the port's orbitsolve on the CPU in float64: 80 epochs over four
    periods of a 1.2 Mjup planet, a quasi-periodic activity signal, an
    offset of 12 m/s and 1.5 m/s of noise."""
    from octofitter_tpu_torch.constants import MJUP2MSOL

    rng = np.random.default_rng(0)
    orbit = ot.RadialVelocityOrbit.from_params(**RVGP_TRUE, device="cpu")
    P = float(ot.orbits.period(orbit))
    epochs = np.sort(rng.uniform(57000.0, 57000.0 + 4 * P, RVGP_EPOCHS))
    rv_planet = ot.orbits.radvel(ot.orbitsolve(orbit, epochs), RVGP_MASS * MJUP2MSOL).numpy()
    activity = 4.0 * np.sin(2 * np.pi * epochs / 23.0) * np.exp(
        0.2 * np.sin(2 * np.pi * epochs / 290.0))
    rv = rv_planet + activity + 12.0 + rng.standard_normal(RVGP_EPOCHS) * 1.5
    return dict(epoch=epochs, rv=rv, σ_rv=np.full(RVGP_EPOCHS, 1.5))


def build_rvgp_model(pkg, data, gp_method="scan", epoch_subset=None, **model_kw):
    """`examples/03_rv_gp.py`'s model with either package's API (`pkg`): one
    RadialVelocityOrbit planet with a mass, absolute RVs with an offset, a
    jitter and an SHOTerm(S0, w0, Q=3) Gaussian process; D = 11. With
    `epoch_subset` (row indices), the RVs are conditioned on those rows and
    scored at the others (`likeobj_from_epoch_subset`, cross-validation)."""
    dist = pkg.distributions
    rvobs = pkg.StarAbsoluteRVObs(
        data,
        dict(offset=dist.Normal(0.0, 50.0), jitter=dist.LogUniform(0.01, 20.0),
             gp_S0=dist.LogUniform(0.1, 100.0), gp_w0=dist.LogUniform(0.01, 2.0)),
        name="HARPS",
        gaussian_process=lambda obs: pkg.rv.SHOTerm(S0=obs.gp_S0, w0=obs.gp_w0, Q=3.0),
        gp_method=gp_method,
    )
    if epoch_subset is not None:
        rvobs = rvobs.likeobj_from_epoch_subset(epoch_subset)
    b = pkg.Planet(
        name="b",
        basis="RadialVelocityOrbit",
        variables=dict(a=dist.Uniform(0.05, 1.0), e=dist.Uniform(0.0, 0.7),
                       omega=pkg.UniformCircular(), tp=dist.Uniform(56980.0, 57020.0),
                       mass=dist.Uniform(0.0, 20.0)),
    )
    system = pkg.System(
        name="rv-gp",
        variables=dict(M=dist.truncated(dist.Normal(1.0, 0.05), lower=0.1)),
        companions=[b],
        observations=[rvobs],
    )
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def rvgp_points_near_truth(ot, model, n, seed):
    """`n` unconstrained points of the RV-GP model: the truth (offset 12,
    jitter 0.5, S0 5, w0 0.27) plus N(0, 1e-3) in every coordinate."""
    t = RVGP_TRUE
    nat = torch.tensor([[t["M"], 12.0, 0.5, 5.0, 0.27, t["a"], t["e"], np.cos(t["omega"]),
                         np.sin(t["omega"]), t["tp"], RVGP_MASS]], dtype=torch.float64)
    rng = np.random.default_rng(seed)
    return model.link(model.tensor(nat)).cpu().double() + torch.as_tensor(
        1e-3 * rng.standard_normal((n, model.D)))


def joint_points_near_truth(ot, model, n, seed):
    """`n` unconstrained points of the joint model: the truth (RV jitter
    5 m/s) plus N(0, 1e-3) in every coordinate."""
    sol = ot.orbitsolve(ot.VisualOrbit.from_params(**JOINT_TRUE, device="cpu"), np.array([57000.0]))
    theta = float(ot.orbits.posangle(sol)[0])
    t = JOINT_TRUE
    nat = torch.tensor([[t["M"], t["plx"], 4.6, 83.0, 5.0, t["a"], t["e"], t["i"],
                         np.cos(t["omega"]), np.sin(t["omega"]),
                         np.cos(t["Omega"]), np.sin(t["Omega"]),
                         np.cos(theta), np.sin(theta), JOINT_MASS]], dtype=torch.float64)
    rng = np.random.default_rng(seed)
    return model.link(model.tensor(nat)).cpu().double() + torch.as_tensor(
        1e-3 * rng.standard_normal((n, model.D)))


def points_chain(ot, model, theta_t, n_chains):
    """A Chains of unconstrained points (n_chains * n_draws, D), as a
    sampler returns one: the draws in natural coordinates with every
    derived column (`arr2nt`, `flatten_params_batch`) and each draw's
    log posterior as `logpost`."""
    from octofitter_tpu_torch.chains import flatten_params_batch

    theta_t = model.tensor(theta_t)
    with torch.no_grad():
        nts = model.arr2nt(model.invlink(theta_t))
        lp = model.ln_post(theta_t)
    n = theta_t.shape[0]
    data = {}
    for k, v in flatten_params_batch(nts).items():
        if v.ndim == 0 or v.shape[0] != n:  # a constant: the same for every draw
            v = np.broadcast_to(v, (n,))
        data[k] = np.asarray(v, dtype=np.float64).reshape(n_chains, -1)
    logpost = lp.double().cpu().numpy().reshape(n_chains, -1)
    return ot.Chains(data, {"logpost": logpost}, {"sampler": "points_chain"})


def reference_phase(label, model, ref, pts) -> None:
    """ln_post of the float32 GPU `model` against the float64 CPU `ref` at
    the points `pts`. Float32 rounds the epochs and tp to ~4e-3 d and the
    model's positions and velocities to ~1e-7 relative: a few 0.01 in
    ln_post for the headline. The joint adds the HGCA's blocks, whose
    sigma of 0.03 mas/yr meets proper motions near 83 mas/yr (an ulp is
    8e-6 mas/yr), and the marginalized RV's -B^2/(4A) + C, which cancels
    from ~1.4e3 to ~40 (~1e-4 in float32): each stays below 1e-2 at these
    points, so one limit, 0.5 + 1e-4 |ln_post|, holds both."""
    with torch.no_grad():
        lp64 = ref.ln_post(pts)
        lp32 = model.ln_post(pts).double().cpu()
    err = (lp32 - lp64).abs()
    tol = 0.5 + 1e-4 * lp64.abs()
    log(f"reference ({label}): ln_post float32 GPU vs float64 CPU at {len(pts)} points: "
        f"max |diff| {float(err.max()):.4e} (ln_post in [{float(lp64.min()):.1f}, "
        f"{float(lp64.max()):.1f}]; tol 0.5 + 1e-4 |ln_post|)")
    if not bool((err <= tol).all()):
        raise AssertionError(f"{label}: float32 GPU ln_post disagrees with the float64 CPU model")


def headline_points(ot, ref, n=64):
    """`n` unconstrained points of the headline model near the truth."""
    # theta is the position angle at the reference epoch 57000
    sol = ot.orbitsolve(ot.VisualOrbit.from_params(**TRUE, device="cpu"), np.array([57000.0]))
    theta = float(ot.orbits.posangle(sol)[0])
    nat = torch.tensor([[TRUE["M"], TRUE["plx"], TRUE["a"], TRUE["e"], TRUE["i"],
                         np.cos(TRUE["omega"]), np.sin(TRUE["omega"]),
                         np.cos(TRUE["Omega"]), np.sin(TRUE["Omega"]),
                         np.cos(theta), np.sin(theta)]],
                       dtype=torch.float64)
    gen = torch.Generator().manual_seed(5)
    return ref.link(nat) + 1e-3 * torch.randn((n, ref.D), generator=gen, dtype=torch.float64)


def _reset_launches(kk, osk) -> None:
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    kk.launches = osk.launches_fwd = osk.launches_bwd = 0
    cc.launches_fwd = cc.launches_bwd = 0
    kk.launch_shapes.clear()
    cc.launch_shapes.clear()


def _launches(kk, osk) -> dict:
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    return {"kepler_solve": kk.launches, "orbit_solve_fwd": osk.launches_fwd,
            "orbit_solve_bwd": osk.launches_bwd, "celerite_fwd": cc.launches_fwd,
            "celerite_bwd": cc.launches_bwd}


def fit_phase(ot, kk, osk, model, label, chains, adaptation, iterations,
              init_kwargs=None, rhat_gate=True, orbit_fixed=False, max_depth=None) -> dict:
    """`octofit` with initialization on `model` (`initialize` first with
    `init_kwargs` where given, e.g. a guess), with every launch count
    set to 0 just before and read just after, scored by the device
    diagnostics on the draws as the sampler holds them. Checks
    what every path must show: finite draws, max split-R-hat < 1.05 (where
    `rhat_gate`; otherwise printed by parameter), the
    standalone Kepler kernel launched (by the Laplace step) and, where a
    planet has a Kep or Visual orbit, the fused pair launched on every
    batched gradient evaluation (the forward alone where `orbit_fixed`:
    no parameter reaches the orbit); a model without one solves its orbits
    with the standalone Kepler kernel, which must then run on every
    evaluation. `max_depth` caps ChEES at 2^max_depth leapfrog steps."""
    fused_pair = any(issubclass(p.basis, (ot.KepOrbit, ot.VisualOrbit))
                     for p in model.system.planets)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kk, osk)
    t0 = time.perf_counter()
    if init_kwargs is not None:
        model.initialize(gen, verbosity=1, **init_kwargs)
    chain = ot.octofit(model, chains=chains, adaptation=adaptation, iterations=iterations,
                       generator=gen, verbosity=1, max_depth=max_depth)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = _launches(kk, osk)
    kepler_shapes = dict(kk.launch_shapes)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    t_sampling = chain.info["sampling_time_s"]
    t_init = t_total - t_sampling
    n_evals = chain.info["n_grad_evals"]

    names = model.parameter_names
    x = np.stack([chain[n] for n in names], axis=-1)
    t_diag = time.perf_counter()
    ess, rhat = ot.ess_rhat_batch_device(x)
    t_diag = time.perf_counter() - t_diag
    k_min = int(np.nanargmin(ess))
    ess_min, rhat_max = float(ess[k_min]), float(np.nanmax(rhat))
    log(f"{label}: {chains} chains, {adaptation} adaptation + {iterations} draws, "
        f"{str(model.dtype).removeprefix('torch.')}")
    log(f"  init {t_init:.2f} s, sampling {t_sampling:.2f} s, device diagnostics {t_diag:.2f} s")
    log(f"  leapfrog steps {n_evals - 1}, batched gradient evaluations {n_evals}, "
        f"{t_sampling / n_evals * 1e6:.1f} us each "
        f"({t_sampling / (n_evals * chains) * 1e9:.1f} ns per chain-gradient)")
    log(f"  min rank-normalized ESS {ess_min:.1f} on {names[k_min]} "
        f"({ess_min / (chains * iterations):.4f} per draw), max split-R-hat {rhat_max:.5f}, "
        f"ESS/s {ess_min / t_sampling:.1f}")
    log(f"  ESS per draw by parameter: "
        f"{ {n: round(float(e) / (chains * iterations), 4) for n, e in zip(names, ess)} }")
    log(f"  kernel launches: {launches}; kepler_solve by shape: {kepler_shapes}")
    log(f"  peak device memory of the run {peak_gib:.3f} GiB")
    if launches["kepler_solve"] == 0:
        raise AssertionError(f"{label}: the Laplace step never launched the standalone Kepler kernel")
    if orbit_fixed and launches["orbit_solve_bwd"]:
        raise AssertionError(f"{label}: the fused backward ran for an orbit with no free parameter")
    pair = ("orbit_solve_fwd",) if orbit_fixed else ("orbit_solve_fwd", "orbit_solve_bwd")
    if fused_pair and min(launches[k] for k in pair) < n_evals:
        raise AssertionError(f"{label}: the fused orbit-solve kernels were launched fewer times "
                             f"than the {n_evals} gradient evaluations")
    if not fused_pair and launches["kepler_solve"] < n_evals:
        raise AssertionError(f"{label}: the Kepler kernel was launched fewer times than the "
                             f"{n_evals} gradient evaluations")
    if not bool(np.isfinite(x).all()):
        raise AssertionError(f"{label}: non-finite draws")
    log(f"  split-R-hat by parameter{'' if rhat_gate else ' (reported, not gated)'}: "
        f"{ {n: round(float(r), 4) for n, r in zip(names, rhat)} }")
    if rhat_gate and not rhat_max < 1.05:
        raise AssertionError(f"{label}: max split-R-hat {rhat_max} >= 1.05")
    return {"launches": launches, "kepler_shapes": kepler_shapes, "model": model,
            "chain": chain, "x": x, "n_evals": n_evals, "t_sampling": t_sampling,
            "t_init": t_init, "ess": ess, "rhat": rhat, "peak_gib": peak_gib}


def _gate_median(label, chain, name, truth) -> None:
    """The posterior median of `name` within 5 sd of `truth`."""
    v = chain[name].reshape(-1)
    med, sd = float(np.median(v)), float(v.std())
    log(f"  {name} median {med:.5f}, sd {sd:.5f} (true {truth}; {abs(med - truth) / sd:.2f} sd)")
    if not abs(med - truth) <= 5 * sd:
        raise AssertionError(f"{label}: {name} median {med} is more than 5 sd ({sd}) from {truth}")


def main_path_phase(ot, kk, osk, chains, adaptation, iterations) -> dict:
    """The headline fit: reference check, then the fit and its gates."""
    table = bench_table(ot)
    model = build_model(ot, table, device="cuda", dtype=torch.float32)
    ref = build_model(ot, table, device="cpu", dtype=torch.float64)
    reference_phase("headline", model, ref, headline_points(ot, ref))
    res = fit_phase(ot, kk, osk, model, "main path", chains, adaptation, iterations)
    _gate_median("main path", res["chain"], "b_a", TRUE["a"])
    res["table"] = table
    return res


def joint_path_phase(ot, kk, osk, chains, adaptation, iterations) -> dict:
    """The joint astrometry + HGCA + marginalized-RV fit
    (`examples/02_joint_astrom_pma_rv.py`) at the full width of 70 epochs:
    its data made on the CPU in float64, the float32 GPU model checked
    against a float64 CPU model, then the fit and its gates."""
    data = joint_data(ot)
    model = build_joint_model(ot, data, device="cuda", dtype=torch.float32)
    ref = build_joint_model(ot, data, device="cpu", dtype=torch.float64)
    reference_phase("joint", model, ref, joint_points_near_truth(ot, ref, 64, seed=5))
    res = fit_phase(ot, kk, osk, model, "joint path", chains, adaptation, iterations)
    log(f"  mixing: min ESS per draw against the JAX package's 0.340 on b_e "
        f"(MEASUREMENTS.md, a TPU run at 8192 chains x 3000 draws; not a gate)")
    _gate_median("joint path", res["chain"], "b_mass", JOINT_MASS)
    _gate_median("joint path", res["chain"], "b_a", JOINT_TRUE["a"])
    return res


def pt_path_phase(ot, kk, osk, n_rounds, share_init=None) -> dict:
    """The partial-arc parallel-tempering fit (`bench.py:229-296`): the
    float32 GPU model checked against a float64 CPU model, `initialize`
    with the default sizes, then `octofit_pigeons` with the bench's
    `_PA_KWARGS` for `n_rounds` rounds, every launch count set to 0 just
    before the initialization and read after it and after sampling.
    Gates: finite draws, finite log-evidence and barriers, every
    swap-rejection rate in (0, 1), swaps accepted on every pair between
    two annealed rungs (see SWAP_REJECTION_MAX), the ridge covered
    (tests/test_tempering.py's bound: q5(b_a) < 12 and q95(b_a) > 25), the
    standalone Kepler kernel launched by the Laplace step and the fused
    pair on every explorer evaluation and every components pass. Prints
    max split-R-hat and min ESS of the 2W recorded chains by the device
    diagnostics, and `partial_arc_pt_ess_per_sec` as the bench counts it:
    the min ESS over every column of the chains over the wall time from
    the start of sampling to the end of the diagnostics. With `share_init`
    (a path), the initialized starting points and Laplace sigma are saved
    there for phase 35 (`save_init`)."""
    table = bench_table(ot, *PA_SPAN)
    model = build_model(ot, table, name="bench_partial_arc", device="cuda", dtype=torch.float32)
    ref = build_model(ot, table, name="bench_partial_arc", device="cpu", dtype=torch.float64)
    reference_phase("partial arc", model, ref, headline_points(ot, ref))
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kk, osk)
    t0 = time.perf_counter()
    model.initialize(gen, verbosity=1)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_launches = _launches(kk, osk)
    if share_init is not None:
        save_init(model, share_init)
    kepler_shapes = dict(kk.launch_shapes)
    t_start = time.perf_counter()
    chain, info = ot.octofit_pigeons(model, generator=gen, n_rounds=n_rounds, verbosity=1,
                                     **PA_KWARGS)
    torch.cuda.synchronize()
    launches = _launches(kk, osk)
    sampling_launches = {k: launches[k] - init_launches[k] for k in launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    names = model.parameter_names
    x = np.stack([chain[n] for n in names], axis=-1)
    t_diag = time.perf_counter()
    ess, rhat = ot.ess_rhat_batch_device(x)
    x_all = np.stack([chain[n] for n in chain.names], axis=-1)
    ess_all, _ = ot.ess_rhat_batch_device(x_all)
    t_diag = time.perf_counter() - t_diag
    ess_per_sec = float(np.nanmin(ess_all)) / (time.perf_counter() - t_start)
    k_min = int(np.nanargmin(ess))
    ess_min, rhat_max = float(ess[k_min]), float(np.nanmax(rhat))
    n_evals, n_sweeps, t_sampling = info["n_grad_evals"], info["n_sweeps"], info["sampling_time_s"]
    n_draws = x.shape[0] * x.shape[1]
    W, NT = PA_KWARGS["n_walkers"], PA_KWARGS["n_chains"] + PA_KWARGS["n_chains_variational"]
    log(f"partial-arc PT: {W} walkers x ({PA_KWARGS['n_chains']} + "
        f"{PA_KWARGS['n_chains_variational']}) rungs = {W * NT} chains, ChEES explorer capped at "
        f"{PA_KWARGS['explorer_n_leapfrog']}, {n_rounds} rounds ({n_sweeps} sweeps; the bench's 9 "
        f"are {2**10 - 2}), float32")
    for r in info["rounds"]:
        log(f"  round {r['round']}: {r['sweeps']} sweeps in {r['seconds']:.2f} s; per-rung leapfrog "
            f"steps longest {r['L_longest']}, median {r['L_median']:g}; barrier {r['barrier']:.3f}, "
            f"variational barrier {r['barrier_variational']:.3f}; round trips {r['round_trips']}")
    log(f"  init {t_init:.2f} s, sampling {t_sampling:.2f} s, device diagnostics {t_diag:.2f} s")
    log(f"  batched annealed gradient evaluations {n_evals} ({t_sampling / n_evals * 1e6:.1f} us "
        f"each, sweeps included), components passes {n_sweeps}")
    log(f"  recorded draws {x.shape[0]} chains x {x.shape[1]}; min rank-normalized ESS "
        f"{ess_min:.1f} on {names[k_min]} ({ess_min / n_draws:.4f} per draw), max split-R-hat "
        f"{rhat_max:.5f}; partial_arc_pt_ess_per_sec {ess_per_sec:.3f} (min ESS over all "
        f"{len(chain.names)} columns {float(np.nanmin(ess_all)):.1f})")
    log(f"  log-evidence {info['logevidence']:.3f} (se {info['logevidence_se']:.3f}), barrier "
        f"{info['global_barrier']:.3f}, variational barrier "
        f"{info['global_barrier_variational']:.3f}, round trips {info['n_round_trips']}")
    log(f"  swap rejection {np.round(info['swap_rejection'], 4).tolist()}")
    log(f"  betas {np.round(info['betas'], 5).tolist()}; variational "
        f"{np.round(info['betas_variational'], 5).tolist()}")
    log(f"  trajectory lengths {np.round(info['trajectory_length'], 5).tolist()}")
    log(f"  kernel launches: initialization {init_launches}, sampling {sampling_launches}; "
        f"kepler_solve by shape: {kepler_shapes}")
    log(f"  peak device memory of the run {peak_gib:.3f} GiB")
    a = chain["b_a"].reshape(-1)
    q5, q50, q95 = np.quantile(a, [0.05, 0.5, 0.95])
    log(f"  b_a quantiles 5/50/95%: {q5:.3f} / {q50:.3f} / {q95:.3f} (ridge bound: q5 < 12, q95 > 25)")

    if not bool(np.isfinite(x).all()):
        raise AssertionError("partial arc: non-finite draws")
    inner_pairs = [j for j in range(NT - 1) if j not in (0, PA_KWARGS["n_chains"] - 1, NT - 2)]
    worst_pair = max(inner_pairs, key=lambda j: info["swap_rejection"][j])
    log(f"  swap rejection between annealed rungs at most {info['swap_rejection'][worst_pair]:.4f} "
        f"(pair {worst_pair}; limit {SWAP_REJECTION_MAX})")
    if not info["swap_rejection"][worst_pair] < SWAP_REJECTION_MAX:
        raise AssertionError(f"partial arc: swaps across pair {worst_pair} were all but never accepted")
    if not all(np.isfinite(info[k]) for k in
               ("logevidence", "global_barrier", "global_barrier_variational")):
        raise AssertionError("partial arc: non-finite log-evidence or barrier")
    if not bool(((info["swap_rejection"] > 0) & (info["swap_rejection"] < 1)).all()):
        raise AssertionError("partial arc: a swap-rejection rate outside (0, 1)")
    if not (q5 < 12.0 and q95 > 25.0):
        raise AssertionError(f"partial arc: the ridge is not covered (q5 {q5}, q95 {q95})")
    if launches["kepler_solve"] == 0:
        raise AssertionError("partial arc: the Laplace step never launched the standalone Kepler kernel")
    if (sampling_launches["orbit_solve_fwd"] < n_evals + n_sweeps
            or sampling_launches["orbit_solve_bwd"] < n_evals):
        raise AssertionError(
            f"partial arc: the fused orbit-solve kernels were launched {sampling_launches} times, "
            f"fewer than the {n_evals} gradient evaluations (+ {n_sweeps} components passes)")
    return {"launches": launches, "kepler_shapes": kepler_shapes, "chain": chain, "x": x,
            "model": model}


def nuts_path_phase(ot, kk, osk, model) -> dict:
    """`octofit(sampler="nuts")` and then a short `octofit(sampler="hmc")` on
    the headline model that the main path initialized (its starting points,
    and its Laplace covariance as every chain's first dense metric), in
    float32, every launch count set to 0 just before each run and read just
    after. NUTS gates: max split-R-hat < 1.05 by the device diagnostics,
    finite draws, the medians of b_a and b_e within 5 sd of the truth, the
    fused pair launched on every batched evaluation. It prints the batched
    evaluations per sampling transition (per depth, the deepest chain's
    leaves) beside the mean leaves per chain: their ratio is what the
    lockstep costs. HMC gates: finite draws, every acceptance in [0, 1] and
    the mean acceptance in (0, 1], the fused pair on every evaluation."""
    res = {}
    runs = (("nuts", NUTS_ADAPTATION, NUTS_ITERATIONS, NUTS_MAX_DEPTH),
            ("hmc", HMC_ADAPTATION, HMC_ITERATIONS, HMC_MAX_DEPTH))
    for sampler, adaptation, iterations, max_depth in runs:
        label = f"{sampler} path"
        gen = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(kk, osk)
        chain = ot.octofit(model, sampler=sampler, chains=NUTS_CHAINS, adaptation=adaptation,
                           iterations=iterations, max_depth=max_depth, generator=gen, verbosity=1)
        torch.cuda.synchronize()
        launches = _launches(kk, osk)
        t_sampling, n_evals = chain.info["sampling_time_s"], chain.info["n_grad_evals"]
        x = np.stack([chain[n] for n in model.parameter_names], axis=-1)
        acc = chain.internals["acceptance_rate"]
        log(f"{label}: {NUTS_CHAINS} chains, {adaptation} adaptation + {iterations} draws, "
            f"max_depth {max_depth}, float32")
        log(f"  sampling {t_sampling:.2f} s, batched gradient evaluations {n_evals} "
            f"({t_sampling / n_evals * 1e6:.1f} us each), mean acceptance {float(acc.mean()):.4f}, "
            f"divergences {int(chain.internals['is_divergent'].sum())}")
        log(f"  kernel launches: {launches}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if not bool(np.isfinite(x).all()):
            raise AssertionError(f"{label}: non-finite draws")
        if min(launches["orbit_solve_fwd"], launches["orbit_solve_bwd"]) < n_evals:
            raise AssertionError(f"{label}: the fused orbit-solve kernels were launched fewer times "
                                 f"than the {n_evals} gradient evaluations")
        if sampler == "nuts":
            te = chain.info["transition_evals"]
            per_transition = float(te[adaptation:].mean())
            leaves = float(chain.internals["n_steps"].mean())
            depth = chain.internals["tree_depth"]
            log(f"  sampling transitions: {per_transition:.2f} batched evaluations each (the deepest "
                f"chain's leaves per depth), {leaves:.2f} leaves per chain on average: lockstep "
                f"costs {per_transition / leaves:.3f}x; tree depth mean {float(depth.mean()):.3f}, "
                f"max {int(depth.max())}; adaptation transitions {float(te[:adaptation].mean()):.2f} "
                f"evaluations each")
            log(f"  step sizes: median {float(np.median(chain.info['step_size'])):.5f}, range "
                f"[{float(np.min(chain.info['step_size'])):.5f}, "
                f"{float(np.max(chain.info['step_size'])):.5f}]")
            ess, rhat = ot.ess_rhat_batch_device(x)
            k_min = int(np.nanargmin(ess))
            rhat_max = float(np.nanmax(rhat))
            log(f"  min rank-normalized ESS {float(ess[k_min]):.1f} on "
                f"{model.parameter_names[k_min]} ({float(ess[k_min]) / x[..., 0].size:.4f} per "
                f"draw), max split-R-hat {rhat_max:.5f}, ESS/s {float(ess[k_min]) / t_sampling:.1f}")
            if not rhat_max < 1.05:
                raise AssertionError(f"{label}: max split-R-hat {rhat_max} >= 1.05")
            _gate_median(label, chain, "b_a", TRUE["a"])
            _gate_median(label, chain, "b_e", TRUE["e"])
            res.update(launches=launches, n_evals=n_evals, per_transition=per_transition,
                       leaves=leaves, x=x)
        else:
            if not (bool(((acc >= 0) & (acc <= 1)).all()) and 0 < float(acc.mean()) <= 1):
                raise AssertionError(f"{label}: acceptance outside (0, 1]")
            res["hmc_launches"] = launches
    return res


def pt_nuts_phase(ot, kk, osk, model) -> dict:
    """`octofit_pigeons` with the NUTS explorer on the partial-arc model
    that the PT path initialized: the bench's ladder (8 + 8 rungs) at
    PT_NUTS_KWARGS' walkers for PT_NUTS_ROUNDS rounds, float32, every launch
    count set to 0 just before and read just after. Gates: finite draws,
    log-evidence and barriers, every rung's mean explorer acceptance in the
    recording round in (0, 1], and the fused pair launched on every
    annealed evaluation (forward also on every components pass)."""
    kw = PT_NUTS_KWARGS
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kk, osk)
    chain, info = ot.octofit_pigeons(model, generator=gen, n_rounds=PT_NUTS_ROUNDS, verbosity=1,
                                     **kw)
    torch.cuda.synchronize()
    launches = _launches(kk, osk)
    n_evals, n_sweeps, t_sampling = info["n_grad_evals"], info["n_sweeps"], info["sampling_time_s"]
    W, NT = kw["n_walkers"], kw["n_chains"] + kw["n_chains_variational"]
    x = np.stack([chain[n] for n in model.parameter_names], axis=-1)
    log(f"partial-arc PT, NUTS explorer: {W} walkers x ({kw['n_chains']} + "
        f"{kw['n_chains_variational']}) rungs = {W * NT} chains, explorer_max_depth "
        f"{kw['explorer_max_depth']}, {PT_NUTS_ROUNDS} rounds ({n_sweeps} sweeps), float32")
    for r in info["rounds"]:
        log(f"  round {r['round']}: {r['sweeps']} sweeps in {r['seconds']:.2f} s; per-rung longest "
            f"tree (leaves) longest {r['L_longest']}, median {r['L_median']:g}; barrier "
            f"{r['barrier']:.3f}; acceptance by rung {np.round(r['acceptance'], 3).tolist()}")
    log(f"  sampling {t_sampling:.2f} s, batched annealed gradient evaluations {n_evals} "
        f"({t_sampling / n_evals * 1e6:.1f} us each, sweeps included, "
        f"{n_evals / n_sweeps:.1f} per sweep)")
    log(f"  log-evidence {info['logevidence']:.3f} (se {info['logevidence_se']:.3f}), barrier "
        f"{info['global_barrier']:.3f}, variational barrier "
        f"{info['global_barrier_variational']:.3f}, round trips {info['n_round_trips']}")
    log(f"  kernel launches: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    acc = info["rounds"][-1]["acceptance"]
    if not bool(np.isfinite(x).all()):
        raise AssertionError("PT NUTS: non-finite draws")
    if not all(np.isfinite(info[k]) for k in
               ("logevidence", "global_barrier", "global_barrier_variational")):
        raise AssertionError("PT NUTS: non-finite log-evidence or barrier")
    if not bool(((acc > 0) & (acc <= 1)).all()):
        raise AssertionError(f"PT NUTS: a rung's acceptance outside (0, 1]: {acc}")
    if launches["orbit_solve_fwd"] < n_evals + n_sweeps or launches["orbit_solve_bwd"] < n_evals:
        raise AssertionError(
            f"PT NUTS: the fused orbit-solve kernels were launched {launches} times, fewer than "
            f"the {n_evals} gradient evaluations (+ {n_sweeps} components passes)")
    return {"launches": launches, "n_evals": n_evals}


def rejection_phase(ot, kk, osk) -> dict:
    """The OFTI workflow (`examples/09_ofti_rejection.py`): its model built
    with the port in float64 on the GPU (the marginal likelihood cancels
    about four digits), checked against the float64 CPU model at 64 prior
    draws, then `octofit_rejection` at the example's sizes, every launch
    count set to 0 just before and read just after. Gates: num_samples
    draws accepted, finite; the medians of e, a, M and plx within 5
    posterior sd of the truth; the standalone Kepler kernel launched once
    per batch at (batch_size, 8) (and once more for the accepted draws)."""
    data = ofti_data(ot)
    model = build_ofti_model(ot, data, device="cuda", dtype=torch.float64)
    ref = build_ofti_model(ot, data, device="cpu", dtype=torch.float64)
    pts = ref.link(ref.sample_priors(torch.Generator().manual_seed(7), 64))
    with torch.no_grad():
        lp_ref = ref.ln_post(pts)
        lp_gpu = model.ln_post(pts).cpu()
    err = float((lp_gpu - lp_ref).abs().max())
    log(f"reference (OFTI): ln_post float64 GPU vs float64 CPU at 64 prior draws: max |diff| "
        f"{err:.3e} (ln_post in [{float(lp_ref.min()):.1f}, {float(lp_ref.max()):.1f}]; tol 1e-6)")
    if not err <= 1e-6:
        raise AssertionError("OFTI: the GPU model disagrees with the CPU model")

    gen = torch.Generator(device="cuda").manual_seed(0)
    _reset_launches(kk, osk)
    t0 = time.perf_counter()
    chain = ot.octofit_rejection(model, generator=gen, verbosity=1, **REJECTION_KWARGS)
    torch.cuda.synchronize()
    t_rej = time.perf_counter() - t0
    launches = _launches(kk, osk)
    kepler_shapes = dict(kk.launch_shapes)
    n_batches, frac = chain.info["n_batches"], chain.info["acceptance_fraction"]
    rate = chain.info["n_accepted"] / chain.info["n_drawn"]
    batch = REJECTION_KWARGS["batch_size"]
    log(f"rejection (OFTI): {n_batches} batches of {batch} prior draws in {t_rej:.2f} s "
        f"({t_rej / n_batches:.3f} s per batch, {n_batches * batch / t_rej / 1e6:.3f} M draws/s), "
        f"acceptance rate {rate:.4e} ({chain.info['n_accepted']} of {chain.info['n_drawn']} "
        f"accepted; acceptance_fraction, cut to num_samples, {frac:.4e}), float64")
    log(f"  kernel launches: {launches}; kepler_solve by shape: {kepler_shapes}")
    n_acc = len(chain.flat("e"))
    if n_acc != REJECTION_KWARGS["num_samples"]:
        raise AssertionError(f"OFTI: {n_acc} draws accepted, not {REJECTION_KWARGS['num_samples']}")
    if not all(np.isfinite(chain.flat(k)).all() for k in chain.names):
        raise AssertionError("OFTI: non-finite draws")
    for name in ("e", "a", "M", "plx"):
        _gate_median("rejection", chain, name, OFTI_TRUE[name])
    if kepler_shapes.get((batch, OFTI_EPOCHS)) != n_batches:
        raise AssertionError(f"OFTI: the Kepler kernel was launched {kepler_shapes} times, not once "
                             f"per batch at ({batch}, {OFTI_EPOCHS})")
    return {"launches": launches, "kepler_shapes": kepler_shapes, "seconds": t_rej,
            "n_batches": n_batches, "acceptance_rate": rate}


def calibration_phase(ot, kk, osk) -> dict:
    """The calibration fit (discrete prior marginalized, K = 2): the float32
    GPU model checked against a float64 CPU model, then `octofit` with
    initialization at CHAINS chains through `fit_phase` and its gates, and
    the discrete column: the posterior mean of b_simdata_cal above 0.9 (the
    data were recorded at CAL_SCALE), the median of b_a within 5 sd of 7."""
    t0 = time.perf_counter()
    table = calibration_table(ot)
    model = build_calibration_model(ot, table, device="cuda", dtype=torch.float32)
    ref = build_calibration_model(ot, table, device="cpu", dtype=torch.float64)
    if not (model.discrete_mode == "marginalize" and model.discrete_names == ["b_simdata_cal"]):
        raise AssertionError(f"calibration: mode {model.discrete_mode}, {model.discrete_names}")
    reference_phase("calibration", model, ref, headline_points(ot, ref))
    res = fit_phase(ot, kk, osk, model, "calibration fit (marginalized, K = 2)", CHAINS,
                    CAL_ADAPTATION, CAL_ITERATIONS)
    cal = res["chain"]["b_simdata_cal"]
    log(f"  posterior mean of b_simdata_cal {float(cal.mean()):.5f} (data at plate scale "
        f"{CAL_SCALE}: cal = 1)")
    if not float(cal.mean()) > 0.9:
        raise AssertionError(f"calibration: mean b_simdata_cal {float(cal.mean())} <= 0.9")
    _gate_median("calibration", res["chain"], "b_a", TRUE["a"])
    res["seconds"] = time.perf_counter() - t0
    log(f"calibration phase: {res['seconds']:.2f} s")
    return res


def outlier_phase(ot, kk, osk, init_model, adaptation=None, iterations=None) -> dict:
    """The outlier fit (Gibbs-within-HMC, K = 2^13): the float32 GPU model
    checked against a float64 CPU model, then `octofit` at CHAINS chains
    from `init_model`'s starting points and Laplace covariance (the same 11
    continuous parameters), which must switch to Gibbs by itself, every
    launch count set to 0 just before and read just after. Gates: finite
    draws, max split-R-hat < 1.05 on the continuous parameters by the
    device diagnostics, the displaced epoch's flag mean above 0.9 and every
    other flag's below 0.2, the median of b_a within 5 sd of 7, the fused
    pair on every value-and-gradient evaluation and the fused forward alone
    once per discrete variable per sweep. adaptation and iterations:
    GIBBS_ADAPTATION and GIBBS_ITERATIONS unless given."""
    adaptation = GIBBS_ADAPTATION if adaptation is None else adaptation
    iterations = GIBBS_ITERATIONS if iterations is None else iterations
    t0 = time.perf_counter()
    table = outlier_table(ot)
    model = build_outlier_model(ot, table, device="cuda", dtype=torch.float32)
    ref = build_outlier_model(ot, table, device="cpu", dtype=torch.float64)
    n_disc = len(model.discrete_names)
    if not (model.discrete_mode == "gibbs" and n_disc == OUTLIER_EPOCHS):
        raise AssertionError(f"outlier: mode {model.discrete_mode}, {n_disc} discrete variables")
    reference_phase("outlier", model, ref, headline_points(ot, ref))
    model.starting_points = init_model.starting_points
    model.laplace_sigma = init_model.laplace_sigma
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kk, osk)
    chain = ot.octofit(model, chains=CHAINS, adaptation=adaptation, iterations=iterations,
                       generator=gen, verbosity=1)
    torch.cuda.synchronize()
    launches = _launches(kk, osk)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    info = chain.info
    t_sampling, n_evals, n_sweep = (info["sampling_time_s"], info["n_grad_evals"],
                                    info["n_sweep_evals"])
    names = model.parameter_names
    x = np.stack([chain[n] for n in names], axis=-1)
    ess, rhat = ot.ess_rhat_batch_device(x)
    k_min = int(np.nanargmin(ess))
    ess_min, rhat_max = float(ess[k_min]), float(np.nanmax(rhat))
    flags = np.array([float(chain[f"b_simdata_flag_{j + 1}"].mean()) for j in range(n_disc)])
    log(f"outlier fit (Gibbs-within-HMC, K = 2^{n_disc}): {CHAINS} chains, {adaptation} "
        f"adaptation + {iterations} draws, float32, sampler {info['sampler']}")
    log(f"  sampling {t_sampling:.2f} s: {n_evals} batched value-and-gradient evaluations and "
        f"{n_sweep} sweep evaluations ({t_sampling / (n_evals + n_sweep) * 1e6:.1f} us per "
        f"evaluation on average), mean acceptance "
        f"{float(chain.internals['acceptance_rate'].mean()):.4f}, divergences "
        f"{int(chain.internals['is_divergent'].sum())}")
    log(f"  min rank-normalized ESS {ess_min:.1f} on {names[k_min]} "
        f"({ess_min / (CHAINS * iterations):.4f} per draw), max split-R-hat {rhat_max:.5f}, "
        f"ESS/s {ess_min / t_sampling:.1f}")
    log(f"  flag means {np.round(flags, 4).tolist()} (epoch {OUTLIER_INDEX} displaced)")
    log(f"  kernel launches: {launches}; peak device memory {peak_gib:.3f} GiB")
    if info["sampler"] != "gibbs_vectorized":
        raise AssertionError(f"outlier: octofit ran {info['sampler']}, not Gibbs-within-HMC")
    if not bool(np.isfinite(x).all()):
        raise AssertionError("outlier: non-finite draws")
    if not rhat_max < 1.05:
        raise AssertionError(f"outlier: max split-R-hat {rhat_max} >= 1.05")
    others = np.delete(flags, OUTLIER_INDEX)
    if not (flags[OUTLIER_INDEX] > 0.9 and bool((others < 0.2).all())):
        raise AssertionError(f"outlier: flag means {flags.tolist()}")
    _gate_median("outlier", chain, "b_a", TRUE["a"])
    if launches["orbit_solve_bwd"] != n_evals:
        raise AssertionError(f"outlier: {launches['orbit_solve_bwd']} fused backward launches for "
                             f"{n_evals} gradient evaluations")
    if launches["orbit_solve_fwd"] - launches["orbit_solve_bwd"] != n_sweep:
        raise AssertionError(f"outlier: the fused forward ran {launches['orbit_solve_fwd']} times, "
                             f"not once per gradient evaluation and once per variable per sweep")
    seconds = time.perf_counter() - t0
    log(f"outlier phase: {seconds:.2f} s")
    return {"launches": launches, "x": x, "n_evals": n_evals, "n_sweep": n_sweep,
            "seconds": seconds, "t_sampling": t_sampling}


# The cap case, float32 GPU against float64 CPU: ln_post within
# reference_phase's limit, the gradient within CAP_GRAD_TOL of each chain's
# largest entry (an NVIDIA H100 80GB HBM3 reads 1.374e-3 at these points).
CAP_GRAD_TOL = 1e-2
CAP_CHECK_CHAINS = 4


def cap_phase(ot, kk, osk) -> dict:
    """The outlier model at 12 epochs, K = 4096 combinations, the most that
    are marginalized: one float32 `ln_post_and_grad` at CAP_CHAINS chains
    (CAP_CHAINS x 4096 rows), its launch counts set to 0 just before, its
    peak device memory and number of chunks printed; held against the
    float64 CPU model at CAP_CHECK_CHAINS chains; then the same evaluation
    forced into chunks of 512 combinations, each recomputed in the backward
    pass, held against the one-pass result, with its own peak memory."""
    t0 = time.perf_counter()
    table = outlier_table(ot, CAP_EPOCHS)
    model = build_outlier_model(ot, table, device="cuda", dtype=torch.float32)
    ref = build_outlier_model(ot, table, device="cpu", dtype=torch.float64)
    K = len(model._disc_combos) if model._disc_combos is not None else 0
    if not (model.discrete_mode == "marginalize" and K == 4096):
        raise AssertionError(f"cap: mode {model.discrete_mode}, K = {K}")
    pts = headline_points(ot, ref, CAP_CHAINS)

    def evaluate():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        lp, g = model.ln_post_and_grad(pts)
        torch.cuda.synchronize()
        return lp, g, time.perf_counter() - t, torch.cuda.max_memory_allocated() - before

    model.ln_post_and_grad(pts)  # warm-up
    _reset_launches(kk, osk)
    lp, g, dt, peak = evaluate()
    launches = _launches(kk, osk)
    chunk = min(K, model._combo_chunk(CAP_CHAINS))
    n_chunks = -(-K // chunk)
    rows = CAP_CHAINS * K
    log(f"cap case: {CAP_CHAINS} chains x {K} combinations = {rows} rows x {CAP_EPOCHS} epochs, "
        f"float32: one ln_post_and_grad in {dt * 1e3:.1f} ms, {n_chunks} chunk(s) of {chunk} "
        f"combinations, peak device memory {peak / 2**30:.3f} GiB "
        f"({peak / (rows * CAP_EPOCHS):.1f} bytes per row and epoch); launches {launches}")
    if not (bool(torch.isfinite(lp).all()) and bool(torch.isfinite(g).all())):
        raise AssertionError("cap: non-finite ln_post or gradient")
    if launches["orbit_solve_fwd"] < 1 or launches["orbit_solve_bwd"] < 1:
        raise AssertionError("cap: the fused pair was not launched")

    lp64, g64 = ref.ln_post_and_grad(pts[:CAP_CHECK_CHAINS])
    d_lp = (lp[:CAP_CHECK_CHAINS].double().cpu() - lp64).abs()
    d_g = float(((g[:CAP_CHECK_CHAINS].double().cpu() - g64).abs().amax(dim=1)
                 / g64.abs().amax(dim=1)).max())
    log(f"  against the float64 CPU model at {CAP_CHECK_CHAINS} chains: max |d ln_post| "
        f"{float(d_lp.max()):.4e} (tol 0.5 + 1e-4 |ln_post|, ln_post in "
        f"[{float(lp64.min()):.2f}, {float(lp64.max()):.2f}]); gradient {d_g:.3e} of each "
        f"chain's largest entry (tol {CAP_GRAD_TOL:.0e})")
    if not (bool((d_lp <= 0.5 + 1e-4 * lp64.abs()).all()) and d_g <= CAP_GRAD_TOL):
        raise AssertionError("cap: the float32 GPU evaluation disagrees with the float64 CPU model")

    model._combo_chunk = lambda n_theta: 512
    lp_c, g_c, dt_c, peak_c = evaluate()
    del model._combo_chunk
    d_lp_c = float((lp_c - lp).abs().max())
    d_g_c = float(((g_c - g).abs().amax(dim=1) / g.abs().amax(dim=1)).max())
    log(f"  forced into {K // 512} chunks of 512, each recomputed in the backward pass: "
        f"{dt_c * 1e3:.1f} ms, peak device memory {peak_c / 2**30:.3f} GiB; against one pass: "
        f"max |d ln_post| {d_lp_c:.3e}, gradient {d_g_c:.3e} of each chain's largest entry "
        f"(tol 1e-4)")
    if not (d_lp_c <= 1e-4 * float(lp.abs().max()) and d_g_c <= 1e-4):
        raise AssertionError("cap: the chunked evaluation disagrees with the one-pass one")
    seconds = time.perf_counter() - t0
    log(f"cap phase: {seconds:.2f} s")
    return {"launches": launches, "peak_bytes": peak, "chunks": n_chunks, "ms": dt * 1e3,
            "seconds": seconds}


def discrete_kernel_phase(osk, elements) -> dict:
    """The fused pair against its plain versions, and timed, in float32 at
    the discrete paths' shapes: the calibration fit's (CHAINS x 2, 12), the
    Gibbs sweep's (CHAINS x 2, 13), the Gibbs HMC leg's (CHAINS, 13) and the
    cap case's (CAP_CHAINS x 4096, 12)."""
    t0 = time.perf_counter()
    shapes = ((f"({2 * CHAINS}, {N_EPOCHS})", 2 * CHAINS, N_EPOCHS, None, HEADLINE_GRID),
              (f"({2 * CHAINS}, {OUTLIER_EPOCHS})", 2 * CHAINS, OUTLIER_EPOCHS, None,
               HEADLINE_GRID),
              (f"({CHAINS}, {OUTLIER_EPOCHS})", CHAINS, OUTLIER_EPOCHS, None, HEADLINE_GRID),
              (f"({CAP_CHAINS * 4096}, {CAP_EPOCHS})", CAP_CHAINS * 4096, CAP_EPOCHS, None,
               HEADLINE_GRID))
    res = orbit_shapes_phase(osk, elements, shapes, (torch.float32,))
    log(f"discrete kernel phase: {time.perf_counter() - t0:.2f} s")
    return res


# The device diagnostics against the numpy oracle on the same float32
# draws: the JAX package's own float32 tolerances for the same comparison
# (tests/test_chains_batch.py), ESS to 2e-3 and R-hat to 1e-4 relative.
# Ranks and ties are exact on both sides; the float32 scores, sums and FFT
# carry ~1e-6 relative.
DIAG_ESS_RTOL, DIAG_RHAT_RTOL = 2e-3, 1e-4


def _diag_compare(ot, label, x) -> dict:
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ess_d, rhat_d = ot.ess_rhat_batch_device(x)
    t_dev = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    t0 = time.perf_counter()
    ess_h, rhat_h = ot.ess_rhat_batch(x)
    t_host = time.perf_counter() - t0
    m, n, P = x.shape
    d_ess = float(np.nanmax(np.abs(ess_d / ess_h - 1)))
    d_rhat = float(np.nanmax(np.abs(rhat_d / rhat_h - 1)))
    log(f"diagnostics {label} ({m} x {n} x {P}, {x.dtype}): device {t_dev:.3f} s, numpy "
        f"{t_host:.3f} s; ESS within {d_ess:.2e} relative (tol {DIAG_ESS_RTOL:.0e}), R-hat "
        f"within {d_rhat:.2e} (tol {DIAG_RHAT_RTOL:.0e}); peak device memory above the "
        f"draws' {peak / 2**30:.3f} GiB ({peak / (m * n * P):.1f} bytes per draw and parameter)")
    if not (np.array_equal(np.isnan(ess_d), np.isnan(ess_h))
            and np.array_equal(np.isnan(rhat_d), np.isnan(rhat_h))):
        raise AssertionError(f"diagnostics {label}: NaN where the oracle has none, or the reverse")
    if not (d_ess <= DIAG_ESS_RTOL and d_rhat <= DIAG_RHAT_RTOL):
        raise AssertionError(f"diagnostics {label}: the device disagrees with the numpy oracle")
    return dict(device_s=t_dev, numpy_s=t_host, peak_bytes=peak, ess_err=d_ess, rhat_err=d_rhat,
                ess=ess_d, rhat=rhat_d)


def diagnostics_phase(ot, paths) -> dict:
    """`ess_rhat_batch_device` on the card against the numpy oracle, both
    timed: on each path's draws, then on a synthetic case past S = 2^23
    (8192 chains x 1040 draws x 2 parameters, with the repeated draws of
    rejected moves and multi-way ties), where a float32 Blom score that
    saturated would give NaN R-hat and an ESS of exactly m n."""
    res = {label: _diag_compare(ot, label, x) for label, x in paths}
    rng = np.random.default_rng(9)
    m, n = 8192, 1040
    steps = rng.standard_normal((m, n, 2)) * 0.05 * (rng.random((m, n, 2)) < 0.7)
    x = np.cumsum(steps, axis=1) + rng.standard_normal((m, 1, 2))
    x[:, :, 1] = np.round(x[:, :, 1] * 4.0) / 4.0
    x = x.astype(np.float32)
    out = _diag_compare(ot, f"synthetic S = {m * n} > 2^23", x)
    if np.isnan(out["rhat"]).any() or np.any(out["ess"] == m * n):
        raise AssertionError("diagnostics past S = 2^23: the float32 scores saturated")
    res["synthetic"] = out
    return res


def kepler_path_phase(kk, kepler_mod, shapes, dtypes=(torch.float32, torch.float64)) -> dict:
    """The standalone Kepler kernel against its twin at every shape the
    main path launched it with, through `kepler_solver` as that path calls
    it: M contiguous, one eccentricity per chain expanded over the epochs
    (the Function makes it contiguous). 64 draws per shape and precision (8
    from 2^16 elements up), the first with e = 0, the second with e = 0.99,
    the third with M = 0 and +-pi among its entries; then both are timed at
    that shape. `dtypes`: both precisions by default, float64 alone for
    the float64 paths."""
    res = {}
    for shape in sorted(shapes, key=lambda s: int(np.prod(s))):
        n = int(np.prod(shape))
        for dtype in dtypes:
            rng = np.random.default_rng(6)
            worst = 0.0
            for trial in range(64 if n < 2**16 else 8):
                M = rng.uniform(-50.0, 50.0, shape)
                e_row = rng.uniform(0.0, 0.99, shape[:-1] + (1,) if shape else ())
                if trial < 2:
                    e_row = np.full_like(e_row, (0.0, 0.99)[trial])
                if trial == 2:
                    M.reshape(-1)[:3] = (0.0, np.pi, -np.pi)[: M.size]
                M = torch.as_tensor(M, dtype=dtype, device="cuda")
                e = torch.as_tensor(e_row, dtype=dtype, device="cuda").expand(shape)
                before = kk.launches
                E_k = kepler_mod.kepler_solver(M, e)
                if kk.launches != before + 1:
                    raise AssertionError("kepler_solver on a CUDA tensor did not launch the kernel")
                if not bool(torch.isfinite(E_k).all()):
                    raise AssertionError(f"kernel returned non-finite E at {shape} in {dtype}")
                worst = max(worst, float((E_k.double() - kepler_mod._markley(M, e).double()).abs().max()))
            log(f"kernel vs twin at the main path's {shape} {dtype}, e expanded, 64 draws: "
                f"max |dE| {worst:.3e} (tol {TOL[dtype]:.0e})")
            if not worst <= TOL[dtype]:
                raise AssertionError(f"kernel disagrees with its twin at {shape} in {dtype}: {worst:.3e}")
            e = e.contiguous()
            n_iter = 200 if n < 2**20 else 20
            ms_t_a = _time_ms(lambda: kepler_mod._markley(M, e), n_iter)
            ms_k_a = _time_ms(lambda: kk.kepler_solve_cuda(M, e), n_iter)
            ms_k_b = _time_ms(lambda: kk.kepler_solve_cuda(M, e), n_iter)
            ms_t_b = _time_ms(lambda: kepler_mod._markley(M, e), n_iter)
            ms_k, ms_t = min(ms_k_a, ms_k_b), min(ms_t_a, ms_t_b)
            log(f"timing {shape} {dtype}: kernel {ms_k:.4f} ms, twin {ms_t:.4f} ms "
                f"(runs: kernel {ms_k_a:.4f}/{ms_k_b:.4f}, twin {ms_t_a:.4f}/{ms_t_b:.4f})")
            res[(shape, dtype)] = dict(ms=ms_k, plain_ms=ms_t, err=worst, n=n)
    return res


def composed_ln_post_and_grad(model, theta):
    """`model.ln_post_and_grad` through the composed orbit solve."""
    theta = theta.detach().requires_grad_(True)
    lp = model.ln_post(theta, fused=False)
    (g,) = torch.autograd.grad(lp.sum(), theta)
    return lp.detach(), g


# Fused against composed gradients in float32, relative to each draw's
# largest entry: three times the one reading this seeded run has given on
# an NVIDIA H100 80GB HBM3 (8.641e-4). The gradient sums 24 residuals
# times position derivatives that cancel, each at an E that differs by
# about 1e-6 rad between the paths.
FUSED_GRAD_TOL = 3e-3


def _ln_post_difference_bound(ot, model, theta, table):
    """Per draw, the most that the fused and the composed ln_post may
    differ, from the two paths' own model positions at these draws. The
    priors see the same numbers on both paths; the likelihood is
    -1/2 sum (r / sigma)^2 with r = data - model, so a model position that
    moves by d moves it by (r d - d^2 / 2) / sigma^2 exactly, at most
    (|r| |d| + d^2 / 2) / sigma^2. Evaluated in float64. Returns the bound
    (one per draw) and the largest |d| in mas."""
    with torch.no_grad():
        (orbit,) = model.construct_orbits(model.arr2nt(model.invlink(theta)))
        fused = ot.orbitsolve(orbit, model._epochs_t)
        composed = ot.orbitsolve(orbit, model._epochs_t, fused=False)
    bound, d_max = 0.0, 0.0
    for data, sigma, f, c in (("ra", "σ_ra", fused.raoff_mas, composed.raoff_mas),
                              ("dec", "σ_dec", fused.decoff_mas, composed.decoff_mas)):
        d = (f.double() - c.double()).abs()
        r = (torch.as_tensor(table[data], device=d.device) - c.double()).abs()
        s2 = torch.as_tensor(table[sigma], device=d.device) ** 2
        bound = bound + ((r * d + 0.5 * d * d) / s2).sum(dim=-1)
        d_max = max(d_max, float(d.max()))
    return bound, d_max


def fused_vs_composed_phase(ot, model, chain, table, chains: int) -> None:
    """One batched gradient evaluation at `chains` posterior draws through
    the fused kernels and through the composed path, in turns inside this
    one process: device time (CUDA events) and host wall time."""
    names = model.parameter_names
    nat = np.stack([chain[n][:, -1] for n in names], axis=-1)[:chains]
    theta = model.link(model.tensor(nat))

    def composed():
        return composed_ln_post_and_grad(model, theta)

    def fused():
        return model.ln_post_and_grad(theta)

    (lp_c, g_c), (lp_f, g_f) = composed(), fused()
    # ln_post: each draw against its own bound, plus 64 float32 ulps of
    # |ln_post| for the roundings of the likelihood's and the sum's own
    # arithmetic (about 40 terms of magnitude up to |ln_post|)
    bound, d_pos = _ln_post_difference_bound(ot, model, theta, table)
    tol_lp = bound + 64 * torch.finfo(torch.float32).eps * lp_c.double().abs()
    d_lp = (lp_c.double() - lp_f.double()).abs()
    worst = int((d_lp / tol_lp).argmax())
    d_g = float(((g_c - g_f).abs().amax(dim=1) / g_c.abs().amax(dim=1).clamp(min=1.0)).max())
    log(f"fused vs composed at {len(theta)} posterior draws: max |d ln_post| {float(d_lp.max()):.3e}; "
        f"worst draw {float(d_lp[worst]):.3e} against its bound {float(tol_lp[worst]):.3e} "
        f"({float(d_lp[worst] / tol_lp[worst]):.3f} of it; the paths' positions differ by at most "
        f"{d_pos:.3e} mas); max relative gradient difference {d_g:.3e} (tol {FUSED_GRAD_TOL:.0e})")
    if not (bool((d_lp <= tol_lp).all()) and d_g <= FUSED_GRAD_TOL):
        raise AssertionError("fused and composed ln_post_and_grad disagree")

    runs = [(name, *(1e3 * ms for ms in _time_both(fn, 30))) for name, fn in
            (("composed", composed), ("fused", fused), ("fused", fused), ("composed", composed))]
    for name, dev_us, host_us in runs:
        log(f"  {name}: {dev_us:.1f} us per evaluation by CUDA events, {host_us:.1f} us by the host clock")
    best = {name: min(r[2] for r in runs if r[0] == name) for name in ("composed", "fused")}
    log(f"  fused / composed, best of two each, host clock: {best['fused']:.1f} / "
        f"{best['composed']:.1f} us = {best['fused'] / best['composed']:.3f}")


# The celerite kernel pair (`rv/csrc/celerite.cu`) against its plain version
# (`rv/celerite.py:_celerite_plain`, autograd for the backward), at the RV-GP
# path's (4096, 80) with one term (SHO) and two (SHO + Real), at 2^17 rows x
# 80 epochs and at a long series, 8 rows x 2048 epochs, on the same inputs
# in float32 and in float64. Errors: the log-likelihood per row against
# max(|ll|, 1); each gradient per row against the row's largest entry of
# that gradient (at least 1). Float64: 1e-10 for both. Float32: the two
# versions round differently (the kernel sums epochs in order, torch
# pairwise; S is kept symmetric in the kernel), and a row's float32 error
# grows with its covariance's condition number (an SHO amplitude of ~600
# against variances of 1-6): the worst row of the log-likelihood and of each
# gradient may differ from the plain version by CEL_F32_FACTOR times the
# plain version's own worst-row float32 error (against float64 on the same
# inputs), and at least CEL_F32_FLOOR.
CEL_SHAPES = ((CHAINS, RVGP_EPOCHS, 1), (CHAINS, RVGP_EPOCHS, 2),
              (BIG_CHAINS, RVGP_EPOCHS, 1), (8, 2048, 1))
CEL_F64_TOL = 1e-10
CEL_F32_FLOOR = (1e-5, 1e-4)  # ll, gradient
CEL_F32_FACTOR = 4.0
CEL_EDGE_ROWS = 3  # rows made non-positive-definite
# the span of the epochs (days): examples/03's 80 epochs cover 183 days; the
# long series one epoch per 2.3 days
CEL_SPAN = {RVGP_EPOCHS: 183.0, 2048: 4700.0}


def _cel_label(B, n, J) -> str:
    return f"({B}, {n}) J={J}"


def _cel_inputs(B, n, J, dtype, seed=0, edge=True):
    """Coefficients (B, J) of an SHOTerm over the RV-GP model's prior ranges
    (S0 in LogUniform(0.1, 100), w0 in LogUniform(0.01, 2)) with Q in
    U(0.8, 5), plus for J = 2 a RealTerm (a in LogUniform(0.1, 30), c in
    LogUniform(0.01, 1)); sorted relative epochs (n,); residuals and
    variances (B, n) on the card; with `edge`, the first CEL_EDGE_ROWS rows
    made non-positive-definite (first term a = 10, b = 50; variances 1e-4)."""
    rng = np.random.default_rng(seed)
    loguniform = lambda lo, hi: np.exp(rng.uniform(np.log(lo), np.log(hi), B))  # noqa: E731
    S0, w0, Q = loguniform(0.1, 100.0), loguniform(0.01, 2.0), rng.uniform(0.8, 5.0, B)
    eta = np.sqrt(4 * Q * Q - 1)
    a, c = S0 * w0 * Q, w0 / (2 * Q)
    terms = [(a, a / eta, c, c * eta)]
    if J == 2:
        zero = np.zeros(B)
        terms.append((loguniform(0.1, 30.0), zero, loguniform(0.01, 1.0), zero))
    a, b, c, d = (np.stack(x, axis=-1) for x in zip(*terms))
    edge_rows = CEL_EDGE_ROWS if edge else 0
    a[:edge_rows, 0], b[:edge_rows, 0] = 10.0, 50.0  # b d > a c: not PSD
    t = np.sort(rng.uniform(0.0, CEL_SPAN[n], n))
    t -= t[0]
    y = 3.0 * rng.standard_normal((B, n))
    var = rng.uniform(1.0, 6.0, (B, n))
    var[:edge_rows] = 1e-4
    gll = rng.uniform(0.5, 1.5, B)
    to = lambda x: torch.as_tensor(x, dtype=dtype, device="cuda")  # noqa: E731
    return [to(x) for x in (a, b, c, d)], to(t), to(y), to(var), to(gll)


def _dense_celerite_ll(a, b, c, d, t, y, var):
    """The same log-likelihood by library calls: the celerite terms' dense
    matrix, `cholesky_ex`, `solve_triangular` (the dense route of
    `gp_loglike`)."""
    from octofitter_tpu_torch.rv import celerite as cel

    term = cel.ComplexTerm(a[:, 0], b[:, 0], c[:, 0], d[:, 0])
    for j in range(1, a.shape[1]):
        term = term + cel.ComplexTerm(a[:, j], b[:, j], c[:, j], d[:, j])
    L = torch.linalg.cholesky_ex(term.matrix(t, t) + torch.diag_embed(var)).L
    alpha = torch.linalg.solve_triangular(L, y[..., None], upper=False)[..., 0]
    return (-0.5 * torch.sum(alpha**2, dim=-1)
            - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
            - 0.5 * t.shape[0] * math.log(2 * math.pi))


def _row_errors(x, ref, ok):
    """Per row, max |x - ref| over the row's entries against max(largest
    |ref| entry of the row, 1); 0 in the rows not `ok`."""
    x, ref = x.reshape(x.shape[0], -1).double(), ref.reshape(ref.shape[0], -1).double()
    err = (x - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1).clamp(min=1.0)
    return torch.where(ok, err, 0.0)


def _cel_check(label, dtype, out_k, out_p, ref=None):
    """(ll error, gradient error, largest error over tolerance) of the
    kernel's (ll, grads) against the plain version's, each the worst row's;
    `ref` is the plain version's float64 result on the same inputs, which
    sets the float32 tolerance of each output from the plain version's own
    worst-row error. The -inf rows must agree and carry zero,
    finite gradients."""
    (ll_k, g_k), (ll_p, g_p) = out_k, out_p
    ok = torch.isfinite(ll_p)
    if not torch.equal(ok, torch.isfinite(ll_k)):
        raise AssertionError(f"celerite kernel at {label} {dtype}: its -inf rows differ from the "
                             "plain version's")
    if int((~ok).sum()) < CEL_EDGE_ROWS:
        raise AssertionError(f"celerite kernel at {label} {dtype}: the edge rows are not at -inf")
    for gk in g_k:
        if not (bool(torch.isfinite(gk).all()) and bool((gk[~ok] == 0).all())):
            raise AssertionError(f"celerite kernel at {label} {dtype}: a non-finite gradient, or a "
                                 "non-zero one in a -inf row")
    ll_p1, ll_k1 = ll_p[:, None], ll_k[:, None]
    errs = [_row_errors(ll_k1, ll_p1, ok)] + [_row_errors(gk, gp, ok) for gk, gp in zip(g_k, g_p)]
    if ref is None:
        tols = [torch.full_like(e, CEL_F64_TOL) for e in errs]
    else:
        ll_r, g_r = ref
        own = [_row_errors(ll_p1, ll_r[:, None], ok)] + [
            _row_errors(gp, gr, ok) for gp, gr in zip(g_p, g_r)]
        tols = [torch.clamp(CEL_F32_FACTOR * o, min=CEL_F32_FLOOR[k > 0])
                for k, o in enumerate(own)]
    ratio = max(float(e.max()) / float(t.max()) for e, t in zip(errs, tols))
    return float(errs[0].max()), max(float(e.max()) for e in errs[1:]), ratio


def celerite_kernel_phase(cc, cel) -> dict:
    """The pair against its plain version at CEL_SHAPES on the same inputs
    in both precisions, then timed in float32 (plain, kernel, kernel, plain)
    beside the dense route by library calls: {"shapes": a row per shape,
    "occupancy": each kernel's launch at each shape}."""
    res = {}
    for B, n, J in CEL_SHAPES:
        label = _cel_label(B, n, J)
        row = {"B": B, "n": n, "J": J}
        coefs32, t32, y32, var32, gll32 = _cel_inputs(B, n, J, torch.float32)
        out = {}
        for dtype in (torch.float64, torch.float32):
            coefs, t, y, var, gll = (x.to(dtype) for x in
                                     (torch.stack(coefs32), t32, y32, var32, gll32))
            coefs = list(coefs.unbind(0))
            ll_k, ckpt = cc.celerite_forward_cuda(*coefs, t, y, var, save=True)
            g_k = cc.celerite_backward_cuda(*coefs, t, y, var, ckpt, ll_k, gll)
            xs = [x.clone().requires_grad_(True) for x in (*coefs, y, var)]
            ll_p = cel._celerite_plain(*xs[:4], t, *xs[4:])
            g_p = torch.autograd.grad(torch.where(torch.isfinite(ll_p), ll_p, 0.0) @ gll, xs)
            torch.cuda.synchronize()
            out[dtype] = ((ll_k, g_k), (ll_p.detach(), g_p))
            del ckpt, xs, ll_p
        for dtype in (torch.float64, torch.float32):
            ref = out[torch.float64][1] if dtype == torch.float32 else None
            ll_err, g_err, ratio = _cel_check(label, dtype, *out[dtype], ref=ref)
            tol = (f"tol {CEL_F64_TOL:.0e}" if ref is None else
                   f"tol max({CEL_F32_FACTOR:g} x the plain version's own worst-row error "
                   f"against float64, {CEL_F32_FLOOR})")
            log(f"celerite kernel vs plain {label} {dtype}: ll {ll_err:.3e}, gradient {g_err:.3e}, "
                f"{ratio:.3f} of the {tol}; "
                f"{int((~torch.isfinite(out[dtype][0][0])).sum())} rows at -inf")
            if not ratio <= 1.0:
                raise AssertionError(f"celerite kernel disagrees with its plain version at {label} "
                                     f"in {dtype}")
            key = "" if dtype == torch.float32 else "_f64"
            row[f"ll_err{key}"], row[f"grad_err{key}"], row[f"err_over_tol{key}"] = (
                ll_err, g_err, ratio)
        del out
        # timing, float32: the forward as the gradient path launches it (with
        # its checkpoints), by CUDA events and by the profiler's kernel events
        coefs, t, y, var, gll = coefs32, t32, y32, var32, gll32
        ll, ckpt = cc.celerite_forward_cuda(*coefs, t, y, var, save=True)
        xs = [x.clone().requires_grad_(True) for x in (*coefs, y, var)]
        ll_p = cel._celerite_plain(*xs[:4], t, *xs[4:])
        ll_d = _dense_celerite_ll(*xs[:4], t, *xs[4:])
        n_plain = 1 if n > 256 else 3  # the plain loop at 2048 epochs takes ~0.6 s + 2 s
        fns = {
            "fwd": lambda: cc.celerite_forward_cuda(*coefs, t, y, var, save=True),
            "plain_fwd": lambda: cel._celerite_plain(*coefs, t, y, var),
            "library_fwd": lambda: _dense_celerite_ll(*coefs, t, y, var),
            "bwd": lambda: cc.celerite_backward_cuda(*coefs, t, y, var, ckpt, ll, gll),
            "plain_bwd": lambda: torch.autograd.grad(ll_p, xs, gll, retain_graph=True),
            "library_bwd": lambda: torch.autograd.grad(ll_d, xs, gll, retain_graph=True),
        }
        times = {k: [] for k in fns}
        n_iter = lambda name: 50 if name in ("fwd", "bwd") else n_plain  # noqa: E731
        with torch.no_grad():
            for name in ("plain_fwd", "fwd", "fwd", "plain_fwd", "library_fwd"):
                times[name].append(_time_ms(fns[name], n_iter(name)))
        for name in ("plain_bwd", "bwd", "bwd", "plain_bwd", "library_bwd"):
            times[name].append(_time_ms(fns[name], n_iter(name)))
        for k, v in times.items():
            row[k] = min(v)
        row["device_us"] = _kernel_device_us(lambda: (fns["fwd"](), fns["bwd"]()))
        log(f"timing celerite {label} float32: forward {row['fwd']:.4f} ms by CUDA events, "
            f"{row['device_us'].get('fwd', math.nan):.2f} us by the profiler (plain "
            f"{row['plain_fwd']:.4f}, dense library route {row['library_fwd']:.4f}); backward "
            f"{row['bwd']:.4f} ms, {row['device_us'].get('bwd', math.nan):.2f} us (plain "
            f"{row['plain_bwd']:.4f}, dense {row['library_bwd']:.4f}); runs {times}")
        log(f"celerite {label} float32 checkpoints: {4 * ckpt.numel()} bytes, "
            f"checkpoint_ms {celerite_checkpoint_ms(B, n, J):.5f} at the memory rate "
            "(computed from the bytes, not measured)")
        res[label] = row
        del ll_p, ll_d, xs, ckpt
        torch.cuda.empty_cache()
    occupancy = {f"{_cel_label(B, n, J)} {part}": cc.occupancy(B, J, torch.float32, part == "bwd")
                 for B, n, J in CEL_SHAPES for part in ("fwd", "bwd")}
    log(f"celerite kernels per block and SM, float32: {occupancy}")
    return {"shapes": res, "occupancy": occupancy}


def _device_events(fn, n):
    """(name, launches, total device us) of every device operation that `n`
    calls of `fn` make under torch.profiler, after one call outside it. It
    traces the device only: gathering the host's op events as well took
    45 s for one Laplace step (`torch.func` nests many host ops in each
    device op) on the H100 machine's host."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    # `device_time_total` in newer PyTorch, `cuda_time_total` before it
    return [(e.key, e.count, e.device_time_total if hasattr(e, "device_time_total")
             else e.cuda_time_total) for e in rows]


def _kernel_device_us(fn, n_iter=20) -> dict:
    """Each celerite kernel's own device time per launch, in us, over
    `n_iter` calls of `fn`, keyed "fwd" and "bwd"; empty where the
    profiler shows none."""
    return {("fwd" if "fwd" in key else "bwd"): total / count
            for key, count, total in _device_events(fn, n_iter) if "celerite" in key}


def celerite_bound(B, n, J, part) -> tuple[float, str]:
    """The least time for the function in float32: its inputs read and its
    outputs written once (forward: a, b, c, d, t, y, var read, ll written;
    backward: the same inputs and the cotangent read, the six gradients
    written), and its arithmetic (per row and epoch about 12 J + 7 (2J)^2
    operations forward, 12 J + 20 (2J)^2 backward, each exp and sincos
    one) at the float32 peak. The checkpoints the forward writes for the
    backward are this design's choice, not the function's:
    `celerite_checkpoint_ms`."""
    inputs = 4 * B * J + n + 2 * B * n
    if part == "fwd":
        words = inputs + B
        ops = (12 * J + 7 * (2 * J) ** 2) * B * n
    else:
        words = inputs + B + 4 * B * J + 2 * B * n
        ops = (12 * J + 20 * (2 * J) ** 2) * B * n
    return bound_ms(4 * words, ops, torch.float32)


def celerite_checkpoint_ms(B, n, J) -> float:
    """The time the forward's checkpoints take at the memory rate in
    float32, once written (forward) or once read (backward)."""
    from octofitter_tpu_torch.rv.celerite_cuda import checkpoint_shape, chunk_epochs

    return bound_ms(4 * math.prod(checkpoint_shape(B, n, J, chunk_epochs(J, torch.float32, B))), 0,
                    torch.float32)[0]


def _device_ops_per_call(fn, n=3):
    """(operations, busy us): device operations (kernels, copies, fills) per
    call of `fn` over `n` calls, and the sum of their device times per call;
    (None, None) where the profiler shows none."""
    rows = _device_events(fn, n)
    count = sum(r[1] for r in rows)
    return (count / n, sum(r[2] for r in rows) / n) if count else (None, None)


# the model's evaluation near the truth (S0 ~ 5 against variances ~2.5, well
# conditioned) through the kernel pair and through the plain recursion, both
# float32: ln_post and each chain's gradient against their largest entry
RVGP_EVAL_TOL = (1e-5, 1e-3)


def rvgp_evaluation_phase(ot, model, ref, cc) -> dict:
    """One batched value-and-gradient of the RV-GP model at CHAINS points
    near the truth through the celerite kernel pair and through the plain
    recursion (`ln_post(..., fused=False)`; the RadialVelocityOrbit solve
    is the same on both), in turns: each path's host and device ms and
    device operations per evaluation, and the two paths' agreement."""
    theta = model.tensor(rvgp_points_near_truth(ot, ref, CHAINS, seed=6))
    kernel = lambda: model.ln_post_and_grad(theta)  # noqa: E731
    plain = lambda: model._value_and_grad(lambda th: model.ln_post(th, fused=False), theta)  # noqa: E731
    before = cc.launches_bwd
    lp_k, g_k = kernel()
    if cc.launches_bwd != before + 1:
        raise AssertionError("rv-gp: ln_post_and_grad did not launch the celerite backward kernel")
    lp_p, g_p = plain()
    err_lp = float(((lp_k - lp_p).abs() / lp_p.abs().clamp(min=1.0)).max())
    err_g = float(((g_k - g_p).abs().amax(-1) / g_p.abs().amax(-1).clamp(min=1.0)).max())
    log(f"rv-gp evaluation at {CHAINS} chains: kernel vs plain path ln_post {err_lp:.3e}, "
        f"gradient {err_g:.3e} (tol {RVGP_EVAL_TOL})")
    if not (err_lp <= RVGP_EVAL_TOL[0] and err_g <= RVGP_EVAL_TOL[1]):
        raise AssertionError("rv-gp: the kernel path and the plain path disagree")
    res = {}
    for name, fn, n_iter in (("plain", plain, 5), ("kernel", kernel, 20), ("kernel", kernel, 20),
                             ("plain", plain, 5)):
        dev, host = _time_both(fn, n_iter)
        prev = res.get(name, (math.inf, math.inf))
        res[name] = (min(prev[0], dev), min(prev[1], host))
    prof = {name: _device_ops_per_call(fn) for name, fn in (("kernel", kernel), ("plain", plain))}
    ops = {name: v[0] for name, v in prof.items()}
    busy = {name: v[1] for name, v in prof.items()}
    for name in ("plain", "kernel"):
        log(f"  {name} path: {res[name][1] * 1e3:.1f} us per evaluation on the host clock, "
            f"{res[name][0] * 1e3:.1f} us by CUDA events, "
            f"{ops[name] if ops[name] is not None else 'not measured'} device ops and "
            f"{f'{busy[name]:.1f}' if busy[name] is not None else 'not measured'} us of device "
            "time per evaluation")
    return {"us": {k: v[1] * 1e3 for k, v in res.items()},
            "device_us": {k: v[0] * 1e3 for k, v in res.items()}, "ops": ops, "busy_us": busy}


RVGP_QP_TOL = (2e-3, 2e-2)  # float32 Cholesky of 80 x 80: ll, gradient rows


def rvgp_extra_checks(ot, cc, cel) -> dict:
    """The associative method at the long series against the kernel
    (SHO terms, Q >= 0.8 > 1/sqrt(2), so a >= |b| and the state-space form
    holds; float64 gate, float32 printed), timed; and a QuasiPeriodicKernel's
    dense `gp_loglike` value and gradient at (CHAINS, 80) in float32 on the
    card against float64 on the CPU."""
    from octofitter_tpu_torch.rv import kernels as ker

    out = {}
    B, n = 8, 2048
    for dtype in (torch.float64, torch.float32):
        coefs, t, y, var, _ = _cel_inputs(B, n, 1, dtype, seed=3, edge=False)
        xs = [x.clone().requires_grad_(True) for x in (*coefs, y, var)]
        term = cel.ComplexTerm(*(x[:, 0] for x in xs[:4]))
        ll_a = cel.celerite_loglike_assoc(term, t, xs[4], xs[5])
        g_a = torch.autograd.grad(ll_a.sum(), xs)
        ll_k = cel.celerite_loglike(term, t, xs[4], xs[5])
        g_k = torch.autograd.grad(ll_k.sum(), xs)
        if not (bool(torch.isfinite(ll_a).all()) and bool(torch.isfinite(ll_k).all())):
            raise AssertionError(f"associative check: non-finite log-likelihoods in {dtype}")
        ll_a, ll_k = ll_a.detach(), ll_k.detach()
        ll_err = float(((ll_a - ll_k).abs() / ll_k.abs().clamp(min=1.0)).max())
        g_err = max(float(((ga - gk).abs().amax() / gk.abs().amax().clamp(min=1.0)))
                    for ga, gk in zip(g_a, g_k))
        log(f"associative vs kernel at ({B}, {n}) {dtype}: ll {ll_err:.3e}, gradient {g_err:.3e}"
            + (" (gate 1e-8)" if dtype == torch.float64 else " (printed, no gate)"))
        if dtype == torch.float64 and not (ll_err <= 1e-8 and g_err <= 1e-8):
            raise AssertionError("associative celerite disagrees with the kernel in float64")
        if dtype == torch.float32:
            ms_a = _time_ms(lambda: torch.autograd.grad(
                cel.celerite_loglike_assoc(term, t, xs[4], xs[5]).sum(), xs), 5)
            ms_k = _time_ms(lambda: torch.autograd.grad(
                cel.celerite_loglike(term, t, xs[4], xs[5]).sum(), xs), 20)
            log(f"  value and gradient at ({B}, {n}) float32: associative {ms_a:.3f} ms, "
                f"kernel pair {ms_k:.3f} ms")
            out["assoc"] = dict(ll_err=ll_err, grad_err=g_err, ms=ms_a, kernel_ms=ms_k)
    rng = np.random.default_rng(8)
    t = np.sort(rng.uniform(0.0, 183.0, RVGP_EPOCHS))
    hyper = np.stack([rng.uniform(1.0, 4.0, CHAINS), rng.uniform(15.0, 40.0, CHAINS),
                      rng.uniform(5.0, 25.0, CHAINS), rng.uniform(0.3, 0.8, CHAINS)], -1)
    y = 3.0 * rng.standard_normal((CHAINS, RVGP_EPOCHS))
    var = rng.uniform(1.0, 6.0, (CHAINS, RVGP_EPOCHS))
    res = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        h = torch.as_tensor(hyper, dtype=dtype, device=device).requires_grad_(True)
        yy = torch.as_tensor(y, dtype=dtype, device=device).requires_grad_(True)
        k = ker.QuasiPeriodicKernel(*h.unbind(-1))
        tt = torch.as_tensor(t, dtype=dtype, device=device)
        ll = ker.gp_loglike(k, tt, yy, torch.as_tensor(var, dtype=dtype, device=device))
        g = torch.autograd.grad(ll.sum(), (h, yy))
        res[device] = [x.detach().double().cpu() for x in (ll, *g)]
    ll32, *g32 = res["cuda"]
    ll64, *g64 = res["cpu"]
    ll_err = float(((ll32 - ll64).abs() / ll64.abs().clamp(min=1.0)).max())
    g_err = max(float(((a - b).abs().amax(-1) / b.abs().amax(-1).clamp(min=1.0)).max())
                for a, b in zip(g32, g64))
    log(f"QuasiPeriodicKernel dense gp_loglike at ({CHAINS}, {RVGP_EPOCHS}): float32 card vs "
        f"float64 CPU ll {ll_err:.3e}, gradient {g_err:.3e} (tol {RVGP_QP_TOL})")
    if not (ll_err <= RVGP_QP_TOL[0] and g_err <= RVGP_QP_TOL[1]):
        raise AssertionError("dense QuasiPeriodicKernel gp_loglike disagrees with float64")
    out["qp"] = dict(ll_err=ll_err, grad_err=g_err)
    return out


def rvgp_laplace_phase(kk, model, theta) -> dict:
    """The Laplace step of `initialize` (`torch.func.hessian` of the
    composed `ln_post`, which runs the plain celerite recursion: no
    transform runs a ctypes kernel) at `theta`, timed twice on the host
    clock after a first call, with its device operations and its launches
    of the Kepler kernel and the celerite pair."""
    from octofitter_tpu_torch.model.initialization import laplace
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    x = theta.double().cpu().numpy()
    laplace(model, x)
    torch.cuda.synchronize()
    seconds = []
    for _ in range(2):
        kepler0, fwd0, bwd0 = kk.launches, cc.launches_fwd, cc.launches_bwd
        t0 = time.perf_counter()
        laplace(model, x)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = {"kepler_solve": kk.launches - kepler0, "celerite_fwd": cc.launches_fwd - fwd0,
                "celerite_bwd": cc.launches_bwd - bwd0}
    t_ops = time.perf_counter()
    ops, _ = _device_ops_per_call(lambda: laplace(model, x), n=1)
    log(f"  the Laplace step's device-op count took {time.perf_counter() - t_ops:.2f} s")
    log(f"rv-gp Laplace step (D = {model.D}): {min(seconds):.4f} s (runs {seconds}), "
        f"{ops if ops is not None else 'not measured'} device ops, launches {launches}")
    return {"seconds": min(seconds), "device_ops": ops, "launches": launches}


def rvgp_phase(ot, kk, osk, adaptation=RVGP_ADAPTATION, iterations=RVGP_ITERATIONS,
               checks=True, fit=True, kepler_rows=True) -> dict:
    """The RV-GP path (`examples/03_rv_gp.py`). With `checks`: the float32
    GPU model checked against a float64 CPU model, one evaluation through
    the kernel pair and through the plain recursion, the Laplace step, the
    kernel pair at its shapes, the associative and dense checks. Then, with
    `fit`, `octofit` with initialization at CHAINS chains through `fit_phase`
    (the standalone Kepler kernel on every evaluation) with the celerite
    pair launched on every gradient evaluation, the medians of b_mass and
    b_a within 5 sd of the truth, and, with `kepler_rows`, the Kepler kernel
    held to its twin at every shape the fit launched it with (`kepler_rows`)."""
    from octofitter_tpu_torch.orbits import kepler as kepler_mod
    from octofitter_tpu_torch.rv import celerite as cel
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    t0 = time.perf_counter()
    data = rvgp_data(ot)
    model = build_rvgp_model(ot, data, device="cuda", dtype=torch.float32)
    checked = {}
    if checks:
        ref = build_rvgp_model(ot, data, device="cpu", dtype=torch.float64)
        steps = {
            "reference": lambda: reference_phase(
                "rv-gp", model, ref, rvgp_points_near_truth(ot, ref, 64, seed=5)),
            "evaluation": lambda: rvgp_evaluation_phase(ot, model, ref, cc),
            "laplace": lambda: rvgp_laplace_phase(
                kk, model, rvgp_points_near_truth(ot, ref, 1, seed=7)[0]),
            "celerite": lambda: celerite_kernel_phase(cc, cel),
            "extra": lambda: rvgp_extra_checks(ot, cc, cel),
        }
        for key, step in steps.items():
            t_step = time.perf_counter()
            checked[key] = step()
            log(f"rv-gp {key} step: {time.perf_counter() - t_step:.2f} s")
    res = {}
    if fit:
        res = fit_phase(ot, kk, osk, model,
                        f"rv-gp fit (celerite SHO, {adaptation} + {iterations})",
                        CHAINS, adaptation, iterations)
        launches, n_evals = res["launches"], res["n_evals"]
        res["celerite_shapes"] = dict(cc.launch_shapes)
        log(f"  celerite forward by (rows, epochs, terms): {res['celerite_shapes']}")
        if min(launches["celerite_fwd"], launches["celerite_bwd"]) < n_evals:
            raise AssertionError(f"rv-gp: the celerite kernels were launched fewer times than "
                                 f"the {n_evals} gradient evaluations")
        _gate_median("rv-gp", res["chain"], "b_mass", RVGP_MASS)
        _gate_median("rv-gp", res["chain"], "b_a", RVGP_TRUE["a"])
        if kepler_rows:
            t_step = time.perf_counter()
            res["kepler_rows"] = kepler_path_phase(kk, kepler_mod, res["kepler_shapes"])
            log(f"rv-gp Kepler step: {time.perf_counter() - t_step:.2f} s")
    res.update(checked)
    res["seconds"] = time.perf_counter() - t0
    log(f"rv-gp phase: {res['seconds']:.2f} s")
    return res


# ---------------------------------------------------------------------------
# Absolute astrometry: the other orbit bases, Hipparcos IAD, the HGCA
# linear-fit model and Gaia DR4 epoch astrometry (`octofitter_tpu_torch/
# astrom/`, `orbits/absolute_visual.py`, `orbits/extra_bases.py`). Each
# model-making function takes either package (`pkg`), so that the CPU
# tests make the JAX package's side from the same data.

# The synthetic Hipparcos star of the JAX package's tests
# (tests/test_astrom.py:145-180): a Java-Tool IAD file at HIP_ORBITS
# orbits x 2 abscissae (120, a real Hipparcos star's count), and a GOST
# scan law of GOST_TRANSITS Gaia transits (its `synth_gost_csv` format)
HIP_SOL = dict(radeg=68.0, dedeg=-51.0, plx=50.0, pm_ra=-5.0, pm_de=10.0)
GAIA_SOL = dict(ra=68.0, dec=-51.0, parallax=50.0, pmra=-5.0, pmdec=10.0,
                parallax_error=0.05, ra_error=0.03, dec_error=0.03,
                pmra_error=0.05, pmdec_error=0.05)
HIP_ORBITS, GOST_TRANSITS = 60, 60
# `docs/hipparcos.md:140-200`: c Eri's relative astrometry (14 epochs) with
# the IAD, an AbsoluteVisual{KepOrbit} mass fit (D = 16)
HIP_ASTROM = dict(
    epoch=np.array([57009.1, 57052.1, 57053.1, 57054.3, 57266.4, 57332.2, 57374.2, 57376.2,
                    57415.0, 57649.4, 57652.4, 57739.1, 58068.3, 58442.2]),
    sep=np.array([454.24, 451.81, 456.8, 461.5, 455.1, 452.88, 455.91, 455.01, 454.46, 454.81,
                  451.43, 449.39, 447.54, 434.22]),
    σ_sep=np.array([1.88, 2.06, 2.57, 23.9, 2.23, 5.41, 6.23, 3.03, 6.03, 2.02, 2.67, 2.15,
                    3.02, 2.01]),
    pa=np.array([2.98835, 2.96723, 2.97038, 2.97404, 2.91994, 2.89934, 2.89131, 2.89184,
                 2.8962, 2.82394, 2.82272, 2.79357, 2.70927, 2.61171]),
    σ_pa=np.array([0.00401426, 0.00453786, 0.00523599, 0.0523599, 0.00453786, 0.00994838,
                   0.00994838, 0.00750492, 0.00890118, 0.00453786, 0.00541052, 0.00471239,
                   0.00680678, 0.00401426]),
)
# the tutorial's straight-line catalog fit first, then the mass fit. The
# mass fit at 300 + 150 had not ended when a 900 s call on an NVIDIA H100
# was killed, over 800 s after its initialization began (PERF.md): it runs
# 30 + 30, its R-hat reported, not gated, beside the JAX package's at the
# same initialization and 300 + 150 (`scripts/hip_mass_mixing.py`)
HIP_LINE_ADAPTATION, HIP_LINE_ITERATIONS = 150, 75
HIP_ADAPTATION, HIP_ITERATIONS = 20, 20
# the HGCA linear-fit fit (tests/test_astrom.py:300-337, include_iad=True):
# the headline's orbit and 12 relative-astrometry epochs with a 30 Mjup
# companion; its catalog row made by `generate_from_params` at the truth
HGCA_MASS, HGCA_PM = 30.0, (-5.0, 10.0)
HGCA_ADAPTATION, HGCA_ITERATIONS = 150, 75
# Gaia DR4 epoch astrometry (tests/test_astrom.py:390-437) at Gaia BH3's
# 620 epochs (examples/08), its centroids made at the truth
DR4_EPOCHS = 620
DR4_TRUTH = {"GaiaDR4_astrometric_jitter": 1e-3, "b_mass": 10.0}
# Float64 evaluations on the card against the same model on the CPU: ln_post
# within ABS_VALUE_TOL of max(|ln_post|, 1), each chain's gradient within
# ABS_GRAD_TOL of its largest entry (at least 1), plus ULP_FACTOR times what
# one ulp of the propagated degrees moves them by (`ulp_sensitivity`: the
# most of ULP_SEEDS draws, every value an ulp up, down, or either at random). A
# model on AbsoluteVisual{KepOrbit} subtracts positions in degrees, as the
# reference does: one ulp of 68 deg is 1.4e-14 deg, 5e-8 mas, against
# abscissa errors of 0.05-1.5 mas, and two implementations of arcsin and
# atan2 (the JAX package's and libm's, the CPU's and CUDA's) differ by an
# ulp or two in a share of their results.
ABS_VALUE_TOL, ABS_GRAD_TOL, ULP_FACTOR, ULP_SEEDS = 1e-9, 1e-7, 16.0, 4
ABSOLUTE = "AbsoluteVisual{KepOrbit}"
OTHER_BASES = (ABSOLUTE, "CartesianOrbit", "Visual{FixedPosition}", "Hyperbolic{KepOrbit}")


def write_synth_iad(path, n_orbits=30, res_sigma=1.5, seed=0):
    """tests/test_astrom.py:write_synth_iad's Java-Tool IAD file: HIP_SOL's
    catalog solution and 2 abscissae per orbit, residuals N(0, res_sigma),
    all from numpy's seed `seed`."""
    rng = np.random.default_rng(seed)
    lines = ["# synthetic IAD", "#", "#", "#", "#", "#",
             f"HIP    99999  99999  {2 * n_orbits}  1  5      0    0.00  0", "#",
             f"Hp      5.000  0.100  0      {2 * n_orbits} 0", "#",
             (f"radeg   {HIP_SOL['radeg']}  {HIP_SOL['dedeg']}  {HIP_SOL['plx']}"
              f"  {HIP_SOL['pm_ra']}  {HIP_SOL['pm_de']}" + "  0.50" * 18), "#"]
    for iorb in range(1, n_orbits + 1):
        ep = -1.5 + 3.0 * (iorb - 1) / (n_orbits - 1)
        for k in range(2):
            ang = rng.uniform(0, 2 * np.pi)
            parf = rng.uniform(-0.7, 0.7)
            res = rng.standard_normal() * res_sigma
            lines.append(f"{iorb} {ep + 0.003 * k:.4f} {parf:.3f} {math.cos(ang):.4f} "
                         f"{math.sin(ang):.4f} {res:.3f} {res_sigma:.2f}")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def synth_gost_csv(directory, n=40, seed=1):
    """tests/test_astrom.py:synth_gost_csv's GOST forecast of `n` Gaia
    transits over JD 2456900-2457900, as `directory`/gost.csv."""
    rng = np.random.default_rng(seed)
    jd = np.sort(rng.uniform(2456900.0, 2457900.0, n))
    angle = rng.uniform(-np.pi, np.pi, n)
    parf = rng.uniform(-0.7, 0.7, n)
    path = str(Path(directory) / "gost.csv")
    with open(path, "w") as f:
        f.write("Target, ra[rad], dec[rad], ObservationTimeAtGaia[UTC], scanAngle[rad],"
                " parallaxFactorAlongScan, parallaxFactorAcrossScan,"
                " ObservationTimeAtBarycentre[BarycentricJulianDateInTCB]\n")
        for i in range(n):
            f.write(f"t,1.0,0.5,2015-01-01T00:00:00,{angle[i]},{parf[i]},0.0,{jd[i]}\n")
    return path


def _headline_planet_variables(pkg, ref_epoch=57000.0):
    """The headline planet's variables: a, e, i ~ Sine, UniformCircular
    omega / Omega / theta, tp from theta at `ref_epoch`."""
    d = pkg.distributions
    return dict(
        a=d.Uniform(0.001, 100.0),
        e=d.Uniform(0.0, 0.99),
        i=d.Sine(),
        omega=pkg.UniformCircular(),
        Omega=pkg.UniformCircular(),
        theta=pkg.UniformCircular(),
        tp=lambda sys, pl: pkg.theta_at_epoch_to_tperi(
            pl.theta, ref_epoch, M=sys.M, e=pl.e, a=pl.a, i=pl.i, omega=pl.omega,
            Omega=pl.Omega),
    )


def _headline_system_variables(pkg):
    d = pkg.distributions
    return dict(M=d.truncated(d.Normal(1.2, 0.1), lower=0.1),
                plx=d.truncated(d.Normal(50.0, 0.02), lower=0.1))


def build_basis_model(pkg, basis, table, **model_kw):
    """The headline's relative astrometry on one of the other orbit bases:
    AbsoluteVisual{KepOrbit} (the headline planet, the barycentre at
    HIP_SOL's position with per-chain proper motions and radial velocity),
    CartesianOrbit (the headline orbit's state vector at MJD 57000, each
    coordinate within 5% of its vector's length), Visual{FixedPosition}
    (one sky offset) or Hyperbolic{KepOrbit}."""
    d = pkg.distributions
    sys_vars = _headline_system_variables(pkg)
    if basis == ABSOLUTE:
        pl_vars = _headline_planet_variables(pkg)
        sys_vars.update(ra=HIP_SOL["radeg"], dec=HIP_SOL["dedeg"], rv=d.Normal(0.0, 2e4),
                        pmra=d.Normal(-5.0, 50.0), pmdec=d.Normal(10.0, 50.0),
                        ref_epoch=57000.0)
    elif basis == "CartesianOrbit":
        # the headline orbit's state at tref within 5%: well away from the
        # circular, face-on and unbound orbits where the conversion to
        # Campbell elements loses its digits (arccos at +-1)
        _, state = _headline_state(57000.0)
        pl_vars = {k: d.Normal(v, 0.05 * math.hypot(*(state[c] for c in (
                   ("x", "y", "z") if k in "xyz" else ("vx", "vy", "vz"))))) for k, v in state.items()}
        pl_vars["tref"] = 57000.0
    elif basis == "Visual{FixedPosition}":
        pl_vars = dict(x=d.Normal(0.0, 5.0), y=d.Normal(0.0, 5.0))
    elif basis == "Hyperbolic{KepOrbit}":
        pl_vars = dict(a=d.Uniform(-20.0, -1.0), e=d.Uniform(1.1, 3.0), i=d.Sine(),
                       omega=pkg.UniformCircular(), Omega=pkg.UniformCircular(),
                       tp=d.Normal(57000.0, 500.0))
    else:
        raise ValueError(f"no relative-astrometry model for basis {basis!r}")
    b = pkg.Planet(name="b", basis=basis, variables=pl_vars,
                   observations=[pkg.PlanetRelAstromObs(table, name="simdata")])
    system = pkg.System(name=f"bases_{basis}", variables=sys_vars, companions=[b])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def hip_data(directory) -> dict:
    """The Hipparcos path's data: the IAD file (HIP_ORBITS x 2 abscissae)
    written into `directory`, and the tutorial's relative astrometry."""
    return {"iad_file": write_synth_iad(str(Path(directory) / "hip_iad.d"), n_orbits=HIP_ORBITS),
            "astrom": HIP_ASTROM}


def build_hip_mass_model(pkg, data, xp, **model_kw):
    """`docs/hipparcos.md:140-200`'s companion-mass fit with either package
    (`xp`: its array module, torch or jax.numpy, for the derived ra):
    AbsoluteVisual{KepOrbit}, the IAD on the system and the relative
    astrometry on the planet; D = 16."""
    d = pkg.distributions
    hip = pkg.HipparcosIADObs(iad_file=data["iad_file"])
    ra0, dec0 = hip.hip_sol["radeg"], hip.hip_sol["dedeg"]
    mas2deg = 1.0 / 60 / 60 / 1000
    mjup2msol = pkg.constants.MJUP2MSOL
    b = pkg.Planet(
        name="b", basis=ABSOLUTE,
        observations=[pkg.PlanetRelAstromObs(data["astrom"], name="VLT/SPHERE")],
        variables=dict(
            a=d.truncated(d.Normal(10.0, 1.0), lower=0.1),
            e=d.Uniform(0.0, 0.99),
            omega=pkg.UniformCircular(),
            i=d.Sine(),
            Omega=pkg.UniformCircular(),
            theta=pkg.UniformCircular(),
            M=lambda sys, pl: sys.M,
            tp=lambda sys, pl: pkg.theta_at_epoch_to_tperi(
                pl.theta, 58442.2, M=pl.M, e=pl.e, a=pl.a, i=pl.i, omega=pl.omega,
                Omega=pl.Omega),
            mass=lambda sys, pl: sys.M_sec,
        ),
    )
    system = pkg.System(
        name="cEri", companions=[b], observations=[hip],
        variables=dict(
            M_pri=d.truncated(d.Normal(1.75, 0.05), lower=0.03),
            M_sec=d.LogUniform(0.1, 100.0),        # Mjup
            M=lambda s: s.M_pri + s.M_sec * mjup2msol,
            rv=12.60e3,                             # m/s
            plx=d.Uniform(20.0, 70.0),
            pmra=d.Uniform(-100.0, 100.0),
            pmdec=d.Uniform(-100.0, 100.0),
            ra_hip_offset_mas=d.Normal(0.0, 1000.0),
            dec_hip_offset_mas=d.Normal(0.0, 1000.0),
            dec=lambda s: dec0 + s.dec_hip_offset_mas * mas2deg,
            ra=lambda s: ra0 + s.ra_hip_offset_mas * mas2deg / xp.cos(xp.deg2rad(s.dec)),
            ref_epoch=pkg.constants.HIPPARCOS_EPOCH_MJD,
        ),
    )
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def build_hip_line_model(pkg, data, xp, **model_kw):
    """`docs/hipparcos.md:58-90`'s straight-line model with either package
    (`xp` as in `build_hip_mass_model`): the IAD alone, a zero-mass
    companion on AbsoluteVisual{KepOrbit}, the five astrometric parameters
    free (D = 5)."""
    d = pkg.distributions
    hip = pkg.HipparcosIADObs(iad_file=data["iad_file"])
    ra0, dec0 = hip.hip_sol["radeg"], hip.hip_sol["dedeg"]
    mas2deg = 1.0 / 60 / 60 / 1000
    b = pkg.Planet(name="b", basis=ABSOLUTE,
                   variables=dict(mass=0.0, e=0.0, omega=0.0, a=1.0, i=0.0, Omega=0.0, tp=0.0))
    system = pkg.System(
        name="c_Eri_straight_line", companions=[b], observations=[hip],
        variables=dict(
            M=1.0, rv=0.0,
            plx=d.Uniform(10.0, 100.0),
            pmra=d.Uniform(-100.0, 100.0),
            pmdec=d.Uniform(-100.0, 100.0),
            ra_hip_offset_mas=d.Normal(0.0, 10_000.0),
            dec_hip_offset_mas=d.Normal(0.0, 10_000.0),
            dec=lambda s: dec0 + s.dec_hip_offset_mas * mas2deg,
            ra=lambda s: ra0 + s.ra_hip_offset_mas * mas2deg / xp.cos(xp.deg2rad(s.dec)),
            ref_epoch=pkg.constants.HIPPARCOS_EPOCH_MJD,
        ),
    )
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


HIP_GUESS = dict(plx=HIP_SOL["plx"], pmra=HIP_SOL["pm_ra"], pmdec=HIP_SOL["pm_de"],
                 ra_hip_offset_mas=0.0, dec_hip_offset_mas=0.0)
# the new fits' initialization runs INIT_OPT_STEPS multistart Adam steps,
# not the default 1000 (most of an initialization's time: each is one
# evaluation at 512 starts)
INIT_OPT_STEPS = 300
# the Hipparcos mass fit, which does not mix at the smoke's length either
# way, runs HIP_MASS_OPT_STEPS (most of its initialization's time)
HIP_MASS_OPT_STEPS = 100


def _hgca_row_template() -> dict:
    """tests/test_astrom.py:hgca_linfit_model's catalog row (the model's
    proper motions are written over it)."""
    return dict(
        pmra_hip=0.0, pmdec_hip=0.0, pmra_hip_error=0.4, pmdec_hip_error=0.4,
        pmra_pmdec_hip=0.1,
        pmra_gaia=0.0, pmdec_gaia=0.0, pmra_gaia_error=0.03, pmdec_gaia_error=0.03,
        pmra_pmdec_gaia=-0.1,
        pmra_hg=0.0, pmdec_hg=0.0, pmra_hg_error=0.03, pmdec_hg_error=0.03, pmra_pmdec_hg=0.0,
        epoch_ra_hip=1991.25, epoch_dec_hip=1991.25, epoch_ra_gaia=2016.0, epoch_dec_gaia=2016.0,
        nonlinear_dpmra=0.0, nonlinear_dpmdec=0.0, parallax_gaia=50.0, parallax_gaia_error=0.05,
    )


def build_hgca_model(pkg, data, basis="Visual{KepOrbit}", missed_transits=None, **model_kw):
    """The HGCA linear-fit model with either package: `HGCAObs`
    (include_iad=True) over the IAD and the GOST scan law of `data`, on the
    headline planet with a mass (D = 14) and its relative astrometry. On
    AbsoluteVisual{KepOrbit} the barycentre sits at GAIA_SOL's position at
    the Gaia DR3 epoch, with no radial velocity."""
    d = pkg.distributions
    hip = pkg.HipparcosIADObs(iad_file=data["iad_file"])
    gaia = pkg.GaiaCatalogFitObs(gaia_sol=GAIA_SOL, scanlaw=data["gost_file"])
    hgca = pkg.HGCAObs(hgca=data["hgca"], hip_like=hip, gaia_like=gaia, include_iad=True)
    b = pkg.Planet(name="b", basis=basis,
                   variables=dict(_headline_planet_variables(pkg), mass=d.Uniform(0.0, 100.0)),
                   observations=[pkg.PlanetRelAstromObs(data["astrom"], name="simdata")])
    sys_vars = dict(_headline_system_variables(pkg), pmra=d.Normal(0.0, 100.0),
                    pmdec=d.Normal(0.0, 100.0))
    if basis == ABSOLUTE:
        sys_vars.update(ra=GAIA_SOL["ra"], dec=GAIA_SOL["dec"], rv=0.0, ref_epoch=57388.5)
    if missed_transits is not None:
        sys_vars["missed_transits"] = np.asarray(missed_transits, dtype=np.float64)
    system = pkg.System(name="hgcalinfit", variables=sys_vars, companions=[b],
                        observations=[hgca])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def _headline_state(t_mjd=57000.0):
    """The headline orbit (TRUE) at `t_mjd` from a plain numpy Kepler solve
    (the period in days from the Gaussian gravitational constant, as
    `constants.KEPLER_YEAR_DAYS`): its position angle and its Cartesian
    state (x, y, z [AU], vx, vy, vz [AU/day]; +x East, +y North, +z away)."""
    t = TRUE
    n = 2 * np.pi / (np.sqrt(t["a"] ** 3 / t["M"]) * 2 * np.pi / 0.01720209894846)
    M = n * (t_mjd - t["tp"])
    E = M
    for _ in range(50):
        E = E - (E - t["e"] * np.sin(E) - M) / (1 - t["e"] * np.cos(E))
    sq, Edot = np.sqrt(1 - t["e"] ** 2), n / (1 - t["e"] * np.cos(E))
    X, Y = t["a"] * (np.cos(E) - t["e"]), t["a"] * sq * np.sin(E)
    VX, VY = -t["a"] * np.sin(E) * Edot, t["a"] * sq * np.cos(E) * Edot
    cw, sw, cO, sO, ci = (np.cos(t["omega"]), np.sin(t["omega"]), np.cos(t["Omega"]),
                          np.sin(t["Omega"]), np.cos(t["i"]))
    A, B = cO * cw - sO * sw * ci, sO * cw + cO * sw * ci
    F, G = -cO * sw - sO * cw * ci, -sO * sw + cO * cw * ci
    si = np.sin(t["i"])
    state = dict(x=B * X + G * Y, y=A * X + F * Y, z=si * (sw * X + cw * Y),
                 vx=B * VX + G * VY, vy=A * VX + F * VY, vz=si * (sw * VX + cw * VY))
    return float(np.arctan2(state["x"], state["y"])), {k: float(v) for k, v in state.items()}


def hgca_truth(model) -> list:
    """The HGCA model's natural-space truth: the headline orbit with the
    30 Mjup companion and the Gaia catalog's proper motions."""
    theta, _ = _headline_state()
    t = TRUE
    values = {"M": t["M"], "plx": t["plx"], "pmra": HGCA_PM[0], "pmdec": HGCA_PM[1],
              "b_a": t["a"], "b_e": t["e"], "b_i": t["i"], "b_omegax": np.cos(t["omega"]),
              "b_omegay": np.sin(t["omega"]), "b_Omegax": np.cos(t["Omega"]),
              "b_Omegay": np.sin(t["Omega"]), "b_thetax": np.cos(theta),
              "b_thetay": np.sin(theta), "b_mass": HGCA_MASS}
    return [values[n] for n in model.parameter_names]


def hgca_data(ot, directory, n_orbits=HIP_ORBITS, n_transits=GOST_TRANSITS) -> dict:
    """The HGCA path's data: the IAD (`n_orbits` x 2 abscissae) and the
    GOST scan law (`n_transits`) written into `directory`, the headline's
    relative astrometry (`bench_table`), and the catalog row that the
    port's `generate_from_params` makes at the truth on the CPU in float64
    (no noise)."""
    data = {"iad_file": write_synth_iad(str(Path(directory) / "hgca_iad.d"), n_orbits=n_orbits),
            "gost_file": synth_gost_csv(directory, n=n_transits),
            "astrom": bench_table(ot), "hgca": _hgca_row_template()}
    model = build_hgca_model(ot, data, device="cpu")
    truth = model.arr2nt(model.tensor(hgca_truth(model)))
    data["hgca"] = dict(ot.generate_from_params(model, truth).observations[0].hgca)
    return data


def dr4_table(n=DR4_EPOCHS, seed=0) -> dict:
    """tests/test_astrom.py:test_gaia_dr4_roundtrip's scans at `n` epochs
    (MJD 57000-58500), centroids 0 until `dr4_data` fills them."""
    rng = np.random.default_rng(seed)
    return dict(epoch=np.sort(rng.uniform(57000, 58500, n)), centroid_pos_al=np.zeros(n),
                centroid_pos_error_al=np.full(n, 0.05), scan_pos_angle=rng.uniform(0, 2 * np.pi, n),
                parallax_factor_al=rng.uniform(-0.7, 0.7, n))


def build_dr4_model(pkg, table, basis="Visual{KepOrbit}", detrend=False, **model_kw):
    """tests/test_astrom.py:390-437's Gaia DR4 model (D = 2: the jitter and
    the companion's mass) with either package, on the Visual or the
    AbsoluteVisual branch, with or without `primary_star_perturbation`."""
    d = pkg.distributions
    obs = pkg.GaiaDR4AstromObs(table, gaia_sol=dict(ra=68.0, dec=-51.0),
                               primary_star_perturbation=detrend,
                               variables=dict(astrometric_jitter=d.LogUniform(1e-4, 1.0)))
    b = pkg.Planet(name="b", basis=basis,
                   variables=dict(a=2.0, e=0.1, i=0.5, omega=1.0, Omega=2.0, tp=57000.0,
                                  mass=d.Uniform(0.0, 50.0)))
    sys_vars = dict(M=1.0, plx=50.0, pmra=0.0, pmdec=0.0)
    if basis == ABSOLUTE:
        sys_vars.update(ra=68.0, dec=-51.0, rv=0.0, ref_epoch=57388.5)
    system = pkg.System(name="dr4", variables=sys_vars, companions=[b], observations=[obs])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def dr4_data(ot) -> dict:
    """The DR4 path's table: its centroids made by the port's
    `generate_from_params` on the Visual branch at DR4_TRUTH, on the CPU
    in float64, without noise."""
    model = build_dr4_model(ot, dr4_table(), device="cpu")
    truth = model.arr2nt(model.tensor([DR4_TRUTH[n] for n in model.parameter_names]))
    return dict(ot.generate_from_params(model, truth).observations[0].table)


# The G23H composite fit (`examples/06_g23h_absolute_astrometry.py` and the
# JAX package's tests/test_g23h.py): the synthetic catalog row and DR2+DR3
# GOST scan law of those tests (the real HIP 384 row is not in the
# repository), the IAD of tests/test_astrom.py (30 orbits x 2 abscissae)
# and G23H_TRANSITS Gaia scans: 140 epochs in all
G23H_TRANSITS = 80
# examples/06's Gaia solution when it runs on the synthetic row
G23H_EXAMPLE_SOL = dict(ra=158.3, dec=-40.4, parallax=50.0, pmra=0.0, pmdec=0.0,
                        ra_error=0.03, dec_error=0.03, parallax_error=0.05, pmra_error=0.03,
                        pmdec_error=0.03)
# tests/test_g23h.py:381's injection: a 40 Mjup companion on its fixed
# orbit, the catalog made with noise from numpy's seed 5; every other
# parameter 0
G23H_INJECTION = {"b_mass": 40.0, "pmra": -3.0, "pmdec": 7.0, "G23H_σ_AL": 0.132,
                  "G23H_σ_att": 0.0779, "G23H_σ_calib": 0.0795, "G23H_hip_iad_jitter": 0.5,
                  "G23H_σ_rv_per_transit": 0.4}
G23H_NOISE_SEED = 5
# examples/06's model has no truth (its catalog row is all zeros): its
# points near "the truth" are near this one, a 20 Mjup companion at 5 AU
G23H_EXAMPLE_POINT = {"M": 1.0, "plx": 50.0, "pmra": 0.0, "pmdec": 0.0, "b_a": 5.0,
                      "b_i": 0.6, "b_omegax": 0.6, "b_omegay": 0.8, "b_Omegax": -0.8,
                      "b_Omegay": 0.6, "b_tp": 50000.0, "b_mass": 20.0,
                      "G23H_hip_iad_jitter": 0.5}


def synth_gost_dr23(directory, n=G23H_TRANSITS):
    """tests/test_g23h.py:synth_gost_dr23's GOST forecast of `n` Gaia
    transits spanning the DR2 and DR3 AGIS windows, as
    `directory`/gost_dr23.csv."""
    from octofitter_tpu_torch.astrom.scanlaw import GAIA_AGIS_SPAN_DR2, GAIA_AGIS_SPAN_DR3
    from octofitter_tpu_torch.constants import mjd2jd

    rng = np.random.default_rng(2)
    mjd = np.sort(rng.uniform(GAIA_AGIS_SPAN_DR2["start_mjd"] + 5,
                              GAIA_AGIS_SPAN_DR3["stop_mjd"] - 5, n))
    jd = mjd2jd(mjd)
    angle = rng.uniform(-np.pi, np.pi, n)
    parf = rng.uniform(-0.7, 0.7, n)
    path = str(Path(directory) / "gost_dr23.csv")
    with open(path, "w") as f:
        f.write("Target, scanAngle[rad], parallaxFactorAlongScan,"
                " ObservationTimeAtBarycentre[BarycentricJulianDateInTCB]\n")
        for i in range(n):
            f.write(f"t,{angle[i]},{parf[i]},{jd[i]}\n")
    return path


def g23h_catalog_row() -> dict:
    """tests/test_g23h.py:g23h_catalog_row, the synthetic G23H catalog row
    (examples/06 reads it when the real one is absent)."""
    return dict(
        pmra_hip=0.0, pmdec_hip=0.0, pmra_hip_error=0.5, pmdec_hip_error=0.5,
        pmra_pmdec_hip=0.1,
        pmra_hg=0.0, pmdec_hg=0.0, pmra_hg_error=0.03, pmdec_hg_error=0.03,
        pmra_pmdec_hg=0.0,
        pmra_dr2=0.0, pmdec_dr2=0.0, pmra_dr2_error=0.06, pmdec_dr2_error=0.06,
        pmra_pmdec_dr2=-0.1,
        pmra_dr32=0.0, pmdec_dr32=0.0, pmra_dr32_error=0.05, pmdec_dr32_error=0.05,
        pmra_pmdec_dr32=0.0,
        pmra_dr3=0.0, pmdec_dr3=0.0, pmra_dr3_error=0.03, pmdec_dr3_error=0.03,
        pmra_pmdec_dr3=-0.2,
        epoch_ra_hip=1991.25, epoch_dec_hip=1991.25,
        epoch_ra_dr2_mjd=57205.875, epoch_dec_dr2_mjd=57205.875,
        epoch_ra_dr3_mjd=57388.5, epoch_dec_dr3_mjd=57388.5,
        nonlinear_dpmra=0.0, nonlinear_dpmdec=0.0,
        astrometric_chi2_al_dr3=500.0,
        astrometric_n_good_obs_al_dr3=400,
        astrometric_matched_transits_dr3=50,
        astrometric_params_solved_dr3=31,
        ruwe_dr3=1.05,
        rho_dr2_dr3=0.3,
        radial_velocity_error=0.5,
        rv_nb_transits=10,
    )


def g23h_catalog_row_full() -> dict:
    """tests/test_g23h.py:g23h_catalog_row_full: the row with the sidecar
    fields the automatic variables use (a bright star, so the DR2
    duplicate count is marginalized; the UEVA calibration priors; the
    central-epoch position covariances; the RV uncertainty prior)."""
    row = g23h_catalog_row()
    row.update(
        astrometric_matched_observations_dr2=30,
        phot_g_mean_mag_dr3=5.5,
        sig_AL=0.132, sig_AL_sigma=0.01,
        sig_att_radec=0.0779, sig_att_radec_sigma=0.01,
        sig_cal=0.0795, sig_cal_sigma=0.01,
        ra_error_central_dr3=0.02, dec_error_central_dr3=0.02,
        ra_dec_corr_central_dr3=0.1,
        ra_error_central_dr2=0.04, dec_error_central_dr2=0.04,
        ra_dec_corr_central_dr2=-0.05,
        rv_ln_uncert_dr3=-1.0, rv_ln_uncert_err_dr3=0.2,
    )
    return row


def g23h_data(directory) -> dict:
    """The G23H paths' files, written into `directory`: the IAD of
    tests/test_g23h.py (30 orbits x 2 abscissae, residuals N(0, 1.5)) and
    the DR2+DR3 GOST scan law."""
    return {"iad_file": write_synth_iad(str(Path(directory) / "g23h_iad.d"), res_sigma=1.5),
            "gost_file": synth_gost_dr23(directory)}


def build_g23h_example_model(pkg, data, basis="Visual{KepOrbit}", **model_kw):
    """examples/06's model with either package: `G23HObs` with its
    automatic variables (one priority per Gaia scan, marginalized epoch
    selection, the IAD nuisances; D = 98) on the synthetic row, a planet of
    free orbit and mass. On AbsoluteVisual{KepOrbit} the barycentre sits at
    the example's Gaia position at the DR3 epoch, with no radial velocity."""
    d = pkg.distributions
    hip = pkg.HipparcosIADObs(iad_file=data["iad_file"])
    gaia = pkg.GaiaCatalogFitObs(gaia_sol=G23H_EXAMPLE_SOL, scanlaw=data["gost_file"])
    g23h = pkg.G23HObs(catalog=g23h_catalog_row(), gaia_like=gaia, hip_like=hip)
    sol = G23H_EXAMPLE_SOL
    b = pkg.Planet(name="b", basis=basis, variables=dict(
        a=d.LogUniform(0.1, 50.0), e=0.05, i=d.Sine(), omega=pkg.UniformCircular(),
        Omega=pkg.UniformCircular(), tp=d.Uniform(40000.0, 60000.0),
        mass=d.LogUniform(1.0, 3000.0)))
    sys_vars = dict(M=d.truncated(d.Normal(1.0, 0.1), lower=0.1),
                    plx=d.truncated(d.Normal(sol["parallax"], 2.0), lower=0.1),
                    pmra=d.Normal(sol["pmra"], 20.0), pmdec=d.Normal(sol["pmdec"], 20.0))
    if basis == ABSOLUTE:
        sys_vars.update(ra=sol["ra"], dec=sol["dec"], rv=0.0, ref_epoch=57388.5)
    system = pkg.System(name="G23H_example", variables=sys_vars, companions=[b],
                        observations=[g23h])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def build_g23h_model(pkg, data, basis="Visual{KepOrbit}", *, freeze=True, ueva_mode="RUWE",
                     include_rv=True, row=None, variables=None, **model_kw):
    """tests/test_g23h.py:g23h_model_marg's model with either package:
    `G23HObs` with its automatic variables on the full synthetic row (or
    `row`), frozen (`freeze`: the selection drawn once, D = 13) or
    marginalized epochs, a planet of fixed orbit and free mass; with
    `variables` (a function of the package), those instead, and no epoch
    selection (tests/test_g23h.py:g23h_model). On
    AbsoluteVisual{KepOrbit} the barycentre sits at GAIA_SOL's position at
    the DR3 epoch, with no radial velocity."""
    d = pkg.distributions
    hip = pkg.HipparcosIADObs(iad_file=data["iad_file"])
    gaia = pkg.GaiaCatalogFitObs(gaia_sol=GAIA_SOL, scanlaw=data["gost_file"])
    g23h = pkg.G23HObs(catalog=g23h_catalog_row_full() if row is None else row, gaia_like=gaia,
                       hip_like=hip, freeze_epochs=freeze, ueva_mode=ueva_mode,
                       include_rv=include_rv,
                       variables=None if variables is None else variables(pkg))
    b = pkg.Planet(name="b", basis=basis, variables=dict(
        a=6.0, e=0.1, i=0.6, omega=1.0, Omega=2.0, tp=50000.0, mass=d.Uniform(0.0, 100.0)))
    sys_vars = dict(M=1.1, plx=50.0, pmra=d.Normal(0.0, 100.0), pmdec=d.Normal(0.0, 100.0))
    if basis == ABSOLUTE:
        sys_vars.update(ra=GAIA_SOL["ra"], dec=GAIA_SOL["dec"], rv=0.0, ref_epoch=57388.5)
    system = pkg.System(name="g23hmarg", variables=sys_vars, companions=[b],
                        observations=[g23h])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def g23h_injection_truth(model) -> list:
    """The injection's natural-space point in `model`'s parameter order."""
    return [G23H_INJECTION.get(n, 0.0) for n in model.parameter_names]


def g23h_injected_row(ot, data) -> dict:
    """The injection's catalog row: the frozen-epoch model's
    `generate_from_params` at G23H_INJECTION with noise from numpy's seed
    G23H_NOISE_SEED, made by the port on the CPU in float64."""
    model = build_g23h_model(ot, data, device="cpu")
    truth = model.arr2nt(model.tensor(g23h_injection_truth(model)))
    system = ot.generate_from_params(model, truth, add_noise=True,
                                     rng=np.random.default_rng(G23H_NOISE_SEED))
    return dict(system.observations[0].catalog)


def g23h_example_point(model, seed=0) -> list:
    """G23H_EXAMPLE_POINT in `model`'s parameter order, the priorities drawn
    N(0, 1) from numpy's `seed`, the IAD nuisances 0."""
    rng = np.random.default_rng(seed)
    return [G23H_EXAMPLE_POINT.get(n, rng.standard_normal() if "priorities" in n else 0.0)
            for n in model.parameter_names]


# Observable and stability priors with photometry: the headline planet b
# and an outer companion c, b's relative astrometry wrapped in
# ObsPriorAstromONeil2019, NonCrossingPrior, HillStabilityPrior and
# PlanetOrderPrior on the system, and c's J magnitude through a Sonora
# Bobcat-format grid (D = 22). The natural points: one valid, then one that
# breaks each hard prior alone where it can (crossing orbits; c inside b,
# which also fails the Hill criterion; Hill-unstable masses)
SONORA_BAND = "MKO_J"
OBS_PRIOR_PHOT = dict(phot=np.array([15.6, 15.45]), σ_phot=np.array([0.1, 0.15]))
OBS_PRIOR_POINT = {"M": TRUE["M"], "plx": TRUE["plx"], "b_a": TRUE["a"], "b_e": TRUE["e"],
                   "b_i": TRUE["i"], "b_omegax": math.cos(TRUE["omega"]),
                   "b_omegay": math.sin(TRUE["omega"]), "b_Omegax": math.cos(TRUE["Omega"]),
                   "b_Omegay": math.sin(TRUE["Omega"]), "b_mass": 5.0, "c_a": 25.0, "c_e": 0.1, "c_i": 0.7, "c_omegax": 0.8,
                   "c_omegay": 0.6, "c_Omegax": 0.0, "c_Omegay": 1.0, "c_tp": 55000.0,
                   "c_mass": 10.0, "c_teff": 800.0}
OBS_PRIOR_VIOLATIONS = {"crossing": {"c_a": 9.0, "c_e": 0.3},
                        "order": {"c_a": 5.0, "c_e": 0.0},
                        "hill": {"c_a": 11.0, "c_e": 0.0, "b_mass": 60.0, "c_mass": 60.0}}


def write_sonora_grid(directory) -> str:
    """A photometry table in the Sonora Bobcat `mag_table` layout (the six
    physical columns, then 25 bands), as `directory`/mag_table+0.0: Teff
    200-2400 K x mass 0.5-80 Mjup on a 12 x 10 grid, each band's absolute
    magnitude a smooth made-up function of both."""
    teff = np.linspace(200.0, 2400.0, 12)
    mass = np.linspace(0.5, 80.0, 10)
    lines = ["# Teff logg mass R Y logKzz and 25 bands (made-up values)"]
    for t in teff:
        for m in mass:
            bands = [20.0 - 7.5 * np.log10(t / 200.0) - 0.01 * m + 0.05 * k + 0.1 * np.sin(t / 300.0)
                     for k in range(25)]
            row = [t, 4.0 + 0.01 * m, m, 0.1, 0.27, 2.0] + bands
            lines.append(" ".join(f"{v:.5f}" for v in row))
    path = str(Path(directory) / "mag_table+0.0")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def build_obs_prior_model(pkg, table, sonora_file, **model_kw):
    """The two-planet headline model with the observable and stability priors
    and photometry (D = 22), with either package."""
    d = pkg.distributions
    mag = pkg.sonora_photometry_interpolator(SONORA_BAND, sonora_file)
    astrom = pkg.ObsPriorAstromONeil2019(pkg.PlanetRelAstromObs(table, name="simdata"))
    b = pkg.Planet(name="b", basis="Visual{KepOrbit}", observations=[astrom],
                   variables=dict(_headline_planet_variables(pkg), mass=d.Uniform(0.5, 80.0)))
    c = pkg.Planet(name="c", basis="Visual{KepOrbit}",
                   observations=[pkg.PhotometryObs(OBS_PRIOR_PHOT, name="photometry")],
                   variables=dict(a=d.Uniform(3.0, 60.0), e=d.Uniform(0.0, 0.5), i=d.Sine(),
                                  omega=pkg.UniformCircular(), Omega=pkg.UniformCircular(),
                                  tp=d.Uniform(50000.0, 60000.0), mass=d.Uniform(0.5, 80.0),
                                  teff=d.Uniform(300.0, 2000.0),
                                  flux=lambda sys, pl: mag(pl.teff, pl.mass)))
    system = pkg.System(name="obs_priors", variables=_headline_system_variables(pkg),
                        companions=[b, c],
                        observations=[pkg.NonCrossingPrior(), pkg.HillStabilityPrior(),
                                      pkg.PlanetOrderPrior("b", "c")])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def obs_prior_points(model):
    """OBS_PRIOR_POINT (b at the headline's truth, its position angle at MJD
    57000 as theta) and each of OBS_PRIOR_VIOLATIONS, in `model`'s
    parameter order: (4, D), natural space."""
    theta, _ = _headline_state()
    point = dict(OBS_PRIOR_POINT, b_thetax=math.cos(theta), b_thetay=math.sin(theta))
    rows = [point] + [dict(point, **v) for v in OBS_PRIOR_VIOLATIONS.values()]
    return np.array([[r[n] for n in model.parameter_names] for r in rows])


# examples/05 (`examples/05_images_interferometry_transits.py`): a direct
# image, closure phases from an OIFITS file, and a transit light curve, each
# fitted on its own; the data made as the example makes it (one numpy rng,
# seed 0, draws the image noise, then the closure-phase noise; the light
# curve by `generate_from_params` with rng seed 1), with the port's
# orbitsolve in float64 on the CPU. The example puts its blob at column
# round(+RA / platescale), mirrored against `ImageObs`'s x = -RA
# (`images.jl:210-212`): at the truth the model would read column 51.07 of
# a blob over columns 48-50. The blob here sits at round(-RA / platescale).
EX05_TRUE = dict(a=12.0, e=0.1, i=0.5, omega=1.0, Omega=2.0, tp=57000.0, M=1.2, plx=30.0)
EX05_IMAGE = dict(epoch=57400.0, npix=101, platescale=10.0, noise=0.1, blob=3.0)
EX05_IF = dict(epoch=57500.0, contrast=0.02, cp_noise=0.5)
EX05_IF_WAVE = np.linspace(2.0e-6, 2.4e-6, 5)
EX05_IF_UV = (np.array([40.0, -25.0, 65.0]), np.array([15.0, 80.0, -35.0]))  # m
EX05_TRANSIT = dict(P_days=3.5, tp=57000.0, r=0.1, n=120, sigma=3e-4, R_sun_m=6.957e8,
                    u1=0.4, u2=0.25)
# their fits: ChEES at CHAINS chains, the example's depths (300 + 200 with
# 16 chains; the transit 250 + 150 with 8) cut to EX05_ADAPTATION +
# EX05_ITERATIONS; the planted-fault fits at EX05_FAULT_CHAINS
EX05_ADAPTATION, EX05_ITERATIONS = 200, 100
# and ChEES at most 2^EX05_MAX_DEPTH leapfrog steps, the example's max_depth;
# the planted-fault fits at EX05_FAULT_CHAINS chains, shorter and capped at
# 2^EX05_FAULT_MAX_DEPTH steps (a fault's posterior is broad)
EX05_MAX_DEPTH = 8
EX05_FAULT_CHAINS, EX05_FAULT_ADAPTATION, EX05_FAULT_ITERATIONS = 1024, 60, 30
EX05_FAULT_MAX_DEPTH = 5
# Recovery gates: each free parameter's posterior mean within these of the
# injected value. The image: the blob covers 3 x 3 pixels (a moves the
# model ~0.4 AU per pixel here) and the posterior settles on its brightest
# pixel (a = 11.61 on the CPU), the flux's sd is ~0.26. The interferometry:
# a within 1.5 AU (the posterior's main mode is a fringe alias at 11.05, see
# `ex05_if_reference`), the contrast within 0.01 (0.0187 +- 0.0035 on the
# CPU). The transit: r within 0.002.
EX05_GATES = {"image": {"b_a": 0.5, "b_nircam_flux": 1.0},
              "interferometry": {"b_a": 1.5, "b_gravity_f": 0.01},
              "transit": {"b_r": 0.002}}


EX05_TRUTH = {"image": {"b_a": EX05_TRUE["a"], "b_nircam_flux": EX05_IMAGE["blob"]},
              "interferometry": {"b_a": EX05_TRUE["a"], "b_gravity_f": EX05_IF["contrast"]},
              "transit": {"b_r": EX05_TRANSIT["r"]}}


def _ex05_position(ot, epoch) -> tuple[float, float]:
    orbit = ot.VisualOrbit.from_params(**EX05_TRUE, device="cpu")
    sol = ot.orbitsolve(orbit, np.array([epoch]))
    return float(ot.orbits.raoff(sol)[0]), float(ot.orbits.decoff(sol)[0])


def ex05_data(ot, directory) -> dict:
    """examples/05's three data sets: the image (101 x 101, 10 mas/px),
    the OIFITS file (3 baselines x 5 wavelengths, one triangle) written
    into `directory` with the port's `write_bintables`, and the light
    curve's table (120 epochs)."""
    from octofitter_tpu_torch.interferometry import closure_phases_deg, cvis_point_sources
    from octofitter_tpu_torch.io.fits import write_bintables

    rng = np.random.default_rng(0)
    im = EX05_IMAGE
    ra, dec = _ex05_position(ot, im["epoch"])
    img = rng.standard_normal((im["npix"], im["npix"])) * im["noise"]
    row = int(round(dec / im["platescale"])) + im["npix"] // 2
    col = int(round(-ra / im["platescale"])) + im["npix"] // 2
    img[row - 1: row + 2, col - 1: col + 2] += im["blob"]

    dra, ddec = _ex05_position(ot, EX05_IF["epoch"])
    ucoord, vcoord = EX05_IF_UV
    u = ucoord[:, None] / EX05_IF_WAVE[None, :]
    v = vcoord[:, None] / EX05_IF_WAVE[None, :]
    cvis = cvis_point_sources(u, v, [dra], [ddec], [EX05_IF["contrast"]])
    cp_true = closure_phases_deg(cvis, [0], [2], [1]).numpy()
    path = str(Path(directory) / "gravity.oifits")
    write_bintables(path, [
        ({"EFF_WAVE": EX05_IF_WAVE}, {"EXTNAME": "OI_WAVELENGTH"}),
        ({"UCOORD": ucoord, "VCOORD": vcoord, "VIS2DATA": np.abs(cvis.numpy()) ** 2,
          "VIS2ERR": np.full((3, 5), 0.02), "STA_INDEX": np.array([[1, 2], [1, 3], [2, 3]]),
          "MJD": np.full(3, EX05_IF["epoch"])}, {"EXTNAME": "OI_VIS2"}),
        ({"T3PHI": cp_true + rng.standard_normal(cp_true.shape) * EX05_IF["cp_noise"],
          "T3PHIERR": np.full(cp_true.shape, EX05_IF["cp_noise"]),
          "STA_INDEX": np.array([[1, 2, 3]]), "MJD": np.full(1, EX05_IF["epoch"])},
         {"EXTNAME": "OI_T3"}),
    ])

    tr = EX05_TRANSIT
    # mid-transit (inferior conjunction) is ~0.932 d before periastron for
    # this geometry (omega = 0, Omega = 0, i = 90 deg)
    t_mid = tr["tp"] - 0.932
    epochs = np.linspace(t_mid - 0.15, t_mid + 0.15, tr["n"])
    table = dict(epoch=epochs, phot=np.ones(tr["n"]), σ_phot=np.full(tr["n"], tr["sigma"]))
    gen = build_transit_model(ot, table, device="cpu")
    nat = gen.tensor([tr["r"] if n == "b_r" else 0.0 for n in gen.parameter_names])
    system = ot.generate_from_params(gen, gen.arr2nt(nat), add_noise=True,
                                     rng=np.random.default_rng(1))
    table = dict(table, phot=system.planets[0].observations[0].table["phot"])
    return {"image": img, "oifits": path, "lightcurve": table}


@contextlib.contextmanager
def ex05_planted_fault(fault):
    """A fault planted in the port while the block runs: "image_ra_sign"
    reads images at x = +RA, "cp_sign" flips the sign of every model
    closure phase of `InterferometryObs`."""
    from octofitter_tpu_torch.images import likelihoods as images
    from octofitter_tpu_torch.interferometry import likelihoods as interferometry

    if fault == "image_ra_sign":
        module, name = images, "_sky_to_image"
        plain = module._sky_to_image
        faulty = lambda ra, dec: plain(-ra, dec)  # noqa: E731
    elif fault == "cp_sign":
        module, name = interferometry, "_closure_phases"
        plain = module._closure_phases
        faulty = lambda *args: -plain(*args)  # noqa: E731
    else:
        raise ValueError(fault)
    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, plain)


def build_image_model(pkg, image, **model_kw):
    """examples/05's image fit: a and the flux free (D = 2)."""
    d = pkg.distributions
    images = pkg.ImageObs([dict(image=image, epoch=EX05_IMAGE["epoch"],
                                platescale=EX05_IMAGE["platescale"])],
                          variables=dict(flux=d.Uniform(0.0, 10.0)), name="nircam")
    b = pkg.Planet(name="b", basis="Visual{KepOrbit}", observations=[images],
                   variables=dict(a=d.Uniform(5.0, 20.0), e=0.1, i=0.5, omega=1.0,
                                  Omega=2.0, tp=57000.0))
    system = pkg.System(name="imgsys", variables=dict(M=1.2, plx=30.0), companions=[b])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def build_interferometry_model(pkg, oifits, **model_kw):
    """examples/05's interferometry fit from its OIFITS file, closure
    phases only: a and the contrast free (D = 2). The example's derived
    `jnp.asarray([o["f"]])` is `o["f"][..., None]` here, which both
    packages read: one contrast per planet on a last axis."""
    d = pkg.distributions
    vlti = pkg.InterferometryObs([dict(filename=oifits, use_vis2=False)],
                                 variables=dict(f=d.LogUniform(1e-3, 1e-1),
                                                flux=lambda s, p, o: o["f"][..., None]),
                                 name="gravity")
    b = pkg.Planet(name="b", basis="Visual{KepOrbit}", observations=[vlti],
                   variables=dict(a=d.Uniform(5.0, 20.0), e=0.1, i=0.5, omega=1.0,
                                  Omega=2.0, tp=57000.0))
    system = pkg.System(name="ifsys", variables=dict(M=1.2, plx=30.0), companions=[b])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def build_transit_model(pkg, table, **model_kw):
    """examples/05's transit fit: a hot Jupiter (P = 3.5 d, edge-on) in
    front of a Sun-sized star with quadratic limb darkening (0.4, 0.25); the
    radius ratio free (D = 1)."""
    d = pkg.distributions
    tr = EX05_TRANSIT
    lc = pkg.LightCurveObs(table, name="tess")
    b = pkg.Planet(name="b", basis="Visual{KepOrbit}", observations=[lc],
                   variables=dict(a=(tr["P_days"] / 365.25) ** (2 / 3), e=0.0, i=np.pi / 2,
                                  omega=0.0, Omega=0.0, tp=tr["tp"], r=d.Uniform(0.0, 0.3)))
    system = pkg.System(name="transitsys", companions=[b],
                        variables=dict(M=1.0, plx=100.0, R=tr["R_sun_m"], u1=tr["u1"],
                                       u2=tr["u2"]))
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


# One float64 evaluation each of a likelihood map and of GRAVITY kernel
# phases. The map: tests/test_images_transits.py's 51 x 51 at 25 mas/px
# around its orbit (a = 10 AU at 50 mas), here two epochs of a smooth
# Gaussian log-likelihood peaked at the planet, a and e free (D = 2; a's
# prior reaches past the map's edge, where the fill value holds).
# GRAVITY: tests/test_misc_components.py's system (one planet, a and e
# free here) with 6 baselines, 4 triangles and 14 wavelengths; kp_Cy's
# prior runs past 1, where small jitters leave the covariance not positive
# definite (D = 5).
LLMAP_TRUE = dict(a=10.0, e=0.1, i=0.5, omega=1.0, Omega=2.0, tp=57000.0, M=1.2, plx=50.0)
LLMAP = dict(epochs=(57000.0, 57400.0), npix=51, platescale=25.0, width_px=4.0)
GRAV_TRUE = dict(a=8.0, e=0.1, i=0.4, omega=1.0, Omega=2.0, tp=57000.0, M=1.3, plx=40.0)
GRAV = dict(epoch=57000.0, contrast=0.02, n_wave=14, cp_noise=0.2,
            i1=(0, 0, 1, 3), i2=(3, 4, 5, 4), i3=(1, 2, 2, 5))


def llmap_data(ot) -> list:
    """The likelihood map's rows: one 51 x 51 map per epoch."""
    n, ps = LLMAP["npix"], LLMAP["platescale"]
    rows = []
    orbit = ot.VisualOrbit.from_params(**LLMAP_TRUE, device="cpu")
    for epoch in LLMAP["epochs"]:
        sol = ot.orbitsolve(orbit, np.array([epoch]))
        x0 = -float(ot.orbits.raoff(sol)[0]) / ps + (n - 1) / 2
        y0 = float(ot.orbits.decoff(sol)[0]) / ps + (n - 1) / 2
        yy, xx = np.mgrid[0:n, 0:n]
        ll = -0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2) / LLMAP["width_px"] ** 2
        rows.append(dict(map=ll, epoch=epoch, platescale=ps))
    return rows


def build_llmap_model(pkg, rows, **model_kw):
    d = pkg.distributions
    maps = pkg.LogLikelihoodMapObs(rows, name="llmap")
    b = pkg.Planet(name="b", basis="Visual{KepOrbit}", observations=[maps],
                   variables=dict(a=d.Uniform(5.0, 25.0), e=d.Uniform(0.0, 0.5),
                                  **{k: LLMAP_TRUE[k] for k in ("i", "omega", "Omega", "tp")}))
    system = pkg.System(name="llm", variables=dict(M=LLMAP_TRUE["M"], plx=LLMAP_TRUE["plx"]),
                        companions=[b])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def gravity_data(ot) -> dict:
    """A GRAVITY row: (u, v) drawn with numpy (seed 0) over 6 baselines and
    14 wavelengths in 2.0-2.4 um, the closure phases of the planet at its
    truth with 0.2 deg of noise."""
    from octofitter_tpu_torch.interferometry import closure_phases_deg, cvis_point_sources

    rng = np.random.default_rng(0)
    n_wave = GRAV["n_wave"]
    eff_wave = np.linspace(2.0e-6, 2.4e-6, n_wave)
    u = rng.uniform(-1e8, 1e8, (6, n_wave))
    v = rng.uniform(-1e8, 1e8, (6, n_wave))
    i1, i2, i3 = (np.array(GRAV[k]) for k in ("i1", "i2", "i3"))
    orbit = ot.VisualOrbit.from_params(**GRAV_TRUE, device="cpu")
    sol = ot.orbitsolve(orbit, np.array([GRAV["epoch"]]))
    cvis = cvis_point_sources(u, v, [float(ot.orbits.raoff(sol)[0])],
                              [float(ot.orbits.decoff(sol)[0])], [GRAV["contrast"]])
    cps = closure_phases_deg(cvis, i1, i2, i3).numpy()
    return dict(epoch=GRAV["epoch"], u=u, v=v, eff_wave=eff_wave,
                cps_data=cps + GRAV["cp_noise"] * rng.standard_normal(cps.shape),
                dcps=np.full(cps.shape, GRAV["cp_noise"]), index_cps1=i1, index_cps2=i2,
                index_cps3=i3)


def build_gravity_model(pkg, row, **model_kw):
    d = pkg.distributions
    obs = pkg.GRAVITYWideKPObs([row], name="GRAV", variables=dict(
        flux=d.Uniform(0.0, 0.2), kp_jitter=d.LogUniform(1e-3, 1.0), kp_Cy=d.Uniform(0.0, 1.5)))
    b = pkg.Planet(name="b", basis="Visual{KepOrbit}",
                   variables=dict(a=d.Uniform(5.0, 12.0), e=d.Uniform(0.0, 0.3),
                                  **{k: GRAV_TRUE[k] for k in ("i", "omega", "Omega", "tp")}))
    system = pkg.System(name="grav", variables=dict(M=GRAV_TRUE["M"], plx=GRAV_TRUE["plx"]),
                        companions=[b], observations=[obs])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


@contextlib.contextmanager
def degrees_one_ulp_off(seed=0, signs=None):
    """Within the block every propagated ra2 and dec2 of an AbsoluteVisual
    orbit (`orbits/absolute_visual.py:_deg`, which the block replaces) moves
    one ulp: all up for seed 0, all down for seed 1 (an arcsin or atan2 that
    rounds one argument apart does so at every epoch where the barycentre
    stands still), up or down at random from `seed` above; or, given
    `signs` (one tensor per call of `_deg` in an evaluation, in call
    order), up where the sign is positive and down elsewhere."""
    from octofitter_tpu_torch.orbits import absolute_visual

    plain = absolute_visual._deg
    gen = torch.Generator().manual_seed(seed)
    calls = []

    def nudged(x):
        y = plain(x)
        if signs is not None:
            up = (signs[len(calls) % len(signs)] > 0).to(y.device)
            calls.append(None)
        elif seed < 2:
            up = torch.full(y.shape, seed == 0, device=y.device)
        else:
            up = (torch.rand(y.shape, generator=gen, dtype=torch.float64) < 0.5).to(y.device)
        step = torch.nextafter(y.detach(), torch.where(up, math.inf, -math.inf).to(y.dtype))
        return y + (step - y.detach())  # the gradient passes through unchanged

    absolute_visual._deg = nudged
    try:
        yield
    finally:
        absolute_visual._deg = plain


def degrees_gradient_signs(ln_post, theta) -> list:
    """The sign of d ln_post / d(each propagated ra2 and dec2), summed over
    the rows of `theta`: one tensor per call of `_deg` in an evaluation, in
    call order (empty where no orbit is AbsoluteVisual{KepOrbit})."""
    from octofitter_tpu_torch.orbits import absolute_visual

    plain = absolute_visual._deg
    taps = []

    def tapped(x):
        y = plain(x)
        taps.append(torch.zeros_like(y, requires_grad=True))
        return y + taps[-1]

    absolute_visual._deg = tapped
    try:
        lp = ln_post(theta)
    finally:
        absolute_visual._deg = plain
    if not taps:
        return []
    lp = torch.where(torch.isfinite(lp), lp, 0.0)
    grads = torch.autograd.grad(lp.sum(), taps, allow_unused=True)
    return [torch.sign(g).detach().cpu() if g is not None else torch.zeros(t.shape)
            for g, t in zip(grads, taps)]


def ulp_sensitivity(fn, theta, ln_post=None):
    """How far `fn(theta)` = (values (C,), gradients (C, D)) move when the
    propagated degrees move by one ulp (`degrees_one_ulp_off`, ULP_SEEDS
    draws): per chain, the most |d value| and the most of the largest
    |d gradient|; zero where no planet is on AbsoluteVisual{KepOrbit}. With
    `ln_post` (the same model's), two more draws move every value an ulp
    the way that raises ln_post, and the other way (`degrees_gradient_signs`):
    the worst case to first order, where a likelihood that takes
    differences of propagated positions (G23H's release epochs) sees
    nothing of the draws that move all of them together."""
    lp, g = fn(theta)
    dv = dg = torch.zeros_like(lp)
    draws = [dict(seed=seed) for seed in range(ULP_SEEDS)]
    if ln_post is not None:
        signs = degrees_gradient_signs(ln_post, theta)
        if signs:
            draws += [dict(signs=signs), dict(signs=[-s for s in signs])]
    for draw in draws:
        with degrees_one_ulp_off(**draw):
            lp2, g2 = fn(theta)
        fin = torch.isfinite(lp) & torch.isfinite(lp2)
        dv = torch.maximum(dv, torch.where(fin, (lp2 - lp).abs(), 0.0))
        dg = torch.maximum(dg, torch.where(fin, (g2 - g).abs().amax(-1), 0.0))
    return dv, dg


def hold_values_and_gradients(label, lp, g, lp_ref, g_ref, dv, dg) -> tuple[float, float]:
    """(lp, g) against (lp_ref, g_ref), all on the CPU: the same rows finite,
    then over the finite rows each value within ABS_VALUE_TOL
    max(|lp_ref|, 1) + ULP_FACTOR dv and each chain's gradient within
    ABS_GRAD_TOL max(its largest entry, 1) + ULP_FACTOR dg (`dv`, `dg` from
    `ulp_sensitivity`). Returns the worst shares of those limits."""
    fin = torch.isfinite(lp_ref) & torch.isfinite(g_ref).all(dim=-1)
    if not torch.equal(torch.isfinite(lp), torch.isfinite(lp_ref)):
        raise AssertionError(f"{label}: the two evaluations disagree on which rows are finite")
    diff_v = (lp - lp_ref).abs()
    diff_g = (g - g_ref).abs().amax(-1)
    lim_v = ABS_VALUE_TOL * lp_ref.abs().clamp(min=1.0) + ULP_FACTOR * dv
    lim_g = ABS_GRAD_TOL * g_ref.abs().amax(-1).clamp(min=1.0) + ULP_FACTOR * dg
    share_v = float((diff_v / lim_v)[fin].max())
    share_g = float((diff_g / lim_g)[fin].max())
    log(f"{label}: {int(fin.sum())} of {len(lp)} points finite; ln_post max |diff| "
        f"{float(diff_v[fin].max()):.3e} ({float((diff_v / lp_ref.abs().clamp(min=1.0))[fin].max()):.3e}"
        f" relative), {share_v:.3f} of its limit; gradient {share_g:.3f} of its limit (one ulp "
        f"of the degrees moves ln_post by up to {float(dv[fin].max()):.3e})")
    if not (share_v <= 1.0 and share_g <= 1.0):
        raise AssertionError(f"{label}: the evaluations disagree")
    return share_v, share_g


def evaluation_profile(label, model, theta) -> dict:
    """One batched value-and-gradient of `model` at `theta`: host us per
    evaluation (the host clock around a synchronize, 10 calls after a
    warm-up), us by CUDA events, and the device operations and device-busy
    us per evaluation from torch.profiler."""
    fn = lambda: model.ln_post_and_grad(theta)  # noqa: E731
    dev_ms, host_ms = _time_both(fn, 10)
    ops, busy = _device_ops_per_call(fn)
    log(f"  {label}: {host_ms * 1e3:.1f} us per evaluation on the host clock, "
        f"{dev_ms * 1e3:.1f} us by CUDA events, "
        f"{ops if ops is not None else 'not measured'} device ops and "
        f"{f'{busy:.1f}' if busy is not None else 'not measured'} us of device time per "
        f"evaluation ({theta.shape[0]} chains, {model.n_epochs} epochs, {model.dtype})")
    return {"us": host_ms * 1e3, "device_us": dev_ms * 1e3, "ops": ops, "busy_us": busy}


def _card_evaluation(label, kk, osk, model, ref, theta, aligned_ulps=False) -> dict:
    """`model` (on the card) and `ref` (the CPU) at the unconstrained
    points `theta` (a CPU tensor), compared (`hold_values_and_gradients`,
    with the CPU model's `ulp_sensitivity`, its two sign-aligned draws too
    where `aligned_ulps`); the card's launches of the one evaluation and
    its profile."""
    lp_ref, g_ref = ref.ln_post_and_grad(theta)
    dv, dg = ulp_sensitivity(ref.ln_post_and_grad, theta, ref.ln_post if aligned_ulps else None)
    _reset_launches(kk, osk)
    lp, g = model.ln_post_and_grad(theta.to("cuda"))
    torch.cuda.synchronize()
    launches = _launches(kk, osk)
    shapes = dict(kk.launch_shapes)
    errs = hold_values_and_gradients(f"{label}, float64 card vs CPU", lp.cpu(), g.cpu(), lp_ref,
                                     g_ref, dv, dg)
    log(f"  {label}: launches of one evaluation {launches}; kepler_solve by shape {shapes}")
    prof = evaluation_profile(label, model, theta.to("cuda"))
    return {"launches": launches, "kepler_shapes": shapes, "errs": errs, "profile": prof,
            "lp": lp.cpu(), "g": g.cpu()}


def bases_phase(ot, kk, osk) -> dict:
    """One float64 value-and-gradient at CHAINS prior draws of the
    headline's relative astrometry on each of OTHER_BASES, on the card and
    on the CPU, compared. Gates: the standalone Kepler kernel launched once
    (and the fused pair never) where the basis solves Kepler's equation
    (AbsoluteVisual at each chain's emission epochs, Cartesian through its
    Campbell elements); the hyperbolic solve on the card, its anomaly held
    to the CPU's; no kernel for the fixed position."""
    t0 = time.perf_counter()
    table = bench_table(ot)
    res = {}
    for basis in OTHER_BASES:
        model = build_basis_model(ot, basis, table, device="cuda", dtype=torch.float64)
        ref = build_basis_model(ot, basis, table, device="cpu", dtype=torch.float64)
        theta = ref.link(ref.sample_priors(torch.Generator().manual_seed(11), CHAINS))
        out = _card_evaluation(f"basis {basis}", kk, osk, model, ref, theta)
        launches = out["launches"]
        kepler_expected = 1 if basis in (ABSOLUTE, "CartesianOrbit") else 0
        if launches["kepler_solve"] != kepler_expected or launches["orbit_solve_fwd"]:
            raise AssertionError(f"basis {basis}: launches {launches}, expected the Kepler "
                                 f"kernel {kepler_expected} time(s) and no fused pair")
        if basis == "Hyperbolic{KepOrbit}":
            with torch.no_grad():
                (orbit,) = model.construct_orbits(model.arr2nt(model.invlink(theta.to("cuda"))))
                sol = ot.orbitsolve(orbit, model._epochs_t)
                (orbit_c,) = ref.construct_orbits(ref.arr2nt(ref.invlink(theta)))
                sol_c = ot.orbitsolve(orbit_c, ref._epochs_t)
            err_h = float(((sol.EA.cpu() - sol_c.EA).abs() / sol_c.EA.abs().clamp(min=1.0)).max())
            log(f"  hyperbolic anomaly solved on {sol.EA.device}: max relative |dH| {err_h:.3e} "
                f"against the CPU (tol {ABS_VALUE_TOL:.0e})")
            if sol.EA.device.type != "cuda" or not err_h <= ABS_VALUE_TOL:
                raise AssertionError("basis Hyperbolic{KepOrbit}: the hyperbolic solve did not "
                                     "run on the card or disagrees with the CPU")
        res.setdefault("runs", {})[basis] = out
    res["seconds"] = time.perf_counter() - t0
    log(f"orbit bases phase: {res['seconds']:.2f} s")
    return res


def hip_path_phase(ot, kk, osk, directory) -> dict:
    """The Hipparcos path (`docs/hipparcos.md`), float64 on the card (the
    model subtracts the catalog position in degrees: float32 carries 27 mas
    at ra = 68 deg against 1.5 mas abscissa errors), `octofit` with
    initialization (the tutorial's guess) at CHAINS chains. First the
    tutorial's straight-line fit (D = 5), HIP_LINE_ADAPTATION +
    HIP_LINE_ITERATIONS, with the gates of `fit_phase` (the standalone
    Kepler kernel on every evaluation) and the tutorial's catalog test
    (|pull| < 3 on plx, pmra, pmdec). Then the companion-mass fit (D = 16,
    the relative astrometry added), HIP_ADAPTATION + HIP_ITERATIONS, with the
    gates of `fit_phase` and the same catalog test, R-hat reported, not
    gated: on the tutorial's 14 epochs, a short arc of the orbit, its
    (a, e, i, Omega) ridge and mass-position degeneracy do not mix in a run
    of this length, nor at 300 + 150 in the JAX package
    (`scripts/hip_mass_mixing.py` runs either package at this fit's
    initialization; PERF.md);
    then the card's evaluation at its last draws held to the CPU model's."""
    t0 = time.perf_counter()
    data = hip_data(directory)
    line = build_hip_line_model(ot, data, torch, device="cuda")
    res_line = fit_phase(ot, kk, osk, line, f"hipparcos catalog fit ({HIP_LINE_ADAPTATION} + "
                         f"{HIP_LINE_ITERATIONS})", CHAINS, HIP_LINE_ADAPTATION,
                         HIP_LINE_ITERATIONS,
                         init_kwargs={"guess": HIP_GUESS, "n_opt_steps": INIT_OPT_STEPS})
    hip_sol = line.system.observations[0].hip_sol
    _catalog_test("hipparcos catalog fit", res_line["chain"], hip_sol)

    model = build_hip_mass_model(ot, data, torch, device="cuda")
    ref = build_hip_mass_model(ot, data, torch, device="cpu")
    res = fit_phase(ot, kk, osk, model, f"hipparcos mass fit ({HIP_ADAPTATION} + "
                    f"{HIP_ITERATIONS})", CHAINS, HIP_ADAPTATION, HIP_ITERATIONS,
                    init_kwargs={"guess": HIP_GUESS, "n_opt_steps": HIP_MASS_OPT_STEPS},
                    rhat_gate=False)
    _catalog_test("hipparcos mass fit", res["chain"], hip_sol)
    mass = np.asarray(res["chain"]["b_mass"]).ravel()
    log(f"  companion mass 90% interval {np.percentile(mass, 5):.3f} - "
        f"{np.percentile(mass, 95):.3f} Mjup")
    nat = np.stack([res["chain"][n][:, -1] for n in model.parameter_names], axis=-1)
    theta = ref.link(ref.tensor(nat))
    res["evaluation"] = _card_evaluation("hipparcos evaluation at the last draws", kk, osk, model,
                                         ref, theta)
    res["line"] = res_line
    for shape, count in res_line["kepler_shapes"].items():
        res["kepler_shapes"][shape] = res["kepler_shapes"].get(shape, 0) + count
    res["seconds"] = time.perf_counter() - t0
    log(f"hipparcos phase: {res['seconds']:.2f} s")
    return res


def _catalog_test(label, chain, hip_sol) -> None:
    """`docs/hipparcos.md:102-113`'s catalog test: the posterior of plx,
    pmra and pmdec each within 3 combined sd of the Hipparcos catalog's."""
    for key, cat_key, err_key in (("plx", "plx", "e_plx"), ("pmra", "pm_ra", "e_pmra"),
                                  ("pmdec", "pm_de", "e_pmde")):
        post = np.asarray(chain[key]).ravel()
        mu, sd = float(post.mean()), float(post.std())
        cat, cat_err = hip_sol[cat_key], hip_sol[err_key]
        pull = (mu - cat) / math.hypot(sd, cat_err)
        log(f"  catalog test {key}: posterior {mu:.4f} +- {sd:.4f}, catalog {cat} +- {cat_err}, "
            f"pull {pull:+.3f}")
        if not abs(pull) < 3.0:
            raise AssertionError(f"{label}: {key} fails the catalog test (pull {pull:.3f})")


def _points_near(model, nat, n, seed):
    """`n` unconstrained points of `model`: the natural-space `nat` plus
    N(0, 1e-3) in every coordinate (CPU, float64)."""
    rng = np.random.default_rng(seed)
    base = model.link(model.tensor(np.asarray([nat]))).cpu().double()
    return base + torch.as_tensor(1e-3 * rng.standard_normal((n, model.D)))


def hgca_path_phase(ot, kk, osk, directory) -> dict:
    """The HGCA linear-fit path: its data made on the CPU in float64
    (`hgca_data`), the float32 model on the card checked against a float64
    CPU model (`reference_phase`), then `octofit` with initialization at
    CHAINS chains, ChEES, HGCA_ADAPTATION + HGCA_ITERATIONS, with the gates
    of `fit_phase` (the fused pair on every gradient evaluation) and the
    medians of b_mass and b_a within 5 sd of the truth. Then one float64
    evaluation of the same HGCAObs on AbsoluteVisual{KepOrbit} (the
    propagated-astrometry branch) at CHAINS points near the truth, held to
    the CPU model."""
    t0 = time.perf_counter()
    data = hgca_data(ot, directory)
    log(f"hgca data: catalog row made at the truth: "
        f"{ {k: round(v, 6) for k, v in data['hgca'].items() if k.startswith('pm') and 'error' not in k} }")
    model = build_hgca_model(ot, data, device="cuda", dtype=torch.float32)
    ref = build_hgca_model(ot, data, device="cpu", dtype=torch.float64)
    reference_phase("hgca linear fit", model, ref, _points_near(ref, hgca_truth(ref), 64, seed=5))
    res = fit_phase(ot, kk, osk, model, f"hgca path ({HGCA_ADAPTATION} + {HGCA_ITERATIONS})",
                    CHAINS, HGCA_ADAPTATION, HGCA_ITERATIONS,
                    init_kwargs={"n_opt_steps": INIT_OPT_STEPS})
    _gate_median("hgca path", res["chain"], "b_mass", HGCA_MASS)
    _gate_median("hgca path", res["chain"], "b_a", TRUE["a"])
    nat = np.stack([res["chain"][n][:, -1] for n in model.parameter_names], axis=-1)
    res["profile"] = evaluation_profile("hgca evaluation at the last draws", model,
                                        model.link(model.tensor(nat)))
    res["fits"] = hgca_fits_profile(ot, model)
    model_abs = build_hgca_model(ot, data, basis=ABSOLUTE, device="cuda", dtype=torch.float64)
    ref_abs = build_hgca_model(ot, data, basis=ABSOLUTE, device="cpu", dtype=torch.float64)
    theta = _points_near(ref_abs, hgca_truth(ref_abs), CHAINS, seed=8)
    res["absolute"] = _card_evaluation("hgca on AbsoluteVisual{KepOrbit}", kk, osk, model_abs,
                                       ref_abs, theta)
    if res["absolute"]["launches"]["kepler_solve"] != 1:
        raise AssertionError("hgca on AbsoluteVisual: the Kepler kernel was not launched once")
    res["seconds"] = time.perf_counter() - t0
    log(f"hgca phase: {res['seconds']:.2f} s")
    return res


def hgca_fits_profile(ot, model) -> dict:
    """The HGCA model's two 5-parameter fits alone, as one evaluation runs
    them (`astrom/fitting.py:fit_5param`: the Gaia window's scans, the
    Hipparcos window's with residuals and per-scan sigma), value and
    gradient with respect to the perturbations at CHAINS rows in the
    model's dtype: host us per call, device ops and device us."""
    from octofitter_tpu_torch.astrom import fit_5param

    obs = model.system.observations[0]
    rng = np.random.default_rng(9)
    tensor = model.tensor
    windows = []
    for like, extra in ((obs.gaia_like, {}), (obs.hip_like, {"res": "residuals", "sres": "sigma"})):
        n = len(like.table["epoch"])
        windows.append((tensor(like.A_prepared_5), tensor(like.table["cosphi"]),
                        tensor(like.table["sinphi"]),
                        tensor(rng.standard_normal((CHAINS, n))).requires_grad_(True),
                        tensor(rng.standard_normal((CHAINS, n))).requires_grad_(True),
                        {arg: tensor(like.table[col]) for col, arg in extra.items()}))

    def both():
        total = 0.0
        for A, c, s_, da, dd, kw in windows:
            total = total + sum(p.sum() for p in fit_5param(A, c, s_, da, dd, **kw)["parameters"])
        return torch.autograd.grad(total, [w[3] for w in windows] + [w[4] for w in windows])

    dev_ms, host_ms = _time_both(both, 20)
    ops, busy = _device_ops_per_call(both)
    log(f"  hgca 5-parameter fits (Gaia {windows[0][3].shape[-1]} and Hipparcos "
        f"{windows[1][3].shape[-1]} scans, {CHAINS} rows, {model.dtype}), value and gradient: "
        f"{host_ms * 1e3:.1f} us on the host clock, {dev_ms * 1e3:.1f} us by CUDA events, "
        f"{ops if ops is not None else 'not measured'} device ops, "
        f"{f'{busy:.1f}' if busy is not None else 'not measured'} us of device time")
    return {"us": host_ms * 1e3, "device_us": dev_ms * 1e3, "ops": ops, "busy_us": busy}


def dr4_path_phase(ot, kk, osk) -> dict:
    """The Gaia DR4 path at DR4_EPOCHS epochs: its centroids made on the
    CPU in float64 (`dr4_data`); on the Visual and the AbsoluteVisual
    branch, with and without `primary_star_perturbation`, one float64
    value-and-gradient at CHAINS prior draws on the card, held to the CPU
    model, with its launches (the fused forward once on the Visual branch,
    the standalone Kepler kernel once on the AbsoluteVisual one; the orbit
    is fixed, so no backward) and its profile."""
    t0 = time.perf_counter()
    table = dr4_data(ot)
    res = {}
    for basis in ("Visual{KepOrbit}", ABSOLUTE):
        for detrend in (False, True):
            label = f"dr4 {basis}{' detrended' if detrend else ''}"
            model = build_dr4_model(ot, table, basis, detrend, device="cuda", dtype=torch.float64)
            ref = build_dr4_model(ot, table, basis, detrend, device="cpu", dtype=torch.float64)
            theta = ref.link(ref.sample_priors(torch.Generator().manual_seed(12), CHAINS))
            out = _card_evaluation(label, kk, osk, model, ref, theta)
            launches = out["launches"]
            # the orbit is fixed (D = 2: the jitter and the mass), so no
            # gradient reaches the orbit solve: the forward alone runs
            expected = ({"kepler_solve": 1, "orbit_solve_fwd": 0} if basis == ABSOLUTE
                        else {"kepler_solve": 0, "orbit_solve_fwd": 1, "orbit_solve_bwd": 0})
            if any(launches[k] != v for k, v in expected.items()):
                raise AssertionError(f"{label}: launches {launches}, expected {expected}")
            res.setdefault("runs", {})[(basis, detrend)] = out
    res["seconds"] = time.perf_counter() - t0
    log(f"dr4 phase: {res['seconds']:.2f} s")
    return res


HGCA_SPAN = (47600.0, 59500.0)  # MJD: the Hipparcos mission to the last astrometry epoch
DR4_SPAN = (57000.0, 58500.0)


def absolute_astrometry_phases(ot, kk, osk, elements, kepler_mod, kernel_steps=True) -> dict:
    """The orbit bases, the Hipparcos, HGCA linear-fit and Gaia DR4 paths
    (their data in a temporary directory), then, with `kernel_steps`,
    `absolute_kernel_step`."""
    import tempfile

    t0 = time.perf_counter()
    res = {"bases": bases_phase(ot, kk, osk)}
    with tempfile.TemporaryDirectory() as directory:
        res["hip"] = hip_path_phase(ot, kk, osk, directory)
        res["hgca"] = hgca_path_phase(ot, kk, osk, directory)
    res["dr4"] = dr4_path_phase(ot, kk, osk)
    res["hip"]["n_epochs"] = res["hip"]["model"].n_epochs
    res["hgca"]["n_epochs"] = res["hgca"]["model"].n_epochs
    if kernel_steps:
        absolute_kernel_step(kk, osk, elements, kepler_mod, res)
    res["seconds"] = time.perf_counter() - t0
    log(f"absolute-astrometry phases: {res['seconds']:.2f} s")
    return res


def absolute_kernel_step(kk, osk, elements, kepler_mod, res) -> None:
    """The standalone Kepler kernel held to its twin (float64) at every
    shape the absolute-astrometry paths of `res` launched it with, and the
    fused pair against its plain versions at the HGCA fit's (CHAINS, 192)
    in float32 and the DR4 evaluations' (CHAINS, DR4_EPOCHS) in float64;
    the rows go into `res`."""
    t_step = time.perf_counter()
    res["hip_kepler"] = kepler_path_phase(kk, kepler_mod, res["hip"]["kepler_shapes"],
                                          (torch.float64,))
    shapes = {}
    for out in (*res["bases"]["runs"].values(), res["hgca"]["absolute"],
                *res["dr4"]["runs"].values()):
        for shape, count in out["kepler_shapes"].items():
            shapes[shape] = shapes.get(shape, 0) + count
    res["other_kepler_shapes"] = shapes
    res["other_kepler"] = kepler_path_phase(kk, kepler_mod, shapes, (torch.float64,))
    hgca_epochs = res["hgca"]["n_epochs"]
    res["hgca_shape"] = f"({CHAINS}, {hgca_epochs})"
    res["dr4_shape"] = f"({CHAINS}, {DR4_EPOCHS})"
    res["pair"] = orbit_shapes_phase(
        osk, elements, ((res["hgca_shape"], CHAINS, hgca_epochs, HGCA_SPAN, None),),
        (torch.float32,))
    pair64 = orbit_shapes_phase(
        osk, elements, ((res["dr4_shape"], CHAINS, DR4_EPOCHS, DR4_SPAN, None),),
        (torch.float64,))
    for part in ("fwd", "bwd"):
        res["pair"][part].update(pair64[part])
    log(f"absolute-astrometry kernel step: {time.perf_counter() - t_step:.2f} s")


def absolute_kernel_keys(kernels, res) -> None:
    """The absolute-astrometry paths' entries of the `kernels` line: every
    kernel's launches on each new path (`hip_line_launches` for the
    catalog fit, `hip_launches` for the mass fit); the Kepler kernel at the
    mass fit's per-evaluation shape (float64) under `hip_*` and at the other
    paths' shapes under `absolute_shapes`; the fused pair at the HGCA fit's shape (float32)
    under `hgca_*` and at the DR4 evaluations' (float64) under `dr4_*`."""
    f32, f64 = torch.float32, torch.float64
    bases = res["bases"]["runs"]
    dr4 = res["dr4"]["runs"]
    for k in kernels:
        name = k["name"]
        k["bases_launches"] = {b: out["launches"].get(name, 0) for b, out in bases.items()}
        k["hip_launches"] = res["hip"]["launches"].get(name, 0)
        k["hip_line_launches"] = res["hip"]["line"]["launches"].get(name, 0)
        k["hgca_launches"] = res["hgca"]["launches"].get(name, 0)
        k["hgca_absolute_launches"] = res["hgca"]["absolute"]["launches"].get(name, 0)
        k["dr4_launches"] = {f"{b}{' detrended' if d else ''}": out["launches"].get(name, 0)
                             for (b, d), out in dr4.items()}
        if name == "kepler_solve":
            # the shape of every evaluation of the mass fit
            hip_shape = (CHAINS, res["hip"]["n_epochs"])
            row = res["hip_kepler"][(hip_shape, f64)]
            bnd = bound_ms(24 * row["n"], OPS_KEPLER * row["n"], f64)
            k.update({"hip_shape": str(hip_shape), "hip_dtype": "float64",
                      "hip_launch_shapes": {str(sh): c for sh, c in
                                            res["hip"]["kepler_shapes"].items()},
                      "hip_max_abs_err": row["err"], "hip_ms": row["ms"],
                      "hip_plain_ms": row["plain_ms"], "hip_bound_ms": bnd[0],
                      "hip_bound_by": bnd[1]})
            shapes = {}
            for shape, count in res["other_kepler_shapes"].items():
                row = res["other_kepler"][(shape, f64)]
                bnd = bound_ms(24 * row["n"], OPS_KEPLER * row["n"], f64)
                shapes[str(shape)] = {"dtype": "float64", "launches": count,
                                      "max_abs_err": row["err"], "ms": row["ms"],
                                      "plain_ms": row["plain_ms"], "bound_ms": bnd[0],
                                      "bound_by": bnd[1]}
            k["absolute_shapes"] = shapes
        elif name.startswith("orbit_solve"):
            part = name.removeprefix("orbit_solve_")
            for key, shape, dtype, b, t in (
                    ("hgca", res["hgca_shape"], f32, CHAINS, res["hgca"]["n_epochs"]),
                    ("dr4", res["dr4_shape"], f64, CHAINS, DR4_EPOCHS)):
                row = res["pair"][part][(shape, dtype)]
                words = (8 * b + t + 14 * b * t if part == "fwd"
                         else 8 * b + t + 15 * b * t + 8 * b)
                ops = (OPS_ORBIT_FWD if part == "fwd" else OPS_ORBIT_BWD) * b * t
                bnd = bound_ms(dtype.itemsize * words, ops, dtype)
                k.update({f"{key}_shape": shape, f"{key}_dtype": str(dtype).removeprefix("torch."),
                          f"{key}_max_abs_err": row["err"], f"{key}_ms": row["ms"],
                          f"{key}_plain_ms": row["plain_ms"], f"{key}_bound_ms": bnd[0],
                          f"{key}_bound_by": bnd[1]})


# The G23H composite fit (`astrom/g23h.py`) and the observable priors with
# photometry (`likelihoods/obs_priors.py`, `likelihoods/photometry.py`,
# `atmosphere.py`). G23H_SPAN: the Hipparcos abscissae to the last Gaia
# scan (MJD), for the kernels' inputs at the G23H models' 140 epochs
G23H_SPAN = (47600.0, 59700.0)
# the injection fit passes the JAX test's gates at 100 + 50 (b_mass R-hat
# 1.0508 against 1.1; 1.033 at 150 + 75, on NVIDIA H100 machines); both
# G23H fits initialize with G23H_OPT_STEPS multistart Adam steps
G23H_ADAPTATION, G23H_ITERATIONS = 100, 50
G23H_OPT_STEPS = 100
# examples/06 through `octofit_pigeons` (its variational leg and ChEES
# explorer) at 512 walkers x (8 + 8) rungs, 8,192 rows per evaluation, and
# G23H_PT_ROUNDS rounds of at most 64 leapfrog steps (the example's 7 at 256
# would take many minutes)
G23H_PT_KWARGS = dict(n_chains=8, n_chains_variational=8, n_walkers=512, explorer="chees",
                      explorer_n_leapfrog=64)
G23H_PT_ROUNDS = 3


def g23h_evaluation_phase(ot, kk, osk, data) -> dict:
    """examples/06's model (marginalized epochs and the automatic variables,
    D = 98, 140 epochs) in float64 at CHAINS points, half near
    G23H_EXAMPLE_POINT and half prior draws, on Visual{KepOrbit} and
    AbsoluteVisual{KepOrbit}: the card held to the CPU (`_card_evaluation`:
    1e-9 relative plus 16 ulp-moves of the propagated degrees), with its
    launches and its profile. Gates: on Visual the fused pair once each way
    and no Kepler kernel; on AbsoluteVisual the Kepler kernel once (every
    chain's emission epochs) and no fused pair, the barycentre's nine
    release epochs being a propagation that solves no Kepler equation."""
    t0 = time.perf_counter()
    res = {}
    for basis in ("Visual{KepOrbit}", ABSOLUTE):
        model = build_g23h_example_model(ot, data, basis, device="cuda", dtype=torch.float64)
        ref = build_g23h_example_model(ot, data, basis, device="cpu", dtype=torch.float64)
        half = CHAINS // 2
        theta = torch.cat([_points_near(ref, g23h_example_point(ref), half, seed=13),
                           ref.link(ref.sample_priors(torch.Generator().manual_seed(14),
                                                      CHAINS - half))])
        out = _card_evaluation(f"g23h {basis}", kk, osk, model, ref, theta, aligned_ulps=True)
        expected = ({"kepler_solve": 1, "orbit_solve_fwd": 0, "orbit_solve_bwd": 0}
                    if basis == ABSOLUTE else
                    {"kepler_solve": 0, "orbit_solve_fwd": 1, "orbit_solve_bwd": 1})
        if any(out["launches"][k] != v for k, v in expected.items()):
            raise AssertionError(f"g23h {basis}: launches {out['launches']}, expected {expected}")
        out["n_epochs"] = model.n_epochs
        res[basis] = out
    res["seconds"] = time.perf_counter() - t0
    log(f"g23h evaluation phase: {res['seconds']:.2f} s")
    return res


def g23h_injection_phase(ot, kk, osk, data) -> dict:
    """tests/test_g23h.py:381's injection-recovery fit: the frozen-epoch model
    (D = 13) on the catalog that the port generates at the injected 40 Mjup
    companion with noise from numpy's seed 5 (`g23h_injected_row`, the CPU in
    float64), the float32 card model checked against a float64 CPU model,
    then `octofit` with initialization at CHAINS chains, ChEES,
    G23H_ADAPTATION + G23H_ITERATIONS, with the gates of `fit_phase` (the
    fused forward on every gradient evaluation, and no backward: the orbit
    is fixed) but R-hat's, and the JAX test's own: the pull of b_mass under 5, its relative error under 5%
    and its split-R-hat under 1.1."""
    t0 = time.perf_counter()
    row = g23h_injected_row(ot, data)
    model = build_g23h_model(ot, data, row=row, device="cuda", dtype=torch.float32)
    ref = build_g23h_model(ot, data, row=row, device="cpu", dtype=torch.float64)
    reference_phase("g23h injection", model, ref,
                    _points_near(ref, g23h_injection_truth(ref), 64, seed=16))
    res = fit_phase(ot, kk, osk, model, f"g23h injection ({G23H_ADAPTATION} + {G23H_ITERATIONS})",
                    CHAINS, G23H_ADAPTATION, G23H_ITERATIONS,
                    init_kwargs={"n_opt_steps": G23H_OPT_STEPS}, rhat_gate=False,
                    orbit_fixed=True)
    names = model.parameter_names
    k = names.index("b_mass")
    mass = np.asarray(res["chain"]["b_mass"]).ravel()
    mean, sd = float(mass.mean()), float(mass.std())
    truth = G23H_INJECTION["b_mass"]
    pull, rel, rhat = abs(mean - truth) / max(sd, 1e-6), abs(mean - truth) / truth, float(res["rhat"][k])
    log(f"  b_mass {mean:.4f} +- {sd:.4f} (injected {truth}): pull {pull:.3f} (limit 5), relative "
        f"error {rel:.4f} (limit 0.05), split-R-hat {rhat:.5f} (limit 1.1); max split-R-hat "
        f"{float(np.nanmax(res['rhat'])):.5f} on {names[int(np.nanargmax(res['rhat']))]}")
    if not (pull < 5.0 and rel < 0.05 and rhat < 1.1):
        raise AssertionError("g23h injection: the injected mass was not recovered")
    res["mass"] = (mean, sd)
    res["seconds"] = time.perf_counter() - t0
    log(f"g23h injection phase: {res['seconds']:.2f} s")
    return res


def g23h_pt_phase(ot, kk, osk, data) -> dict:
    """examples/06 through `octofit_pigeons`: its model (marginalized epochs,
    D = 98) in float32 on the card, checked against a float64 CPU model,
    `initialize` (G23H_OPT_STEPS Adam steps), then G23H_PT_ROUNDS rounds at
    G23H_PT_KWARGS, every launch count set to 0 just before the
    initialization. Gates: finite draws and log-evidence, swaps accepted on
    every pair between two annealed rungs (SWAP_REJECTION_MAX), the fused
    pair on every annealed evaluation and every components pass. Prints
    R-hat, the barriers and b_mass."""
    t0 = time.perf_counter()
    model = build_g23h_example_model(ot, data, device="cuda", dtype=torch.float32)
    ref = build_g23h_example_model(ot, data, device="cpu", dtype=torch.float64)
    reference_phase("g23h example", model, ref,
                    _points_near(ref, g23h_example_point(ref), 64, seed=17))
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kk, osk)
    t_init = time.perf_counter()
    model.initialize(gen, verbosity=1, n_opt_steps=G23H_OPT_STEPS)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    init_launches = _launches(kk, osk)
    chain, info = ot.octofit_pigeons(model, generator=gen, n_rounds=G23H_PT_ROUNDS, verbosity=1,
                                     **G23H_PT_KWARGS)
    torch.cuda.synchronize()
    launches = _launches(kk, osk)
    sampling = {k: launches[k] - init_launches[k] for k in launches}
    names = model.parameter_names
    x = np.stack([chain[n] for n in names], axis=-1)
    ess, rhat = ot.ess_rhat_batch_device(x)
    n_evals, n_sweeps, t_sampling = info["n_grad_evals"], info["n_sweeps"], info["sampling_time_s"]
    W = G23H_PT_KWARGS["n_walkers"]
    NT = G23H_PT_KWARGS["n_chains"] + G23H_PT_KWARGS["n_chains_variational"]
    mass = np.asarray(chain["b_mass"]).ravel()
    log(f"g23h PT (examples/06): {W} walkers x ({G23H_PT_KWARGS['n_chains']} + "
        f"{G23H_PT_KWARGS['n_chains_variational']}) rungs = {W * NT} rows, ChEES explorer capped at "
        f"{G23H_PT_KWARGS['explorer_n_leapfrog']}, {G23H_PT_ROUNDS} rounds ({n_sweeps} sweeps), "
        f"float32, D = {model.D}")
    for r in info["rounds"]:
        log(f"  round {r['round']}: {r['sweeps']} sweeps in {r['seconds']:.2f} s; barrier "
            f"{r['barrier']:.3f}, variational barrier {r['barrier_variational']:.3f}")
    log(f"  init {t_init:.2f} s, sampling {t_sampling:.2f} s; batched annealed gradient evaluations "
        f"{n_evals} ({t_sampling / n_evals * 1e6:.1f} us each, sweeps included), components "
        f"passes {n_sweeps}")
    log(f"  recorded draws {x.shape[0]} chains x {x.shape[1]}; max split-R-hat "
        f"{float(np.nanmax(rhat)):.5f} on {names[int(np.nanargmax(rhat))]}, b_mass split-R-hat "
        f"{float(rhat[names.index('b_mass')]):.5f}; min ESS {float(np.nanmin(ess)):.1f}")
    log(f"  log-evidence {info['logevidence']:.3f} (se {info['logevidence_se']:.3f}), barrier "
        f"{info['global_barrier']:.3f}, variational barrier {info['global_barrier_variational']:.3f}, "
        f"round trips {info['n_round_trips']}")
    log(f"  swap rejection {np.round(info['swap_rejection'], 4).tolist()}")
    log(f"  b_mass median {float(np.median(mass)):.4f} Mjup, 5-95% {float(np.percentile(mass, 5)):.4f}"
        f" - {float(np.percentile(mass, 95)):.4f}")
    log(f"  kernel launches: initialization {init_launches}, sampling {sampling}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not bool(np.isfinite(x).all()):
        raise AssertionError("g23h PT: non-finite draws")
    if not all(np.isfinite(info[k]) for k in
               ("logevidence", "global_barrier", "global_barrier_variational")):
        raise AssertionError("g23h PT: non-finite log-evidence or barrier")
    inner = [j for j in range(NT - 1) if j not in (0, G23H_PT_KWARGS["n_chains"] - 1, NT - 2)]
    worst = max(inner, key=lambda j: info["swap_rejection"][j])
    log(f"  swap rejection between annealed rungs at most {info['swap_rejection'][worst]:.4f} "
        f"(pair {worst}; limit {SWAP_REJECTION_MAX})")
    if not info["swap_rejection"][worst] < SWAP_REJECTION_MAX:
        raise AssertionError(f"g23h PT: swaps across pair {worst} were all but never accepted")
    if sampling["orbit_solve_fwd"] < n_evals + n_sweeps or sampling["orbit_solve_bwd"] < n_evals:
        raise AssertionError(f"g23h PT: the fused pair was launched {sampling} times, fewer than "
                             f"the {n_evals} evaluations (+ {n_sweeps} components passes)")
    res = {"launches": launches, "n_evals": n_evals, "t_init": t_init, "t_sampling": t_sampling,
           "rhat": float(np.nanmax(rhat)), "logevidence": info["logevidence"],
           "seconds": time.perf_counter() - t0}
    log(f"g23h PT phase: {res['seconds']:.2f} s")
    return res


def obs_prior_phase(ot, kk, osk, directory) -> dict:
    """The observable and stability priors with photometry
    (`build_obs_prior_model`, its Sonora grid written into `directory`): one
    float64 value-and-gradient at CHAINS points (the valid point, one row
    breaking each hard prior, 1,024 points near the valid one, prior draws)
    on the card, held to the CPU. Gates: the violation rows -inf with
    finite (zero) gradients, the valid ones finite, the fused pair once each
    way per planet."""
    t0 = time.perf_counter()
    sonora = write_sonora_grid(directory)
    table = bench_table(ot)
    model = build_obs_prior_model(ot, table, sonora, device="cuda", dtype=torch.float64)
    ref = build_obs_prior_model(ot, table, sonora, device="cpu", dtype=torch.float64)
    nat = obs_prior_points(ref)
    theta = torch.cat([ref.link(ref.tensor(nat)), _points_near(ref, nat[0], 1024, seed=18),
                       ref.link(ref.sample_priors(torch.Generator().manual_seed(19),
                                                  CHAINS - len(nat) - 1024))])
    out = _card_evaluation("observable priors", kk, osk, model, ref, theta)
    lp, g = out["lp"], out["g"]
    n_fin = int(torch.isfinite(lp).sum())
    log(f"  observable priors: rows 1-3 (crossing, order, Hill) {lp[1:4].tolist()}; "
        f"{n_fin} of {len(lp)} rows finite; gradients finite everywhere: "
        f"{bool(torch.isfinite(g).all())}")
    if (not bool(torch.isfinite(lp[[0, 4]]).all()) or bool(torch.isfinite(lp[1:4]).any())
            or not bool(torch.isfinite(g).all()) or not bool((g[~torch.isfinite(lp)] == 0).all())):
        raise AssertionError("observable priors: a violation row is finite or a gradient is not")
    expected = {"kepler_solve": 0, "orbit_solve_fwd": 2, "orbit_solve_bwd": 2}
    if any(out["launches"][k] != v for k, v in expected.items()):
        raise AssertionError(f"observable priors: launches {out['launches']}, expected {expected}")
    out["seconds"] = time.perf_counter() - t0
    log(f"observable-prior phase: {out['seconds']:.2f} s")
    return out


def g23h_phases(ot, kk, osk, elements, kepler_mod, kernel_step=True) -> dict:
    """The G23H evaluations, the injection fit, examples/06 through PT and
    the observable priors (their files in a temporary directory), then,
    with `kernel_step`, `g23h_kernel_step`."""
    import tempfile

    t0 = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as directory:
        data = g23h_data(directory)
        res["eval"] = g23h_evaluation_phase(ot, kk, osk, data)
        res["fit"] = g23h_injection_phase(ot, kk, osk, data)
        res["pt"] = g23h_pt_phase(ot, kk, osk, data)
        res["obs"] = obs_prior_phase(ot, kk, osk, directory)
    if kernel_step:
        g23h_kernel_step(kk, osk, elements, kepler_mod, res)
    res["seconds"] = time.perf_counter() - t0
    log(f"g23h and observable-prior phases: {res['seconds']:.2f} s")
    return res


def g23h_kernel_step(kk, osk, elements, kepler_mod, res) -> None:
    """The standalone Kepler kernel held to its twin at the shape the
    AbsoluteVisual G23H evaluation of `res` launched it with (float64), and
    the fused pair against its plain versions at (CHAINS, 140) in float64
    (the evaluations) and float32 (the fits); the rows go into `res`."""
    t_step = time.perf_counter()
    res["kepler_shapes"] = res["eval"][ABSOLUTE]["kepler_shapes"]
    res["kepler"] = kepler_path_phase(kk, kepler_mod, res["kepler_shapes"], (torch.float64,))
    n_epochs = res["eval"][ABSOLUTE]["n_epochs"]
    res["shape"] = f"({CHAINS}, {n_epochs})"
    res["pair"] = orbit_shapes_phase(osk, elements, ((res["shape"], CHAINS, n_epochs, G23H_SPAN,
                                                      None),), (torch.float32, torch.float64))
    log(f"g23h kernel step: {time.perf_counter() - t_step:.2f} s")


def g23h_kernel_keys(kernels, res) -> None:
    """The G23H and observable-prior paths' entries of the `kernels` line:
    every kernel's launches on each (`g23h_launches` by basis for one
    evaluation, `g23h_fit_launches`, `g23h_pt_launches`,
    `obs_prior_launches`); the Kepler kernel at the AbsoluteVisual
    evaluation's shape (float64) and the fused pair at (CHAINS, 140) in
    float64 under `g23h_*` and in float32 under `g23h_f32_*`."""
    f32, f64 = torch.float32, torch.float64
    for k in kernels:
        name = k["name"]
        k["g23h_launches"] = {b: res["eval"][b]["launches"].get(name, 0)
                              for b in ("Visual{KepOrbit}", ABSOLUTE)}
        k["g23h_fit_launches"] = res["fit"]["launches"].get(name, 0)
        k["g23h_pt_launches"] = res["pt"]["launches"].get(name, 0)
        k["obs_prior_launches"] = res["obs"]["launches"].get(name, 0)
        if name == "kepler_solve":
            shape = max(res["kepler_shapes"], key=lambda s: int(np.prod(s)))
            row = res["kepler"][(shape, f64)]
            bnd = bound_ms(24 * row["n"], OPS_KEPLER * row["n"], f64)
            k.update({"g23h_shape": str(shape), "g23h_dtype": "float64",
                      "g23h_max_abs_err": row["err"], "g23h_ms": row["ms"],
                      "g23h_plain_ms": row["plain_ms"], "g23h_bound_ms": bnd[0],
                      "g23h_bound_by": bnd[1]})
        elif name.startswith("orbit_solve"):
            part = name.removeprefix("orbit_solve_")
            b = CHAINS
            t = res["eval"][ABSOLUTE]["n_epochs"]
            words = 8 * b + t + 14 * b * t if part == "fwd" else 8 * b + t + 15 * b * t + 8 * b
            ops = (OPS_ORBIT_FWD if part == "fwd" else OPS_ORBIT_BWD) * b * t
            for key, dtype in (("g23h", f64), ("g23h_f32", f32)):
                row = res["pair"][part][(res["shape"], dtype)]
                bnd = bound_ms(dtype.itemsize * words, ops, dtype)
                k.update({f"{key}_shape": res["shape"], f"{key}_dtype": str(dtype).removeprefix("torch."),
                          f"{key}_max_abs_err": row["err"], f"{key}_ms": row["ms"],
                          f"{key}_plain_ms": row["plain_ms"], f"{key}_bound_ms": bnd[0],
                          f"{key}_bound_by": bnd[1]})


# examples/05's fits (phase 27), the likelihood-map and GRAVITY evaluations
# (28) and the kernels at their shapes (29). The interferometry fit is also
# held to its posterior computed on a grid without the port's likelihood
# (`ex05_if_reference`): five closure phases at an SNR near 2 leave fringe
# aliases of a within a few nats of one another, so on the example's data
# the posterior's main mode lies at a = 11.05 (a CPU grid over the prior;
# 64% of the mass within 10.8-11.3 AU, 2.6% within 0.2 AU of the true 12),
# and with the closure phases' sign flipped at a = 10.95 with a contrast
# near 0.023: the injected values alone do not tell the two apart. The
# reference does: means within EX05_IF_REF_SD of its standard deviations
# over a window of +-EX05_IF_WINDOW AU around the chains' median.
EX05_IF_WINDOW, EX05_IF_REF_SD = 0.15, 4.0
# Float32 rounds the light curve's epochs near MJD 57000 by up to 1.9e-3 d
# (its step is 3.9e-3 d), a sixth of the 0.0115 d ingress: at the injected
# radius ratio the float32 model's ln_post is 147 nats below float64's (on
# the CPU). The transit runs in float64.
EX05_DTYPE = {"image": torch.float32, "interferometry": torch.float32,
              "transit": torch.float64}
# The initialization: the config's defaults, the transit with the example's
# 64 multistarts of 300 steps and 10,000 prior draws (the config's 100,000,
# each over 120 epochs x 64 nodes, took the run to 59.4 GiB of the card)
EX05_INIT = {"image": None, "interferometry": None,
             "transit": dict(n_multistart=64, n_opt_steps=300, n_prior_samples=10_000)}
EX05_FAULTS = {"image": ("image_ra_sign",), "interferometry": ("cp_sign",), "transit": ()}


def ex05_if_reference(ot, oifits, a_mid) -> dict:
    """The interferometry fit's posterior without the port's likelihood:
    on a grid of a (601 points over a_mid +- EX05_IF_WINDOW, inside the
    prior) x log f (240 cells over the LogUniform prior, where its density
    is flat), the closure phases of host and companion at each a's
    position (the port's orbitsolve, float64, CPU) in numpy, with the
    example's Gaussian likelihood. Returns the posterior means and standard
    deviations of b_a and b_gravity_f over the window."""
    from octofitter_tpu_torch.interferometry.oifits import load_oifits

    row = load_oifits(oifits, use_vis2=False)
    a = np.linspace(a_mid - EX05_IF_WINDOW, a_mid + EX05_IF_WINDOW, 601)
    a = a[(a > 5.0) & (a < 20.0)]
    edges = np.linspace(np.log(1e-3), np.log(1e-1), 241)
    f = np.exp((edges[1:] + edges[:-1]) / 2)
    orbit = ot.VisualOrbit.from_params(**{k: np.full(len(a), v) for k, v in EX05_TRUE.items()
                                          if k != "a"}, a=a, device="cpu")
    sol = ot.orbitsolve(orbit, np.array([row["epoch"]]))
    ra = ot.orbits.raoff(sol).numpy()[:, 0]
    dec = ot.orbits.decoff(sol).numpy()[:, 0]
    mas = 1.0 / (ot.constants.RAD2AS * 1000.0)
    arg = -2 * np.pi * (row["u"] * ra[:, None, None] + row["v"] * dec[:, None, None]) * mas
    re = 1.0 + f[None, :, None, None] * np.cos(arg)[:, None]
    im = f[None, :, None, None] * np.sin(arg)[:, None]
    phi = np.degrees(np.arctan2(im, re))
    cp = (phi[..., row["index_cps1"], :] + phi[..., row["index_cps2"], :]
          - phi[..., row["index_cps3"], :])
    ll = np.sum(-0.5 * (row["cps_data"] - cp) ** 2 / row["dcps"] ** 2, axis=(-2, -1))
    p = np.exp(ll - ll.max())
    p /= p.sum()
    pa, pf = p.sum(axis=1), p.sum(axis=0)
    out = {}
    for name, x, px in (("b_a", a, pa), ("b_gravity_f", f, pf)):
        mean = float((px * x).sum())
        out[name] = (mean, float(np.sqrt((px * (x - mean) ** 2).sum())))
    return out


def ex05_gates(ot, label, chain, oifits=None) -> tuple[bool, dict]:
    """(passed, numbers): each free parameter's posterior mean within
    EX05_GATES of the injected value; for the interferometry fit also
    within EX05_IF_REF_SD standard deviations of `ex05_if_reference`."""
    ok, out = True, {}
    truth = EX05_TRUTH[label]
    for name, tol in EX05_GATES[label].items():
        v = np.asarray(chain[name]).reshape(-1)
        mean, sd = float(v.mean()), float(v.std())
        out[name] = {"mean": mean, "sd": sd, "truth": truth[name], "tol": tol}
        ok &= abs(mean - truth[name]) <= tol
    if oifits is not None:
        ref = ex05_if_reference(ot, oifits, float(np.median(chain["b_a"])))
        for name, (mean, sd) in ref.items():
            out[name].update(ref_mean=mean, ref_sd=sd)
            ok &= abs(out[name]["mean"] - mean) <= EX05_IF_REF_SD * sd
    return bool(ok), out


def _log_gates(label, passed, numbers) -> None:
    for name, g in numbers.items():
        ref = (f"; reference {g['ref_mean']:.5f} +- {g['ref_sd']:.5f} ({EX05_IF_REF_SD:g} sd)"
               if "ref_mean" in g else "")
        log(f"  {label}: {name} mean {g['mean']:.5f}, sd {g['sd']:.5f} (injected {g['truth']}, "
            f"tol {g['tol']}){ref}")
    log(f"  {label}: recovery gates {'passed' if passed else 'failed'}")


def ex05_quadrature_profile(evaluation, dtype) -> dict:
    """The transit's limb-darkened quadrature alone (`transit_depth` over
    (CHAINS, 120, 64) and its gradient in b and r) at the fit's shape:
    device operations and device time per call, and its share of the
    device time of one evaluation of the model (`evaluation`, from
    `evaluation_profile`)."""
    from octofitter_tpu_torch.transits import QuadLimbDark, transit_depth

    rng = np.random.default_rng(29)
    shape = (CHAINS, EX05_TRANSIT["n"])
    b = torch.as_tensor(rng.uniform(0.0, 1.3, shape), dtype=dtype, device="cuda")
    b.requires_grad_(True)
    r = torch.full((CHAINS, 1), EX05_TRANSIT["r"], dtype=dtype, device="cuda", requires_grad=True)
    front = torch.ones(shape, dtype=torch.bool, device="cuda")
    ld = QuadLimbDark(EX05_TRANSIT["u1"], EX05_TRANSIT["u2"])
    fn = lambda: torch.autograd.grad(transit_depth(ld, b, r, front).sum(), (b, r))  # noqa: E731
    dev_ms, host_ms = _time_both(fn, 10)
    ops, busy = _device_ops_per_call(fn)
    share = busy / evaluation["busy_us"] if busy and evaluation["busy_us"] else None
    log(f"  transit quadrature at {shape} x 64 nodes, value and gradient: {host_ms * 1e3:.1f} us "
        f"on the host clock, {dev_ms * 1e3:.1f} us by CUDA events, {ops} device ops and "
        f"{busy} us of device time per call; "
        f"{f'{share:.3f}' if share is not None else 'not measured'} of an evaluation's "
        f"device time")
    return {"us": host_ms * 1e3, "device_us": dev_ms * 1e3, "ops": ops, "busy_us": busy,
            "share": share}


def ex05_fit_phase(ot, kk, osk, label, build, arg, oifits=None) -> dict:
    """One of examples/05's fits on the card in EX05_DTYPE: the model against
    a float64 CPU model at 64 prior draws, then `octofit` with initialization
    at CHAINS chains (`fit_phase`, its R-hat and launch gates), the recovery
    gates (`ex05_gates`) and one batched evaluation's profile at CHAINS
    prior draws; then each planted fault of EX05_FAULTS fitted the same way
    at EX05_FAULT_CHAINS chains, which must fail the recovery gates."""
    t0 = time.perf_counter()
    dtype = EX05_DTYPE[label]
    model = build(ot, arg, device="cuda", dtype=dtype)
    ref = build(ot, arg, device="cpu", dtype=torch.float64)
    gen = torch.Generator().manual_seed(27)
    reference_phase(f"examples/05 {label}", model, ref,
                    ref.link(ref.sample_priors(gen, 64)))
    res = fit_phase(ot, kk, osk, model, f"examples/05 {label}", CHAINS, EX05_ADAPTATION,
                    EX05_ITERATIONS, init_kwargs=EX05_INIT[label] or {},
                    max_depth=EX05_MAX_DEPTH, orbit_fixed=label == "transit")
    passed, res["gates"] = ex05_gates(ot, label, res["chain"], oifits)
    _log_gates(label, passed, res["gates"])
    if not passed:
        raise AssertionError(f"examples/05 {label}: a posterior mean missed its gate")
    theta = ref.link(ref.sample_priors(gen, CHAINS)).to("cuda", dtype)
    res["profile"] = evaluation_profile(f"examples/05 {label}", model, theta)
    if label == "transit":
        res["quadrature"] = ex05_quadrature_profile(res["profile"], dtype)
    res["faults"] = {}
    for fault in EX05_FAULTS[label]:
        with ex05_planted_fault(fault):
            faulty = build(ot, arg, device="cuda", dtype=dtype)
            fres = fit_phase(ot, kk, osk, faulty, f"examples/05 {label}, planted fault {fault}",
                             EX05_FAULT_CHAINS, EX05_FAULT_ADAPTATION, EX05_FAULT_ITERATIONS,
                             init_kwargs=EX05_INIT[label] or {}, rhat_gate=False,
                             max_depth=EX05_FAULT_MAX_DEPTH)
            passed, numbers = ex05_gates(ot, label, fres["chain"], oifits)
        _log_gates(f"{label}, planted fault {fault}", passed, numbers)
        if passed:
            raise AssertionError(f"examples/05 {label}: the planted fault {fault} passed the gates")
        res["faults"][fault] = {"gates": numbers, "launches": fres["launches"]}
    res["seconds"] = time.perf_counter() - t0
    log(f"examples/05 {label} phase: {res['seconds']:.2f} s")
    return res


def ex05_evaluation_phase(ot, kk, osk) -> dict:
    """One float64 value-and-gradient at CHAINS prior draws of the
    likelihood-map model and of the GRAVITY model on the card, held to the
    CPU (`_card_evaluation`). Gates: finite gradients everywhere, zero ones
    on -inf rows; GRAVITY has rows whose covariance is not positive
    definite (-inf), the map rows off it (the fill value); the fused pair
    once each way, no Kepler launch."""
    t0 = time.perf_counter()
    res = {}
    for label, build, data in (("likelihood map", build_llmap_model, llmap_data(ot)),
                               ("GRAVITY", build_gravity_model, gravity_data(ot))):
        model = build(ot, data, device="cuda", dtype=torch.float64)
        ref = build(ot, data, device="cpu", dtype=torch.float64)
        theta = ref.link(ref.sample_priors(torch.Generator().manual_seed(28), CHAINS))
        out = _card_evaluation(label, kk, osk, model, ref, theta)
        lp, g = out["lp"], out["g"]
        bad = ~torch.isfinite(lp)
        filled = int((lp <= -1e4 + 0.5).sum()) if label == "likelihood map" else 0
        log(f"  {label}: {int(bad.sum())} rows -inf, {filled} rows at the fill value; "
            f"gradients finite everywhere: {bool(torch.isfinite(g).all())}")
        if not bool(torch.isfinite(g).all()) or not bool((g[bad] == 0).all()):
            raise AssertionError(f"{label}: a gradient is not finite, or a -inf row's not zero")
        if (label == "GRAVITY") != bool(bad.any()) or (label == "likelihood map") != (filled > 0):
            raise AssertionError(f"{label}: the gated rows are not where they should be")
        expected = {"kepler_solve": 0, "orbit_solve_fwd": 1, "orbit_solve_bwd": 1}
        if any(out["launches"][k] != v for k, v in expected.items()):
            raise AssertionError(f"{label}: launches {out['launches']}, expected {expected}")
        out["n_epochs"] = model.n_epochs
        res[label] = out
    res["seconds"] = time.perf_counter() - t0
    log(f"likelihood-map and GRAVITY evaluations: {res['seconds']:.2f} s")
    return res


def ex05_phases(ot, kk, osk) -> dict:
    """examples/05's three fits, then the two evaluations; the data files in
    a temporary directory."""
    import tempfile

    t0 = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as directory:
        data = ex05_data(ot, directory)
        res["image"] = ex05_fit_phase(ot, kk, osk, "image", build_image_model, data["image"])
        res["interferometry"] = ex05_fit_phase(ot, kk, osk, "interferometry",
                                               build_interferometry_model, data["oifits"],
                                               oifits=data["oifits"])
        res["transit"] = ex05_fit_phase(ot, kk, osk, "transit", build_transit_model,
                                        data["lightcurve"])
    res["eval"] = ex05_evaluation_phase(ot, kk, osk)
    res["seconds"] = time.perf_counter() - t0
    log(f"examples/05 phases: {res['seconds']:.2f} s")
    return res


EX05_FITS = ("image", "interferometry", "transit")


def ex05_kernel_step(kk, osk, elements, kepler_mod, res) -> None:
    """The standalone Kepler kernel held to its twin at the shapes each
    fit's Laplace step launched it with, in the fit's dtype, and the fused
    pair against its plain versions at the image's and interferometry's
    (CHAINS, 1) (float32, and float64 for GRAVITY), the map's (CHAINS, 2)
    and the transit's (CHAINS, 120) (float64); the rows go into `res`."""
    t_step = time.perf_counter()
    res["kepler"] = {label: kepler_path_phase(kk, kepler_mod, res[label]["kepler_shapes"],
                                              (EX05_DTYPE[label],))
                     for label in EX05_FITS if label in res}
    t_mid = EX05_TRANSIT["tp"] - 0.932
    one = (EX05_IMAGE["epoch"], EX05_IMAGE["epoch"])
    res["pair"] = orbit_shapes_phase(osk, elements, ((f"({CHAINS}, 1)", CHAINS, 1, None, one),),
                                     (torch.float32,))
    res["pair64"] = orbit_shapes_phase(osk, elements, (
        (f"({CHAINS}, 1)", CHAINS, 1, None, one),
        (f"({CHAINS}, 2)", CHAINS, 2, None, LLMAP["epochs"]),
        (f"({CHAINS}, {EX05_TRANSIT['n']})", CHAINS, EX05_TRANSIT["n"], None,
         (t_mid - 0.15, t_mid + 0.15))), (torch.float64,))
    log(f"examples/05 kernel step: {time.perf_counter() - t_step:.2f} s")


def ex05_kernel_keys(kernels, res) -> None:
    """The examples/05 paths' entries of the `kernels` line: every kernel's
    launches on each (`ex05_launches`: the three fits, their planted-fault
    fits, one evaluation of the map and of GRAVITY); the Kepler kernel at
    each fit's Laplace shapes (`ex05_kepler`, by fit), the fused pair at
    (CHAINS, 1) in float32 (`ex05_*`) and at (CHAINS, 1), (CHAINS, 2) and
    (CHAINS, 120) in float64 (`ex05_f64_*`, `ex05_map_*`,
    `ex05_transit_*`)."""
    f32, f64 = torch.float32, torch.float64
    for k in kernels:
        name = k["name"]
        fits = [label for label in EX05_FITS if label in res]
        launches = {label: res[label]["launches"].get(name, 0) for label in fits}
        for label in fits:
            for fault, fres in res[label]["faults"].items():
                launches[fault] = fres["launches"].get(name, 0)
        for label in ("likelihood map", "GRAVITY") if "eval" in res else ():
            launches[label] = res["eval"][label]["launches"].get(name, 0)
        k["ex05_launches"] = launches
        if name == "kepler_solve":
            k["ex05_kepler"] = {}
            for label in res["kepler"]:
                dtype = EX05_DTYPE[label]
                shape = max(res[label]["kepler_shapes"], key=lambda s: int(np.prod(s)))
                row = res["kepler"][label][(shape, dtype)]
                bnd = bound_ms(3 * dtype.itemsize * row["n"], OPS_KEPLER * row["n"], dtype)
                k["ex05_kepler"][label] = {
                    "shape": str(shape), "dtype": str(dtype).removeprefix("torch."),
                    "max_abs_err": row["err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": bnd[0], "bound_by": bnd[1]}
        elif name.startswith("orbit_solve"):
            part = name.removeprefix("orbit_solve_")
            for key, pair, t, dtype in (("ex05", "pair", 1, f32),
                                        ("ex05_f64", "pair64", 1, f64),
                                        ("ex05_map", "pair64", 2, f64),
                                        ("ex05_transit", "pair64", EX05_TRANSIT["n"], f64)):
                b = CHAINS
                shape = f"({b}, {t})"
                words = 8 * b + t + 14 * b * t if part == "fwd" else 8 * b + t + 15 * b * t + 8 * b
                ops = (OPS_ORBIT_FWD if part == "fwd" else OPS_ORBIT_BWD) * b * t
                row = res[pair][part][(shape, dtype)]
                bnd = bound_ms(dtype.itemsize * words, ops, dtype)
                k.update({f"{key}_shape": shape, f"{key}_dtype": str(dtype).removeprefix("torch."),
                          f"{key}_max_abs_err": row["err"], f"{key}_ms": row["ms"],
                          f"{key}_plain_ms": row["plain_ms"], f"{key}_bound_ms": bnd[0],
                          f"{key}_bound_by": bnd[1]})


# Evidence and validation (phases 30-34): nested sampling against a grid
# quadrature (examples/10's model) and on examples/04's two models,
# cross-validation on the main path's chain, simulation-based calibration
# (examples/10) and a completeness map (examples/11 on a synthetic scan
# law), and the Gaia NSS warm start of the headline fit.
EX10_TRUE = dict(a=10.0, e=0.15, i=0.6, omega=1.0, Omega=2.0, tp=57000.0, M=1.2, plx=50.0)
EX04_TRUE = dict(a=10.0, e=0.25, i=0.6, omega=1.0, Omega=2.0, tp=57000.0, M=1.2, plx=50.0)
EX10_SPAN = EX04_SPAN = (56000.0, 58000.0)
EX10_EPOCHS, EX04_EPOCHS = 6, 12
# phase 30: the grid's points per axis (over the prior box of a and e) and
# the nested run; phase 31: examples/04's live points and generator seeds
GRID_POINTS = 1000
NESTED_LIVE, NESTED_STEPS = 4096, 20
EX04_LIVE, EX04_SEEDS = 600, (31, 32)
# phase 32: draws of the main chain held in float64 to the CPU
CV_SUBSET = 256
# phase 33: examples/10's SBC and examples/11's --fast grid with their
# samplers, cut: ChEES capped at 2^6 leapfrog steps (each SBC fit starts its
# 8 chains at one point, so the starting metric is 1e-8 I, and at the
# default cap of 2^10 the trajectories run to it: 3 trials took ~770 s on
# the card) and the example's 300 + 200 and 250 + 250 halved for the
# smoke's time (8 trials and 4 maps took 282.6 and 192.6 s at full length
# alone on the card; `scripts/evidence_probe.py`)
SBC_TRIALS = 8
SBC_KWARGS = dict(sampler="chees", chains=8, adaptation=150, iterations=100, max_depth=6)
COMPLETENESS_MASSES, COMPLETENESS_SEPARATIONS = (2.0, 20.0), (1.0, 5.0)
# examples/11's 8 starting points are one point too, so its starting
# metric is the identity against posterior scales from 0.01 mas/yr to AU
COMPLETENESS_FIT = dict(chains=16, adaptation=125, iterations=125, max_depth=6)
COMPLETENESS_SCANS = 70
# examples/11's UEVA-single noise (completeness_trial.jl:30-33) and DR4's
# reference epoch (J2017.5)
COMPLETENESS_SIGMA = float(np.sqrt(3 * 0.04**2))
COMPLETENESS_REF_EPOCH = 57936.375
# phase 34: the fit from the NSS starting points, the free periastron
# epoch's prior (MJD; the orbit's period is ~6,170 days) and the
# pseudo-chain. The 64 starting points differ in M alone, so the dense
# starting metric is their covariance plus 1e-8 jitter: at 100 or 200
# adaptation steps the chains had not mixed (max split-R-hat 2.6 and 1.6 at
# 512 chains on the CPU, `scripts/nss_warm_start.py`), at 300 they had
NSS_ADAPTATION, NSS_ITERATIONS, NSS_DRAWS = 300, 100, 10_000
NSS_TP_PRIOR = (54000.0, 60500.0)
# the synthetic NSS row's quoted errors
NSS_ERRORS = dict(a_thiele_innes=0.5, b_thiele_innes=0.5, f_thiele_innes=0.5,
                  g_thiele_innes=0.5, eccentricity=0.01, parallax=0.05, period=20.0,
                  t_periastron=20.0)


def astrom_table(ot, true, span, n, sigma, seed) -> dict:
    """Relative astrometry at `n` epochs evenly over `span` (MJD) of the
    orbit `true`, with Gaussian noise `sigma` (mas) from numpy's seed
    `seed`, simulated with the port's orbitsolve in float64 on the CPU."""
    rng = np.random.default_rng(seed)
    epochs = np.linspace(*span, n)
    sol = ot.orbitsolve(ot.VisualOrbit.from_params(**true, device="cpu"), epochs)
    return dict(epoch=epochs,
                ra=ot.orbits.raoff(sol).numpy() + rng.standard_normal(n) * sigma,
                dec=ot.orbits.decoff(sol).numpy() + rng.standard_normal(n) * sigma,
                σ_ra=np.full(n, sigma), σ_dec=np.full(n, sigma))


def ex10_table(ot) -> dict:
    """examples/10's data: 6 epochs at 2 mas, numpy seed 0."""
    return astrom_table(ot, EX10_TRUE, EX10_SPAN, EX10_EPOCHS, 2.0, 0)


def build_ex10_model(pkg, table, **model_kw):
    """examples/10's model (D = 2: a ~ U(8, 12), e ~ U(0, 0.3), the rest
    fixed) with either package."""
    d = pkg.distributions
    astrom = pkg.PlanetRelAstromObs(table, name="simdata")
    b = pkg.Planet(name="b", basis="Visual{KepOrbit}",
                   variables=dict(a=d.Uniform(8.0, 12.0), e=d.Uniform(0.0, 0.3), i=0.6,
                                  omega=1.0, Omega=2.0, tp=57000.0),
                   observations=[astrom])
    system = pkg.System(name="sbc_demo", variables=dict(M=1.2, plx=50.0), companions=[b])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def ex04_table(ot) -> dict:
    """examples/04's data: 12 epochs at 1 mas, numpy seed 1."""
    return astrom_table(ot, EX04_TRUE, EX04_SPAN, EX04_EPOCHS, 1.0, 1)


def build_ex04_model(pkg, table, eccentric, **model_kw):
    """examples/04's eccentric (e ~ U(0, 0.9)) or circular (e = 1e-4) model
    with either package."""
    d = pkg.distributions
    astrom = pkg.PlanetRelAstromObs(table, name="astrom")
    b = pkg.Planet(
        name="b", basis="Visual{KepOrbit}",
        variables=dict(
            a=d.Uniform(0.001, 100.0), e=d.Uniform(0.0, 0.9) if eccentric else 1e-4,
            i=d.Sine(), omega=pkg.UniformCircular(), Omega=pkg.UniformCircular(),
            theta=pkg.UniformCircular(),
            tp=lambda sys, pl: pkg.theta_at_epoch_to_tperi(
                pl.theta, 57000.0, M=sys.M, e=pl.e, a=pl.a, i=pl.i, omega=pl.omega,
                Omega=pl.Omega)),
        observations=[astrom])
    system = pkg.System(
        name="ecc" if eccentric else "circ",
        variables=dict(M=d.truncated(d.Normal(1.2, 0.1), lower=0.1),
                       plx=d.truncated(d.Normal(50.0, 0.02), lower=0.1)),
        companions=[b])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def build_completeness_model(pkg, gost_csv, **model_kw):
    """examples/11's model (D = 16) with either package, on the scan law of
    the GOST file `gost_csv` (the example's DR4 forecast is not in the
    repository: `synth_gost_csv` writes one)."""
    from importlib import import_module

    d = pkg.distributions
    gost = import_module(f"{pkg.__name__}.astrom.scanlaw").load_gost_csv(gost_csv)
    n = len(gost["epoch"])
    table = dict(epoch=gost["epoch"], scan_pos_angle=gost["scanAngle_rad"],
                 centroid_pos_al=np.zeros(n), centroid_pos_error_al=np.full(n, COMPLETENESS_SIGMA),
                 parallax_factor_al=gost["parallaxFactorAlongScan"], outlier_flag=np.zeros(n))
    ref = float(np.mean(table["epoch"]))
    gaia = pkg.GaiaDR4AstromObs(
        table, gaia_id=0, name="GaiaDR4",
        variables=dict(astrometric_jitter=d.LogUniform(1e-5, 10.0),
                       ra_offset_mas=d.Normal(0.0, 100.0), dec_offset_mas=d.Normal(0.0, 100.0),
                       pmra=d.Uniform(-1000.0, 1000.0), pmdec=d.Uniform(-1000.0, 1000.0),
                       plx=lambda sys, obs: sys.plx, ref_epoch=COMPLETENESS_REF_EPOCH))
    b = pkg.Planet(
        name="b", basis="Visual{KepOrbit}",
        variables=dict(
            a=d.LogUniform(0.1, 100.0), e=d.Uniform(0.0, 0.99), omega=pkg.UniformCircular(),
            i=d.Sine(), Omega=pkg.UniformCircular(), theta=pkg.UniformCircular(),
            tp=lambda sys, pl: pkg.theta_at_epoch_to_tperi(
                pl.theta, ref, M=sys.M, e=pl.e, a=pl.a, i=pl.i, omega=pl.omega, Omega=pl.Omega),
            mass=d.LogUniform(0.01, 1000.0)))
    system = pkg.System(
        name="DR4_completeness",
        variables=dict(M_pri=1.0, plx=d.truncated(d.Normal(50.0, 0.5), lower=0.1),
                       M=lambda s: s.M_pri),
        companions=[b], observations=[gaia])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def completeness_detection(chain, theta_true) -> bool:
    """examples/11's criterion (completeness_trial.jl:137-146): the mass
    median within 3x of the truth and the 5th percentile above 0.1 Mjup."""
    m = np.asarray(chain["b_mass"]).ravel()
    med, low = np.median(m), np.quantile(m, 0.05)
    true_mass = float(theta_true.planets["b"].mass)
    return bool(true_mass / 3 < med < true_mass * 3 and low > 0.1)


def nss_row(ot) -> dict:
    """A Gaia DR3 NSS two-body row of the headline truth: Thiele-Innes
    constants of a = 7 AU at plx 50 and its angles, its eccentricity,
    period and periastron (a JD offset from NSS_DR3_T_PERIASTRON_REF_JD),
    with the quoted errors NSS_ERRORS."""
    from octofitter_tpu_torch.orbits.elements import _thiele_innes_unit

    t = {k: torch.tensor(v, dtype=torch.float64) for k, v in TRUE.items()}
    alpha = TRUE["a"] * TRUE["plx"]
    A, B, F, G = (float(alpha * x) for x in _thiele_innes_unit(ot.orbits.VisualOrbit(**t)))
    row = dict(source_id=1234567890123, nss_solution_type="Orbital", a_thiele_innes=A,
               b_thiele_innes=B, f_thiele_innes=F, g_thiele_innes=G,
               eccentricity=TRUE["e"], parallax=TRUE["plx"],
               period=math.sqrt(TRUE["a"] ** 3 / TRUE["M"]) * ot.constants.KEPLER_YEAR_DAYS,
               t_periastron=ot.constants.mjd2jd(TRUE["tp"]) - ot.nss.NSS_DR3_T_PERIASTRON_REF_JD)
    row.update({f"{k}_error": v for k, v in NSS_ERRORS.items()})
    return row


def ex10_grid(model, n=GRID_POINTS) -> dict:
    """examples/10's evidence and posterior by quadrature: the midpoints of
    an n x n grid over the prior box a in (8, 12), e in (0, 0.3), where the
    prior density is flat, through `model`'s composed path (`fused=False`)
    in chunks. Returns logZ, the information H and the means and standard
    deviations of b_a and b_e."""
    a = 8.0 + 4.0 * (np.arange(n) + 0.5) / n
    e = 0.3 * (np.arange(n) + 0.5) / n
    ga, ge = np.meshgrid(a, e, indexing="ij")
    cols = {"b_a": ga.ravel(), "b_e": ge.ravel()}
    pts = np.stack([cols[name] for name in model.parameter_names], axis=-1)
    ll = []
    with torch.no_grad():
        for lo in range(0, len(pts), 2**17):
            theta = model.tensor(pts[lo: lo + 2**17])
            ll.append(model.ln_like_nt(model.arr2nt(theta), fused=False).double().cpu())
    ll = torch.cat(ll).numpy()
    top = ll.max()
    w = np.exp(ll - top)
    logz = float(np.log(w.sum()) + top - np.log(len(ll)))
    w /= w.sum()
    out = {"logz": logz, "information": float(np.sum(w * ll) - logz), "points": len(ll)}
    for name, x in cols.items():
        mean = float(np.sum(w * x))
        out[name] = (mean, float(np.sqrt(np.sum(w * (x - mean) ** 2))))
    return out


def _nested_run(ot, kk, osk, label, model, seed, n_live) -> dict:
    """`octofit_nested` on `model` with a generator seeded `seed` on the
    card, every launch count set to 0 just before and read just after;
    gates: a finite logZ, the fused forward at least n_iterations x
    NESTED_STEPS times (every walker step), the fused backward never."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _reset_launches(kk, osk)
    t0 = time.perf_counter()
    chain, info = ot.samplers.octofit_nested(model, generator=gen, n_live=n_live,
                                             n_mcmc_steps=NESTED_STEPS, verbosity=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches(kk, osk)
    n_it = info["n_iterations"]
    acc = info["acceptance"]
    log(f"{label}: logZ {info['logz']:.5f}, information {info['information']:.4f} nats, "
        f"{n_it} iterations, {info['n_dead']} dead points, {seconds:.2f} s "
        f"({seconds / n_it * 1e3:.1f} ms per iteration, "
        f"{seconds / (n_it * NESTED_STEPS) * 1e3:.2f} ms per walker step), acceptance "
        f"mean {float(acc.mean()):.3f} (first {acc[0]:.3f}, last {acc[-1]:.3f}); "
        f"launches {launches}")
    if not np.isfinite(info["logz"]):
        raise AssertionError(f"{label}: logZ is not finite")
    if launches["orbit_solve_fwd"] < n_it * NESTED_STEPS or launches["orbit_solve_bwd"]:
        raise AssertionError(f"{label}: launches {launches}; expected the fused forward at least "
                             f"{n_it * NESTED_STEPS} times and no backward")
    return {"chain": chain, "info": info, "seconds": seconds, "launches": launches}


def nested_evidence_phase(ot, kk, osk) -> dict:
    """Phase 30: examples/10's model in float64, held to the CPU at 64
    prior draws; its evidence and posterior by quadrature (`ex10_grid` on
    the CPU model, so that neither the sampler nor a kernel enters it);
    then `octofit_nested` at NESTED_LIVE live points on the card. Gates:
    |logZ - logZ_grid| <= max(0.15, 4 sqrt(H / n_live)) with the run's H,
    the means of b_a and b_e within 0.1 posterior sd of the grid's, and
    `_nested_run`'s."""
    t0 = time.perf_counter()
    table = ex10_table(ot)
    model = build_ex10_model(ot, table, device="cuda", dtype=torch.float64)
    ref = build_ex10_model(ot, table, device="cpu", dtype=torch.float64)
    gen = torch.Generator().manual_seed(30)
    reference_phase("examples/10", model, ref, ref.link(ref.sample_priors(gen, 64)))
    t_grid = time.perf_counter()
    grid = ex10_grid(ref)
    t_grid = time.perf_counter() - t_grid
    log(f"examples/10 grid: {grid['points']} points in {t_grid:.2f} s: logZ {grid['logz']:.5f}, "
        f"H {grid['information']:.4f}, b_a {grid['b_a'][0]:.5f} +- {grid['b_a'][1]:.5f}, "
        f"b_e {grid['b_e'][0]:.5f} +- {grid['b_e'][1]:.5f}")
    res = _nested_run(ot, kk, osk, "nested, examples/10", model, 30, NESTED_LIVE)
    info = res["info"]
    tol = max(0.15, 4 * math.sqrt(info["information"] / NESTED_LIVE))
    diff = info["logz"] - grid["logz"]
    log(f"  logZ nested {info['logz']:.5f}, grid {grid['logz']:.5f}: difference {diff:+.5f} "
        f"(gate {tol:.4f})")
    if not abs(diff) <= tol:
        raise AssertionError(f"nested, examples/10: logZ {info['logz']} is {diff} from the grid's")
    for name in ("b_a", "b_e"):
        mean = float(res["chain"].flat(name).mean())
        g_mean, g_sd = grid[name]
        log(f"  {name} mean {mean:.5f}, grid {g_mean:.5f} +- {g_sd:.5f} "
            f"({abs(mean - g_mean) / g_sd:.3f} sd; gate 0.1)")
        if not abs(mean - g_mean) <= 0.1 * g_sd:
            raise AssertionError(f"nested, examples/10: {name} mean {mean} is more than 0.1 sd "
                                 f"from the grid's {g_mean}")
    res.update(grid=grid, grid_seconds=t_grid, n_epochs=model.n_epochs,
               seconds=time.perf_counter() - t0)
    log(f"nested evidence phase: {res['seconds']:.2f} s")
    return res


def ex04_nested_phase(ot, kk, osk) -> dict:
    """Phase 31: examples/04's eccentric and circular models in float32,
    each held to a float64 CPU model at 64 prior draws, through
    `octofit_nested` at the example's EX04_LIVE live points and its default
    NESTED_STEPS walker steps: the eccentric model under both EX04_SEEDS,
    the circular under the first. Gates: `_nested_run`'s and finite draws.
    Reported, not gated: the eccentric runs' difference in logZ against 4
    sqrt(2 H / n_live), b_a's median against 10 in posterior sd, and the
    Bayes factor. At these settings the batched constrained random walk
    (the JAX package's, ported number for number) does not find this
    11-parameter posterior reliably in either package: its acceptance falls
    to ~1%, runs under different seeds land tens of nats apart, each on a
    narrow mode (b_a sd 0.02-0.4 against ChEES's 0.65-0.81;
    `scripts/ex04_nested_spread.py`)."""
    t0 = time.perf_counter()
    table = ex04_table(ot)
    res = {}
    for eccentric in (True, False):
        kind = "eccentric" if eccentric else "circular"
        model = build_ex04_model(ot, table, eccentric, device="cuda", dtype=torch.float32)
        ref = build_ex04_model(ot, table, eccentric, device="cpu", dtype=torch.float64)
        gen = torch.Generator().manual_seed(31)
        reference_phase(f"examples/04 {kind}", model, ref, ref.link(ref.sample_priors(gen, 64)))
        for seed in EX04_SEEDS if eccentric else EX04_SEEDS[:1]:
            label = f"nested, examples/04 {kind}, seed {seed}"
            run = _nested_run(ot, kk, osk, label, model, seed, EX04_LIVE)
            chain = run.pop("chain")
            if not all(np.isfinite(chain[n]).all() for n in model.parameter_names):
                raise AssertionError(f"{label}: non-finite draws")
            v = chain["b_a"].reshape(-1)
            run["b_a"] = (float(np.median(v)), float(v.std()))
            run["max_loglike"] = float(chain.internals["loglike"].max())
            log(f"  b_a median {run['b_a'][0]:.5f}, sd {run['b_a'][1]:.5f} (truth "
                f"{EX04_TRUE['a']}: {abs(run['b_a'][0] - EX04_TRUE['a']) / run['b_a'][1]:.2f} sd; "
                f"reported, not gated), largest log-likelihood {run['max_loglike']:.4f}")
            res[f"{kind}_{seed}"] = run
    e0, e1 = (res[f"eccentric_{s}"]["info"] for s in EX04_SEEDS)
    tol = 4 * math.sqrt(2 * max(e0["information"], e1["information"]) / EX04_LIVE)
    log(f"  eccentric runs: logZ {e0['logz']:.4f} and {e1['logz']:.4f}, difference "
        f"{e0['logz'] - e1['logz']:+.4f} against 4 sqrt(2 H / n_live) = {tol:.4f} "
        "(reported, not gated)")
    circ = res[f"circular_{EX04_SEEDS[0]}"]["info"]
    log(f"  Bayes factor logZ_ecc - logZ_circ = {e0['logz'] - circ['logz']:+.4f} "
        "(reported, not gated)")
    res["seconds"] = time.perf_counter() - t0
    log(f"examples/04 nested phase: {res['seconds']:.2f} s")
    return res


def cv_phase(ot, kk, osk, main) -> dict:
    """Phase 32: cross-validation on the main path's chain. `pointwise_like`
    on the card over all its draws (each row's sum within 1e-4 of the
    draw's ln_like less the prior-only model's, the UnitLengthPrior terms
    that carry no data), then at CV_SUBSET draws through a float64 model on
    the card against the float64 CPU model (1e-9 relative); `psis_loo` on
    the matrix (finite elpd_loo and p_loo, every Pareto k finite);
    `generate_kfold_systems` (one system, its ln_like the prior-only
    model's) and `generate_system_per_epoch` (N_EPOCHS systems whose data
    terms sum to the whole model's) at 64 draws on the card in float64;
    `prior_only_model` keeps D, and with exclude_all gives ln_like 0."""
    from octofitter_tpu_torch import analysis

    t0 = time.perf_counter()
    model, chain, table = main["model"], main["chain"], main["table"]
    n_draws = chain["b_a"].size
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kk, osk)
    t_pw = time.perf_counter()
    LL, epochs = analysis.pointwise_like(model, chain)
    torch.cuda.synchronize()
    t_pw = time.perf_counter() - t_pw
    launches = _launches(kk, osk)
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunk = analysis.crossvalidation.POINTWISE_CHUNK
    log(f"cross-validation: pointwise_like over {n_draws} draws x {LL.shape[1]} data in "
        f"{t_pw:.2f} s (chunks of {chunk} draws, peak {peak:.3f} GiB); launches {launches}")
    if LL.shape != (n_draws, N_EPOCHS) or not np.isfinite(LL).all():
        raise AssertionError(f"pointwise_like: shape {LL.shape} or non-finite entries")
    if launches["orbit_solve_fwd"] != math.ceil(n_draws / chunk) or launches["orbit_solve_bwd"]:
        raise AssertionError(f"pointwise_like: launches {launches}; expected one forward per chunk")
    names = model.parameter_names
    flat = np.stack([chain[n].reshape(-1) for n in names], axis=-1)
    blank = ot.LogDensityModel(analysis.prior_only_model(model), verbosity=0, device="cuda",
                               dtype=model.dtype)
    data_ll = []
    with torch.no_grad():
        for lo in range(0, n_draws, chunk):
            theta = model.tensor(flat[lo: lo + chunk])
            data_ll.append((model.ln_like_nt(model.arr2nt(theta))
                            - blank.ln_like_nt(blank.arr2nt(theta))).double().cpu())
    data_ll = torch.cat(data_ll).numpy()
    err = np.abs(LL.sum(axis=1) - data_ll) / np.maximum(np.abs(data_ll), 1.0)
    log(f"  row sums against ln_like less the prior-only terms: max relative error "
        f"{err.max():.3e} (gate 1e-4)")
    if not err.max() <= 1e-4:
        raise AssertionError("pointwise_like: a row's sum disagrees with ln_like")

    idx = np.random.default_rng(32).choice(n_draws, CV_SUBSET, replace=False)
    sub = {n: chain[n].reshape(-1)[idx] for n in names}
    m64 = build_model(ot, table, device="cuda", dtype=torch.float64)
    r64 = build_model(ot, table, device="cpu", dtype=torch.float64)
    LL64, _ = analysis.pointwise_like(m64, sub)
    LLcpu, _ = analysis.pointwise_like(r64, sub)
    err64 = float((np.abs(LL64 - LLcpu) / np.maximum(np.abs(LLcpu), 1.0)).max())
    log(f"  float64 card vs CPU at {CV_SUBSET} draws: max relative error {err64:.3e} (gate 1e-9)")
    if not err64 <= 1e-9:
        raise AssertionError("pointwise_like: the float64 card disagrees with the CPU")

    t_loo = time.perf_counter()
    loo = analysis.psis_loo(LL)
    t_loo = time.perf_counter() - t_loo
    khat = loo["pareto_k"]
    log(f"  psis_loo in {t_loo:.2f} s: elpd_loo {loo['elpd_loo']:.4f}, p_loo {loo['p_loo']:.4f}, "
        f"largest Pareto k {khat.max():.4f}, k by epoch {np.round(khat, 4).tolist()}")
    if not (np.isfinite(loo["elpd_loo"]) and np.isfinite(loo["p_loo"])
            and len(khat) == N_EPOCHS and np.isfinite(khat).all()):
        raise AssertionError("psis_loo: a non-finite elpd_loo, p_loo or Pareto k")

    theta = r64.link(r64.sample_priors(torch.Generator().manual_seed(32), 64)).to("cuda")

    def data_terms(m):
        with torch.no_grad():
            x = m.arr2nt(m.invlink(theta))
            return (m.ln_like_nt(x) - blank64.ln_like_nt(x)).cpu()

    blank64 = ot.LogDensityModel(analysis.prior_only_model(m64), verbosity=0, device="cuda")
    folds = analysis.generate_kfold_systems(m64.system)
    systems, ep = analysis.generate_system_per_epoch(m64.system)
    fold_models = [ot.LogDensityModel(s, verbosity=0, device="cuda") for s in folds]
    epoch_models = [ot.LogDensityModel(s, verbosity=0, device="cuda") for s in systems]
    whole = data_terms(m64)
    per_epoch = sum(data_terms(m) for m in epoch_models)
    fold_err = max(float(data_terms(m).abs().max()) for m in fold_models)
    ep_err = float(((per_epoch - whole).abs() / whole.abs().clamp(min=1.0)).max())
    log(f"  {len(folds)} k-fold system(s), |data terms| {fold_err:.3e}; {len(systems)} "
        f"per-epoch systems at epochs {ep.tolist()}: their data terms sum to the whole model's "
        f"within {ep_err:.3e} relative")
    if len(folds) != 1 or len(systems) != N_EPOCHS or fold_err > 1e-9 or ep_err > 1e-9:
        raise AssertionError("generate_kfold_systems / generate_system_per_epoch disagree")
    for exclude_all in (False, True):
        m = ot.LogDensityModel(analysis.prior_only_model(m64, exclude_all), verbosity=0,
                               device="cuda")
        with torch.no_grad():
            ll = m.ln_like_nt(m.arr2nt(m.invlink(theta)))
        ll = torch.broadcast_to(m.tensor(ll), (64,))
        log(f"  prior_only_model(exclude_all={exclude_all}): D {m.D} (whole model {m64.D}), "
            f"max |ln_like| {float(ll.abs().max()):.3e}")
        if m.D != m64.D or (exclude_all and bool((ll != 0).any())):
            raise AssertionError("prior_only_model: D changed, or ln_like is not 0")
    res = {"launches": launches, "seconds_pointwise": t_pw, "seconds_loo": t_loo,
           "peak_gib": peak, "chunk": chunk, "n_draws": n_draws, "max_khat": float(khat.max()),
           "elpd_loo": loo["elpd_loo"], "p_loo": loo["p_loo"], "rowsum_err": float(err.max()),
           "f64_err": err64, "seconds": time.perf_counter() - t0}
    log(f"cross-validation phase: {res['seconds']:.2f} s")
    return res


def sbc_phase(ot, kk, osk) -> dict:
    """Phase 33, SBC: examples/10's model in float32 on the card, held to
    the CPU at 64 prior draws, then `calibrate` with SBC_TRIALS trials at
    truth with the example's sampler settings (SBC_KWARGS). Gates: every
    rank in [0, 1], every fit's draws finite, the trials' truths all
    different, the fused pair launched both ways; the KS distances are
    printed, not gated."""
    from octofitter_tpu_torch import analysis

    t0 = time.perf_counter()
    table = ex10_table(ot)
    model = build_ex10_model(ot, table, device="cuda", dtype=torch.float32)
    ref = build_ex10_model(ot, table, device="cpu", dtype=torch.float64)
    reference_phase("examples/10, SBC", model, ref,
                    ref.link(ref.sample_priors(torch.Generator().manual_seed(33), 64)))
    _reset_launches(kk, osk)
    res = analysis.calibrate(model, SBC_TRIALS, seed=33, sampler_kwargs=SBC_KWARGS,
                             init_at_truth=True, verbosity=1)
    torch.cuda.synchronize()
    launches = _launches(kk, osk)
    seconds = time.perf_counter() - t0
    for name, r in res.items():
        log(f"  SBC {name}: ranks {np.round(r['ranks'], 4).tolist()}, KS distance "
            f"{r['ks_distance']:.4f} (reported, not gated), truths {np.round(r['truths'], 4).tolist()}")
    ranks = np.concatenate([r["ranks"] for r in res.values()])
    truths = np.stack([r["truths"] for r in res.values()], axis=-1)
    log(f"  SBC: {SBC_TRIALS} trials in {seconds:.2f} s; launches {launches}")
    if not ((ranks >= 0) & (ranks <= 1)).all() or len(ranks) != SBC_TRIALS * model.D:
        raise AssertionError("SBC: a rank outside [0, 1], or a parameter without ranks")
    if not all(r["finite"].all() for r in res.values()):
        raise AssertionError("SBC: a fit has non-finite draws")
    if len(np.unique(truths, axis=0)) != SBC_TRIALS:
        raise AssertionError("SBC: two trials drew the same truth")
    if min(launches["orbit_solve_fwd"], launches["orbit_solve_bwd"]) == 0:
        raise AssertionError(f"SBC: launches {launches}; expected the fused pair")
    return {"ranks": {k: r["ranks"] for k, r in res.items()},
            "ks": {k: r["ks_distance"] for k, r in res.items()}, "launches": launches,
            "seconds": seconds, "n_epochs": model.n_epochs}


def completeness_phase(ot, kk, osk, directory) -> dict:
    """Phase 33, completeness: examples/11's model in float32 on the card
    on a COMPLETENESS_SCANS-transit synthetic scan law (`synth_gost_csv`),
    held to a float64 CPU model at 64 prior draws, then `completeness_map`
    on the example's --fast grid with its detection criterion and sampler.
    Gates: one trial per cell, the 20 Mjup at 5 AU cell detected, the
    fused pair launched both ways."""
    from octofitter_tpu_torch import analysis

    t0 = time.perf_counter()
    gost = synth_gost_csv(directory, n=COMPLETENESS_SCANS, seed=33)
    model = build_completeness_model(ot, gost, device="cuda", dtype=torch.float32)
    ref = build_completeness_model(ot, gost, device="cpu", dtype=torch.float64)
    reference_phase("examples/11", model, ref,
                    ref.link(ref.sample_priors(torch.Generator().manual_seed(33), 64)))
    _reset_launches(kk, osk)
    cmap, results = analysis.completeness_map(
        model, lambda m: ot.octofit(m, verbosity=0, **COMPLETENESS_FIT), completeness_detection,
        inject=lambda m, s: {"b_mass": m, "b_a": s}, masses=COMPLETENESS_MASSES,
        separations=COMPLETENESS_SEPARATIONS, n_trials=1, seed=0, verbosity=1)
    torch.cuda.synchronize()
    launches = _launches(kk, osk)
    seconds = time.perf_counter() - t0
    log(f"  completeness: masses {cmap.masses.tolist()} Mjup x separations "
        f"{cmap.separations.tolist()} AU in {seconds:.2f} s; launches {launches}")
    log(f"  completeness map:\n{cmap.completeness}\n  n_detected {cmap.n_detected.tolist()}, "
        f"n_total {cmap.n_total.tolist()}")
    for r in results:
        m = np.asarray(r.chain["b_mass"]).ravel()
        log(f"  trial mass {r.job.mass} sep {r.job.separation}: b_mass median {np.median(m):.4f}, "
            f"q05 {np.quantile(m, 0.05):.4f}, finite draws "
            f"{all(np.isfinite(np.asarray(r.chain[n])).all() for n in model.parameter_names)}")
    if not (cmap.n_total == 1).all():
        raise AssertionError(f"completeness: n_total {cmap.n_total.tolist()}")
    i_m, i_s = COMPLETENESS_MASSES.index(20.0), COMPLETENESS_SEPARATIONS.index(5.0)
    if cmap.n_detected[i_m, i_s] != 1:
        raise AssertionError("completeness: the 20 Mjup companion at 5 AU was not detected")
    if min(launches["orbit_solve_fwd"], launches["orbit_solve_bwd"]) == 0:
        raise AssertionError(f"completeness: launches {launches}; expected the fused pair")
    return {"completeness": cmap.completeness, "n_detected": cmap.n_detected,
            "launches": launches, "seconds": seconds, "n_epochs": model.n_epochs,
            "span": (float(model._all_epochs.min()), float(model._all_epochs.max()))}


def nss_phase(ot, kk, osk) -> dict:
    """Phase 34: the Gaia NSS warm start on a synthetic row of the headline
    truth (`nss_row`), float32 on the card. `initialize_from_nss` on the
    headline model must give finite starting points on the card; the row
    has no position angle at MJD 57000 (theta), so each of its 64
    candidates keeps theta's prior draw (their ln_post is printed). Then on
    the headline model with the periastron epoch free in theta's place
    (NSS_TP_PRIOR), where the row maps every orbital element, `octofit`
    from its starting points without `initialize` at CHAINS chains,
    NSS_ADAPTATION + NSS_ITERATIONS: gates max split-R-hat < 1.05 by the
    device diagnostics, finite draws, b_a's median within 5 sd of 7 and the
    fused pair on every gradient evaluation; then `nss_to_model_chain` at
    NSS_DRAWS draws, whose mean b_e lies within 0.01 of the row's."""
    t0 = time.perf_counter()
    table = bench_table(ot)
    row = ot.query_nss(row=nss_row(ot))
    res = {}
    for label, tp in (("headline", None), ("headline, tp free", NSS_TP_PRIOR)):
        model = build_model(ot, table, device="cuda", dtype=torch.float32,
                            tp=None if tp is None else ot.distributions.Uniform(*tp))
        mapped = ot.initialize_from_nss(model, row)
        pts = model.starting_points
        with torch.no_grad():
            lp = model.ln_post(pts).cpu().numpy()
        log(f"NSS, {label}: mapped {mapped}; {len(pts)} starting points on {pts.device}, "
            f"ln_post from {lp.min():.1f} to {lp.max():.1f}")
        if not bool(torch.isfinite(pts).all()) or pts.device.type != "cuda":
            raise AssertionError("initialize_from_nss: non-finite starting points, or off the card")
    # the fit: the last model, the headline with tp free
    gen = torch.Generator(device="cuda").manual_seed(34)
    _reset_launches(kk, osk)
    chain = ot.octofit(model, chains=CHAINS, adaptation=NSS_ADAPTATION, iterations=NSS_ITERATIONS,
                       generator=gen, verbosity=1)
    torch.cuda.synchronize()
    launches = _launches(kk, osk)
    n_evals = chain.info["n_grad_evals"]
    names = model.parameter_names
    x = np.stack([chain[n] for n in names], axis=-1)
    _, rhat = ot.ess_rhat_batch_device(x)
    log(f"  NSS-started fit ({label}): {CHAINS} chains, {NSS_ADAPTATION} + {NSS_ITERATIONS}, "
        f"{n_evals} gradient evaluations in {chain.info['sampling_time_s']:.2f} s; launches "
        f"{launches}; split-R-hat {dict(zip(names, np.round(rhat, 4).tolist()))}")
    if not bool(np.isfinite(x).all()) or not float(np.nanmax(rhat)) < 1.05:
        raise AssertionError("NSS-started fit: non-finite draws or max split-R-hat >= 1.05")
    if min(launches["orbit_solve_fwd"], launches["orbit_solve_bwd"]) < n_evals:
        raise AssertionError("NSS-started fit: the fused pair missed gradient evaluations")
    _gate_median("NSS-started fit", chain, "b_a", TRUE["a"])
    pseudo = ot.nss_to_model_chain(row, model, n_draws=NSS_DRAWS)
    e_mean = float(pseudo["b_e"].mean())
    log(f"  nss_to_model_chain: {NSS_DRAWS} draws, mean b_e {e_mean:.5f} (row {row['eccentricity']}), "
        f"mean b_a {float(pseudo['b_a'].mean()):.5f}")
    if not abs(e_mean - row["eccentricity"]) <= 0.01:
        raise AssertionError("nss_to_model_chain: mean b_e is more than 0.01 from the row's")
    res.update(launches=launches, n_evals=n_evals, rhat=float(np.nanmax(rhat)),
               sampling_s=chain.info["sampling_time_s"], seconds=time.perf_counter() - t0)
    log(f"NSS phase: {res['seconds']:.2f} s")
    return res


def evidence_kernel_step(osk, elements, res) -> None:
    """The fused pair against its plain versions, and timed, at the shapes
    phases 30-34 launched it with: the nested walkers' (NESTED_LIVE / 4,
    6) in float64 and (EX04_LIVE / 4, 12) in float32, `pointwise_like`'s
    full and last chunks at 12 epochs, the SBC fits' (8, 6) and the
    completeness fits' (16, COMPLETENESS_SCANS), float32; the NSS fit's is
    the headline's, held in phase 4."""
    t_step = time.perf_counter()
    n_draws, chunk = res["cv"]["n_draws"], res["cv"]["chunk"]
    last = n_draws - (math.ceil(n_draws / chunk) - 1) * chunk
    span = res["validation"]["completeness"]["span"]
    res["pair64"] = orbit_shapes_phase(osk, elements, (
        (f"({NESTED_LIVE // 4}, {EX10_EPOCHS})", NESTED_LIVE // 4, EX10_EPOCHS, None, EX10_SPAN),),
        (torch.float64,))
    res["pair"] = orbit_shapes_phase(osk, elements, tuple(
        (f"({b}, {t})", b, t, None, grid) for b, t, grid in (
            (EX04_LIVE // 4, EX04_EPOCHS, EX04_SPAN), (chunk, N_EPOCHS, HEADLINE_GRID),
            (last, N_EPOCHS, HEADLINE_GRID), (SBC_KWARGS["chains"], EX10_EPOCHS, EX10_SPAN),
            (COMPLETENESS_FIT["chains"], COMPLETENESS_SCANS, span))), (torch.float32,))
    log(f"evidence and validation kernel step: {time.perf_counter() - t_step:.2f} s")


def evidence_kernel_keys(kernels, res, ores) -> None:
    """Phases 30-34's entries of the `kernels` line: every kernel's launches
    on each path (`nested_launches` by run, `cv_launches`, `sbc_launches`,
    `completeness_launches`, `nss_launches`), and the fused pair's rows at
    their shapes (`nested_*` float64, `nested_ex04_*`, `cv_*`,
    `cv_last_*`, `sbc_*`, `completeness_*` and `nss_*`, float32)."""
    f32, f64 = torch.float32, torch.float64
    ev, val = res["evidence"], res["validation"]
    n_draws, chunk = res["cv"]["n_draws"], res["cv"]["chunk"]
    last = n_draws - (math.ceil(n_draws / chunk) - 1) * chunk
    for k in kernels:
        name = k["name"]
        nested = {"examples/10": ev["nested"]["launches"].get(name, 0)}
        nested.update({f"examples/04 {run}": r["launches"].get(name, 0)
                       for run, r in ev["ex04"].items() if isinstance(r, dict)})
        k.update({"nested_launches": nested, "cv_launches": res["cv"]["launches"].get(name, 0),
                  "sbc_launches": val["sbc"]["launches"].get(name, 0),
                  "completeness_launches": val["completeness"]["launches"].get(name, 0),
                  "nss_launches": ev["nss"]["launches"].get(name, 0)})
        if not name.startswith("orbit_solve"):
            continue
        part = name.removeprefix("orbit_solve_")
        for key, pair, b, t, dtype in (
                ("nested", "pair64", NESTED_LIVE // 4, EX10_EPOCHS, f64),
                ("nested_ex04", "pair", EX04_LIVE // 4, EX04_EPOCHS, f32),
                ("cv", "pair", chunk, N_EPOCHS, f32), ("cv_last", "pair", last, N_EPOCHS, f32),
                ("sbc", "pair", SBC_KWARGS["chains"], EX10_EPOCHS, f32),
                ("completeness", "pair", COMPLETENESS_FIT["chains"], COMPLETENESS_SCANS, f32),
                ("nss", None, CHAINS, N_EPOCHS, f32)):
            shape = f"({b}, {t})"
            row = (ores if pair is None else res[pair])[part][(shape, dtype)]
            words = 8 * b + t + 14 * b * t if part == "fwd" else 8 * b + t + 15 * b * t + 8 * b
            ops = (OPS_ORBIT_FWD if part == "fwd" else OPS_ORBIT_BWD) * b * t
            bnd = bound_ms(dtype.itemsize * words, ops, dtype)
            k.update({f"{key}_shape": shape, f"{key}_dtype": str(dtype).removeprefix("torch."),
                      f"{key}_max_abs_err": row["err"], f"{key}_ms": row["ms"],
                      f"{key}_plain_ms": row["plain_ms"], f"{key}_bound_ms": bnd[0],
                      f"{key}_bound_by": bnd[1]})


# Phase 35: the ladder and the chains across processes (`parallel/`). The
# `evidence` job initializes the partial-arc model once and runs (a), a
# one-rank NCCL mesh (`chain_mesh()` outside any process group) against
# mesh=None; then it spawns one world of PARALLEL_RANKS ranks that share
# the card over gloo (NCCL refuses two ranks on one card), which runs (b)
# the ladder's walkers over both ranks, (c) its rungs over both ranks,
# (d) `octofit_sharded` on the headline model and (e) epoch sharding, and
# meanwhile nothing else in the job; then the job runs the unsharded
# references of (b)-(d) and (f), `octofit(profile_dir=)`. (g), the fused
# pair at the ranks' shapes, runs in the main process after the joins.
PARALLEL_RANKS = 2
PARALLEL_PT_ROUNDS = 2          # (a) and the float32 runs of (b) and (c)
PARALLEL_F64_ROUNDS = 1         # the float64 runs of (b) and (c)
PARALLEL_SHARDED = dict(chains=CHAINS, adaptation=100, iterations=50)
PARALLEL_SCANS = (DR4_EPOCHS, 20_000)
PARALLEL_EPOCH_TOL = 1e-10      # relative, two ranks against one sum
# (b) and (c) in float64 after one round against mesh=None: the ranks'
# walker sums (the rung acceptance, the ChEES criterion) may differ from
# one sum in their last bits, and the round's adaptation carries that into
# the trajectories (measured: 0 for both on an NVIDIA H100 80GB HBM3 at
# 700 W); every swap decision must be the same
PARALLEL_F64_DRAW_TOL = 1e-9
PARALLEL_PROFILE = dict(chains=CHAINS, adaptation=2, iterations=1)
PARALLEL_RANKS_TIMEOUT_S = 600
# the per-rank shapes of the fused pair: a rank's half of the partial-arc
# ladder (2048 walkers x 16 rungs, or 4096 x 8) and of the sharded chains
PARALLEL_SHAPES = ((f"({PT_CHAINS // PARALLEL_RANKS}, {N_EPOCHS})", PT_CHAINS // PARALLEL_RANKS,
                    N_EPOCHS, None, PA_SPAN, (torch.float32, torch.float64)),
                   (f"({CHAINS // PARALLEL_RANKS}, {N_EPOCHS})", CHAINS // PARALLEL_RANKS,
                    N_EPOCHS, None, HEADLINE_GRID, (torch.float32,)))


def _pt_numbers(chain, info) -> dict:
    """What phase 35 compares and gates of one PT run."""
    x = np.stack([chain[n] for n in chain.names], axis=-1)
    return dict(x=x, logz=info["logevidence"], trips=info["n_round_trips"],
                rejection=np.asarray(info["swap_rejection"]),
                barriers=(info["global_barrier"], info["global_barrier_variational"]),
                n_grad_evals=info["n_grad_evals"], rank_grad_evals=info["rank_grad_evals"],
                n_sweeps=info["n_sweeps"], seconds=info["sampling_time_s"],
                collectives=info["collectives"])


def save_init(model, path) -> None:
    """The model's starting points and Laplace sigma, on the host, into
    `path` (written whole, then renamed, for a process that waits on it)."""
    torch.save({"points": model.starting_points.cpu(), "sigma": model.laplace_sigma.cpu()},
               path + ".part")
    os.replace(path + ".part", path)


def load_init(path, timeout_s=PARALLEL_RANKS_TIMEOUT_S) -> dict:
    """What `save_init` wrote to `path`, once it is there."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no initialization was shared at {path} within {timeout_s} s")
        time.sleep(1)
    return torch.load(path)


def _without_draws(run) -> dict:
    return {k: v for k, v in run.items() if k != "x"}


def _parallel_pt(ot, kk, osk, model, mesh, n_rounds) -> dict:
    """`octofit_pigeons` with PA_KWARGS for `n_rounds` rounds, from a
    generator seeded 0, the launch counts set to 0 just before and read
    just after."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    _reset_launches(kk, osk)
    chain, info = ot.octofit_pigeons(model, generator=gen, n_rounds=n_rounds, verbosity=0,
                                     mesh=mesh, **PA_KWARGS)
    torch.cuda.synchronize()
    return dict(_pt_numbers(chain, info), launches=_launches(kk, osk))


def _pt_gates(label, res, rank=0) -> None:
    """Phase 10's gates that two rounds allow, and the fused pair on every
    evaluation and components pass of this rank."""
    n_evals = res["rank_grad_evals"][rank]
    per_sweep = res["seconds"] / res["n_sweeps"]
    c = res["collectives"]
    log(f"  {label}: {res['n_sweeps']} sweeps in {res['seconds']:.3f} s ({per_sweep:.4f} s each); "
        f"evaluations {res['rank_grad_evals']} by rank; log-evidence {res['logz']:.4f}, barriers "
        f"{res['barriers'][0]:.4f} / {res['barriers'][1]:.4f}, round trips {res['trips']}; "
        f"collectives {c['calls']} ({c['calls'] / res['n_sweeps']:.1f} per sweep), "
        f"{c['bytes']} bytes ({c['bytes'] / res['n_sweeps']:.0f} per sweep); launches "
        f"{res['launches']}")
    if not bool(np.isfinite(res["x"]).all()):
        raise AssertionError(f"{label}: non-finite draws")
    if not all(np.isfinite([res["logz"], *res["barriers"]])):
        raise AssertionError(f"{label}: non-finite log-evidence or barrier")
    if not bool(((res["rejection"] > 0) & (res["rejection"] < 1)).all()):
        raise AssertionError(f"{label}: a swap-rejection rate outside (0, 1)")
    lf, lb = res["launches"]["orbit_solve_fwd"], res["launches"]["orbit_solve_bwd"]
    if lf < n_evals + res["n_sweeps"] or lb < n_evals:
        raise AssertionError(f"{label}: the fused pair missed evaluations ({lf}, {lb} for "
                             f"{n_evals} evaluations and {res['n_sweeps']} sweeps)")


def _same_swaps(label, got, want) -> None:
    """Every swap decision as mesh=None's: rejection rates and round trips."""
    if not (np.array_equal(got["rejection"], want["rejection"]) and got["trips"] == want["trips"]):
        raise AssertionError(f"{label}: swap decisions differ from mesh=None "
                             f"({got['rejection']} / {want['rejection']}, trips {got['trips']} / "
                             f"{want['trips']})")


def _epoch_checks(ot, mesh) -> dict:
    """(e): epoch sharding in float64 on the card over the ranks of `mesh`
    against one sum or fit on this rank, at each of PARALLEL_SCANS."""
    from octofitter_tpu_torch.astrom.fitting import fit_5param, prepare_A_5param

    out = {}
    f64 = dict(dtype=torch.float64, device="cuda")
    for n in PARALLEL_SCANS:
        tab = dr4_table(n, seed=1)
        rng = np.random.default_rng(n)
        A = prepare_A_5param(tab["epoch"], np.cos(tab["scan_pos_angle"]),
                             np.sin(tab["scan_pos_angle"]), tab["parallax_factor_al"],
                             57388.5, 57388.5)
        b = A @ np.array([1.0, -0.5, 2.0, 0.3, -0.7]) + 0.05 * rng.standard_normal(n)
        cphi, sphi = np.cos(tab["scan_pos_angle"]), np.sin(tab["scan_pos_angle"])
        dalpha, ddelta = torch.as_tensor(b * cphi, **f64), torch.as_tensor(b * sphi, **f64)
        w = torch.as_tensor(rng.integers(0, 3, n).astype(float), **f64)
        table = dict(centroid_pos_al=torch.as_tensor(b, **f64),
                     centroid_pos_error_al=torch.as_tensor(tab["centroid_pos_error_al"], **f64))
        model_al = torch.as_tensor(b + 0.02 * rng.standard_normal(n), **f64)
        jitter = 0.03
        t0 = time.perf_counter()
        ll = ot.parallel.sharded_gaia_dr4_ll(table, model_al, jitter, mesh)
        fit = ot.parallel.sharded_fit_5param(torch.as_tensor(A, **f64), cphi, sphi, dalpha, ddelta,
                                             mesh, weights=w, include_chi2=True, sigma=0.05)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        var = table["centroid_pos_error_al"] ** 2 + jitter**2
        ll_ref = torch.sum(-0.5 * ((table["centroid_pos_al"] - model_al) ** 2 / var
                                   + torch.log(2 * math.pi * var)))
        ref = fit_5param(torch.as_tensor(A, **f64), cphi, sphi, dalpha, ddelta, weights=w,
                         include_chi2=True, sigma=0.05)
        got = torch.stack([ll, *fit["parameters"], fit["chi_squared_astro"]])
        want = torch.stack([ll_ref, *ref["parameters"], ref["chi_squared_astro"]])
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-300)).max())
        log(f"  (e) epoch sharding, {n} scans, float64: log-likelihood {float(ll):.10f}, fit "
            f"parameters {np.round(torch.stack(fit['parameters']).cpu().numpy(), 8).tolist()}; "
            f"largest relative difference from one rank's {rel:.3e} (limit {PARALLEL_EPOCH_TOL:g}); "
            f"{seconds * 1e3:.2f} ms")
        if not rel <= PARALLEL_EPOCH_TOL:
            raise AssertionError(f"(e) epoch sharding at {n} scans: {rel:.3e} from one rank's")
        out[n] = dict(rel=rel, ms=seconds * 1e3)
    return out


def _parallel_rank(ot, kk, osk, state) -> dict:
    """One rank of phase 35's world, run as a job (`_worker`): joins the
    world on the card as torchrun would place it, then (b)-(e) on this
    rank's block."""
    rank = state["rank"]
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(PARALLEL_RANKS))
    t0 = time.perf_counter()
    ot.parallel.initialize_distributed(dict(coordinator_address=state["init"],
                                            num_processes=PARALLEL_RANKS, process_id=rank))
    backend = torch.distributed.get_backend()
    log(f"rank {rank}: joined a world of {PARALLEL_RANKS} over {backend} on "
        f"{torch.cuda.current_device()} in {time.perf_counter() - t0:.2f} s")
    walkers = ot.parallel.global_mesh(("walkers",))
    rungs = ot.parallel.global_mesh(("walkers", "rungs"), (1, PARALLEL_RANKS))
    table = bench_table(ot, *PA_SPAN)
    res = {"backend": backend}
    for dtype, rounds, tag in ((torch.float64, PARALLEL_F64_ROUNDS, "f64"),
                               (torch.float32, PARALLEL_PT_ROUNDS, "f32")):
        model = build_model(ot, table, name="bench_partial_arc", device="cuda", dtype=dtype)
        model.starting_points = model.tensor(state["pa_points"])
        model.laplace_sigma = model.tensor(state["pa_sigma"])
        for part, mesh in (("b", walkers), ("c", rungs)):
            res[f"{part}_{tag}"] = _parallel_pt(ot, kk, osk, model, mesh, rounds)
            log(f"rank {rank}: ({part}) {tag} done, {res[f'{part}_{tag}']['seconds']:.2f} s")

    model = build_model(ot, bench_table(ot), device="cuda", dtype=torch.float32)
    model.starting_points = model.tensor(state["starting_points"])
    model.laplace_sigma = model.tensor(state["laplace_sigma"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    _reset_launches(kk, osk)
    chain = ot.parallel.octofit_sharded(model, mesh=walkers, generator=gen, verbosity=0,
                                        **PARALLEL_SHARDED)
    torch.cuda.synchronize()
    res["d"] = dict(x=np.stack([chain[n] for n in model.parameter_names], axis=-1),
                    launches=_launches(kk, osk), n_evals=chain.info["n_grad_evals"],
                    seconds=chain.info["sampling_time_s"],
                    step_size=float(chain.info["step_size"]))
    log(f"rank {rank}: (d) done, {res['d']['seconds']:.2f} s")
    _reset_launches(kk, osk)
    res["e"] = _epoch_checks(ot, walkers)
    res["e_launches"] = _launches(kk, osk)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return res


def _trace_share(directory) -> dict:
    """The fused pair's kernel events and the device's busy share in the
    one Chrome trace under `directory`: the kernels' summed durations over
    the span from the first event to the last."""
    files = os.listdir(directory)
    with open(os.path.join(directory, files[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    busy = sum(e["dur"] for e in kernels)
    counts = {k: sum(k in e["name"] for e in kernels) for k in ("orbit_fwd_kernel", "orbit_bwd_kernel")}
    return dict(files=files, kernel_events=len(kernels), fused=counts, busy_us=busy, span_us=span,
                share=busy / span if span else float("nan"))


def parallel_phase(ot, kk, osk, state) -> dict:
    """Phase 35, in the `evidence` job: (a)-(f) above. `state` holds the
    headline's starting points and Laplace sigma, and `pa_init`, the path
    where phase 10 shares the partial-arc model's (`save_init`)."""
    import tempfile

    t_phase = time.perf_counter()
    res = {}
    table = bench_table(ot, *PA_SPAN)
    pa32 = build_model(ot, table, name="bench_partial_arc", device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    init = load_init(state["pa_init"])
    pa32.starting_points = pa32.tensor(init["points"])
    pa32.laplace_sigma = pa32.tensor(init["sigma"])
    log(f"phase 35: phase 10's partial-arc initialization read after {time.perf_counter() - t0:.2f} "
        f"s; its starting points and Laplace sigma go to the ranks")

    # (a) a one-rank NCCL mesh against mesh=None, bit for bit
    mesh1 = ot.parallel.chain_mesh(axis_name="walkers")
    log(f"(a) one-rank mesh: {mesh1}, backend {torch.distributed.get_backend()}")
    none32 = _parallel_pt(ot, kk, osk, pa32, None, PARALLEL_PT_ROUNDS)
    one32 = _parallel_pt(ot, kk, osk, pa32, mesh1, PARALLEL_PT_ROUNDS)
    torch.distributed.destroy_process_group()
    _pt_gates("(a) mesh=None, float32", none32)
    _pt_gates("(a) one-rank NCCL mesh, float32", one32)
    same = (np.array_equal(one32["x"], none32["x"]) and one32["trips"] == none32["trips"]
            and np.array_equal(one32["rejection"], none32["rejection"])
            and one32["logz"] == none32["logz"])
    log(f"  (a) bit for bit as mesh=None (draws, round trips, swap rejections, log-evidence): {same}")
    if not same:
        raise AssertionError("(a) the one-rank NCCL mesh does not give mesh=None's bits")
    res["a"] = {"none": _without_draws(none32), "one": _without_draws(one32)}

    # (b)-(e) in a world of PARALLEL_RANKS ranks on this card
    rank_state = dict(state, pa_points=pa32.starting_points.cpu(),
                      pa_sigma=pa32.laplace_sigma.cpu())
    with tempfile.TemporaryDirectory() as directory, _Workers(directory) as workers:
        t0 = time.perf_counter()
        init = f"file://{os.path.join(directory, 'store')}"
        names = [f"rank{r}" for r in range(PARALLEL_RANKS)]
        for r, name in enumerate(names):
            workers.start(name, dict(rank_state, rank=r, init=init), target=_parallel_rank)
        ranks = workers.join_all(names, PARALLEL_RANKS_TIMEOUT_S)
        res["ranks_s"] = time.perf_counter() - t0
    log(f"phase 35: the ranks took {res['ranks_s']:.2f} s (started, joined, {ranks[0]['backend']})")

    # the unsharded references, with the card to this job again
    pa64 = build_model(ot, table, name="bench_partial_arc", device="cuda", dtype=torch.float64)
    pa64.starting_points = pa64.tensor(rank_state["pa_points"])
    pa64.laplace_sigma = pa64.tensor(rank_state["pa_sigma"])
    none64 = _parallel_pt(ot, kk, osk, pa64, None, PARALLEL_F64_ROUNDS)
    _pt_gates("mesh=None, float64", none64)
    for part in ("b", "c"):
        for tag, want in (("f64", none64), ("f32", none32)):
            label = f"({part}) {'walkers' if part == 'b' else 'rungs'} over {PARALLEL_RANKS} ranks, {tag}"
            for r, rr in enumerate(ranks):
                _pt_gates(f"{label}, rank {r}", rr[f"{part}_{tag}"], rank=r)
            got = ranks[0][f"{part}_{tag}"]
            for rr in ranks[1:]:
                if not np.array_equal(rr[f"{part}_{tag}"]["x"], got["x"]):
                    raise AssertionError(f"{label}: the ranks returned different chains")
            dev = float(np.abs(got["x"] - want["x"]).max())
            log(f"  {label}: draws within {dev:.3e} of mesh=None's; seconds per sweep "
                f"{got['seconds'] / got['n_sweeps']:.4f} against {want['seconds'] / want['n_sweeps']:.4f}")
            if tag == "f64":
                _same_swaps(label, got, want)
                if not dev <= PARALLEL_F64_DRAW_TOL:
                    raise AssertionError(f"{label}: draws {dev:.3e} from mesh=None's")
            res[f"{part}_{tag}"] = dict(dev=dev, none_seconds=want["seconds"],
                                        none_sweeps=want["n_sweeps"],
                                        ranks=[_without_draws(rr[f"{part}_{tag}"]) for rr in ranks])

    dev_bc = float(np.abs(ranks[0]["b_f32"]["x"] - ranks[0]["c_f32"]["x"]).max())
    log(f"  (b) against (c), float32, both {PT_CHAINS // PARALLEL_RANKS} rows a rank: draws within "
        f"{dev_bc:.3e} of each other")
    res["bc_f32_dev"] = dev_bc

    # (d) octofit_sharded against octofit at the same chain count
    model = build_model(ot, bench_table(ot), device="cuda", dtype=torch.float32)
    model.starting_points = model.tensor(state["starting_points"])
    model.laplace_sigma = model.tensor(state["laplace_sigma"])
    pts = model.starting_points[torch.as_tensor(
        np.resize(np.arange(len(model.starting_points)), PARALLEL_SHARDED["chains"]), device="cuda")]
    _reset_launches(kk, osk)
    ref = ot.octofit(model, generator=torch.Generator(device="cuda").manual_seed(0),
                     starting_points=pts, verbosity=0, **PARALLEL_SHARDED)
    torch.cuda.synchronize()
    x_ref = np.stack([ref[n] for n in model.parameter_names], axis=-1)
    x = ranks[0]["d"]["x"]
    _, rhat = ot.ess_rhat_batch_device(x)
    _, rhat_ref = ot.ess_rhat_batch_device(x_ref)
    dev = float(np.abs(x - x_ref).max())
    for r, rr in enumerate(ranks):
        lf, lb = rr["d"]["launches"]["orbit_solve_fwd"], rr["d"]["launches"]["orbit_solve_bwd"]
        log(f"  (d) octofit_sharded rank {r}: {rr['d']['n_evals']} evaluations in "
            f"{rr['d']['seconds']:.2f} s, launches {rr['d']['launches']}")
        if min(lf, lb) < rr["d"]["n_evals"]:
            raise AssertionError(f"(d) rank {r}: the fused pair missed evaluations")
        if not np.array_equal(rr["d"]["x"], x):
            raise AssertionError("(d) the ranks returned different chains")
    log(f"  (d) {PARALLEL_RANKS} x {PARALLEL_SHARDED['chains'] // PARALLEL_RANKS} chains, "
        f"{PARALLEL_SHARDED['adaptation']} + {PARALLEL_SHARDED['iterations']}: max split-R-hat "
        f"{float(np.nanmax(rhat)):.5f} (octofit at {PARALLEL_SHARDED['chains']}: "
        f"{float(np.nanmax(rhat_ref)):.5f}, {ref.info['sampling_time_s']:.2f} s, "
        f"{ref.info['n_grad_evals']} evaluations); draws within {dev:.3e} of octofit's; step size "
        f"{ranks[0]['d']['step_size']:.6g} against {float(ref.info['step_size']):.6g}")
    if not float(np.nanmax(rhat)) < 1.05 or not bool(np.isfinite(x).all()):
        raise AssertionError("(d) octofit_sharded: max split-R-hat >= 1.05 or non-finite draws")
    b_a = x[..., model.parameter_names.index("b_a")].reshape(-1)
    med, sd = float(np.median(b_a)), float(b_a.std())
    log(f"  (d) b_a median {med:.5f}, sd {sd:.5f} (true {TRUE['a']}; {abs(med - TRUE['a']) / sd:.2f} sd)")
    if not abs(med - TRUE["a"]) <= 5 * sd:
        raise AssertionError("(d) octofit_sharded: b_a median more than 5 sd from the truth")
    res["d"] = dict(dev=dev, rhat=float(np.nanmax(rhat)), rhat_ref=float(np.nanmax(rhat_ref)),
                    ranks=[_without_draws(rr["d"]) for rr in ranks],
                    ref_seconds=ref.info["sampling_time_s"], ref_evals=ref.info["n_grad_evals"],
                    ref_launches=_launches(kk, osk))
    res["e"] = [rr["e"] for rr in ranks]

    # (f) octofit(profile_dir=): the trace holds the fused pair's kernels
    with tempfile.TemporaryDirectory() as directory:
        _reset_launches(kk, osk)
        prof = ot.octofit(model, generator=torch.Generator(device="cuda").manual_seed(0),
                          starting_points=pts, verbosity=0, profile_dir=directory,
                          **PARALLEL_PROFILE)
        launches = _launches(kk, osk)
        share = _trace_share(directory)
    log(f"  (f) octofit(profile_dir=) at {PARALLEL_PROFILE}: {prof.info['n_grad_evals']} evaluations, "
        f"trace {share['files']}: {share['kernel_events']} kernel events, the fused pair "
        f"{share['fused']} (launched {launches['orbit_solve_fwd']} / {launches['orbit_solve_bwd']}); "
        f"device busy {share['busy_us']:.0f} of {share['span_us']:.0f} us traced "
        f"({100 * share['share']:.2f}%)")
    if min(share["fused"].values()) < prof.info["n_grad_evals"]:
        raise AssertionError("(f) the trace lacks the fused pair's kernel events")
    res["f"] = dict(share, launches=launches, n_evals=prof.info["n_grad_evals"])
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 35: {res['seconds']:.2f} s")
    return res


def parallel_kernel_step(osk, elements, res) -> None:
    """(g): the fused pair against its plain versions, and timed, at the
    ranks' shapes."""
    t_step = time.perf_counter()
    res["pair"] = {}
    for label, b, t, span, grid, dtypes in PARALLEL_SHAPES:
        out = orbit_shapes_phase(osk, elements, ((label, b, t, span, grid),), dtypes)
        for part in ("fwd", "bwd"):
            res["pair"].setdefault(part, {}).update(out[part])
    log(f"parallel kernel step: {time.perf_counter() - t_step:.2f} s")


def parallel_kernel_keys(kernels, res) -> None:
    """Phase 35's entries of the `kernels` line: every kernel's launches by
    part and rank (`parallel_launches`), and the fused pair's rows at the
    ranks' shapes (`parallel_*`: a rank's half of the ladder, float32 and
    float64; `parallel_sharded_*`: a rank's half of the chains)."""
    for k in kernels:
        name = k["name"]
        launches = {"a_none": res["a"]["none"]["launches"].get(name, 0),
                    "a_one_rank": res["a"]["one"]["launches"].get(name, 0)}
        for part in ("b_f64", "b_f32", "c_f64", "c_f32", "d"):
            launches[part] = [rr["launches"].get(name, 0) for rr in res[part]["ranks"]]
        launches["f"] = res["f"]["launches"].get(name, 0)
        k["parallel_launches"] = launches
        if not name.startswith("orbit_solve"):
            continue
        part = name.removeprefix("orbit_solve_")
        for key, (label, b, t, _, _, dtypes) in zip(("parallel", "parallel_sharded"),
                                                   PARALLEL_SHAPES):
            for dtype in dtypes:
                row = res["pair"][part][(label, dtype)]
                words = 8 * b + t + 14 * b * t if part == "fwd" else 8 * b + t + 15 * b * t + 8 * b
                ops = (OPS_ORBIT_FWD if part == "fwd" else OPS_ORBIT_BWD) * b * t
                bnd = bound_ms(dtype.itemsize * words, ops, dtype)
                kd = key + ("" if dtype == torch.float32 else "_f64")
                k.update({f"{kd}_shape": label, f"{kd}_dtype": str(dtype).removeprefix("torch."),
                          f"{kd}_max_abs_err": row["err"], f"{kd}_ms": row["ms"],
                          f"{kd}_plain_ms": row["plain_ms"], f"{kd}_bound_ms": bnd[0],
                          f"{kd}_bound_by": bnd[1]})


# Phase 36: the plots' arrays on the card (`octofitter_tpu_torch/plots/`).
# The GPU machine has no matplotlib, so the phase calls each panel's
# private `_*_arrays` function, the computation that the drawing function
# draws, on the card in float32 and on a float64 CPU model from the same
# chain and draws (both choose them as the JAX package does), after the
# jobs have joined: (a) octoplot's panels of the headline fit (its 4096 x
# 100 draws) at PLOT_DRAWS draws; (b) those of examples/02's joint model
# (astrometry, astrometry in time, RV, HGCA) and rvtimeplot's and
# rvpostplot's of examples/03's RV-GP model, on chains of points near
# their truths (PLOT_POINT_CHAINS x PLOT_POINT_DRAWS); (c) astromplot's
# mark_epochs_mjd summary; (d) the native table reader; (e) the forward
# kernel and the Kepler kernel against their plain versions at every shape
# (a)-(c) launched them with.
PLOT_DRAWS = (50, 4096)  # octoplot's default, and a wide shape
PLOT_MARKS = (57500.0, 58500.0, 59500.0)
PLOT_POINT_CHAINS, PLOT_POINT_DRAWS = 64, 64
F32_HALF_ULP = 2.0**-24  # float32's rounding, relative


def _plots_module():
    import importlib

    # the module, not the function `plots.octoplot` that shadows its name
    return importlib.import_module("octofitter_tpu_torch.plots.octoplot")


def _float32_chain(ot, chain):
    """`chain` with its columns rounded to float32, so that the card's
    model and the CPU's read the same values."""
    return ot.Chains({k: np.asarray(v, dtype=np.float32).astype(np.float64)
                      for k, v in chain.data.items()}, chain.internals, chain.info)


def _plot_limits(ot, ref, chain, planet, n_draws, t=None, rows=None, dtype=torch.float32):
    """(14, n, T) limits of a card evaluation of the draws' fields in
    `dtype` against the float64 CPU `ref`'s: the fused pair's per-field
    tolerances (`_field_tolerances`) plus, in float32, what rounding the
    epochs, tp, a and M to float32 moves the mean anomaly by, at the epochs
    `t` (numpy), at the MAP draw (`rows`, (1, D)) or, with t None, along
    each draw's track over one period; and each draw's reflex factor
    |m / M| (n, 1), 1 for a planet without a mass."""
    op = _plots_module()
    with torch.no_grad():
        if rows is None:
            orbit, m = op._sample_orbits(ref, chain, planet, n_draws)
        else:
            nt, orbits = op.orbits_of(ref, rows)
            i = [p.name for p in ref.system.planets].index(planet)
            orbit, m = orbits[i], op.planet_mass(ref, nt, planet, len(rows))
        tt = op.period_tracks(orbit, 200, ref.dtype, ref.device) if t is None else ref.tensor(t)
        sol = op.solve_tracks(orbit, tt) if t is None else ot.orbitsolve(orbit, tt)
    n = orbit.tp.shape[0]

    def field(name, default):
        x = getattr(orbit, name, None)
        return torch.full((n,), default, dtype=torch.float64) if x is None else \
            torch.broadcast_to(x, (n,)).double()

    elems = torch.stack([field("a", 0.0), field("e", 0.0), field("i", math.pi / 2),
                         field("omega", 0.0), field("Omega", 0.0), field("tp", 0.0),
                         field("M", 1.0), field("plx", 1.0)])
    from octofitter_tpu_torch.constants import KEPLER_YEAR_DAYS

    a, tp, mass = elems[0][:, None], elems[5][:, None], elems[6][:, None]
    mean_motion = 2 * math.pi / (torch.sqrt(a**3 / mass) * KEPLER_YEAR_DAYS)
    d_ma = F32_HALF_ULP * (mean_motion * (tt.abs() + tp.abs())
                           + 2 * (mean_motion * (tt - tp)).abs()) if dtype == torch.float32 else 0.0
    lim = _field_tolerances(elems, tt, sol.EA, dtype, d_ma)
    factor = torch.ones((n, 1), dtype=torch.float64) if m is None else \
        torch.where(m[:, None] != 0, (m[:, None] / mass).abs(), 1.0)
    return lim.numpy(), factor.numpy()


def _circular(d, period):
    """|d| modulo `period`, the shorter way round."""
    d = np.mod(np.abs(d), period)
    return np.minimum(d, period - d)


def _panel_checks(ot, name, ref, chain, kwargs, got, want):
    """[(key, |card - CPU|, limit)] for each array of the panel `name`."""
    planet = ref.system.planets[0].name
    n_draws = kwargs.get("n_draws")
    if name == "astromplot":
        lim, _ = _plot_limits(ot, ref, chain, planet, n_draws)
        out = [("ra", abs(got["ra"] - want["ra"]), lim[9]),
               ("dec", abs(got["dec"] - want["dec"]), lim[10])]
        if "mark_ra" in want:
            lim, _ = _plot_limits(ot, ref, chain, planet, n_draws, want["marks"])
            out += [("mark_ra", abs(got["mark_ra"] - want["mark_ra"]), lim[9]),
                    ("mark_dec", abs(got["mark_dec"] - want["mark_dec"]), lim[10])]
        return out
    if name == "physorbitplot":
        # AbsoluteVisual runs in float64 on the card (see `_plot_panel`'s callers)
        lim, _ = _plot_limits(ot, ref, chain, planet, n_draws, dtype=torch.float64)
        return [("x", abs(got["x"] - want["x"]), lim[3]),
                ("y", abs(got["y"] - want["y"]), lim[4])]
    if name == "astromtimeplot":
        lim, _ = _plot_limits(ot, ref, chain, planet, n_draws, want["ts"])
        pos = lim[9] + lim[10]
        return [("sep", abs(got["sep"] - want["sep"]), pos),
                ("pa", _circular(got["pa"] - want["pa"], 360.0),
                 np.degrees(pos / np.maximum(want["sep"], 1e-300)))]
    if name in ("rvtimeplot", "hgcaplot"):
        out = []
        for k, p in enumerate(ref.system.planets):
            lim, factor = _plot_limits(ot, ref, chain, p.name, n_draws, want["ts"])
            if name == "rvtimeplot":
                out.append((f"rv {p.name}", abs(got["rv"][k] - want["rv"][k]), lim[13] * factor))
            else:
                for key, row in (("pmra", 11), ("pmdec", 12)):
                    # a draw without a mass has factor 1 here and a value of 0 both sides
                    out.append((f"{key} {p.name}", abs(got[key][k] - want[key][k]),
                                lim[row] * factor))
        return out
    if name == "rvpostplot":
        return _rvpost_checks(ot, ref, chain, planet, n_draws, got, want)
    raise KeyError(name)


def _rvpost_checks(ot, ref, chain, planet, n_draws, got, want):
    """rvpostplot: the draws' Keplerian RV at the MAP period's grid; the
    data's phase (float32's period moves it by a few ulp of (t - tp) / P,
    modulo 1); the detrended data and the residuals, which add to the MAP
    Keplerian part's RV the GP's prediction by a float32 Cholesky
    solve, moved by up to 16 kappa 2^-24 of the residuals' size (kappa:
    the condition number of K + diag(var) at the MAP draw, on the CPU)."""
    from octofitter_tpu_torch.model.params import Params

    op = _plots_module()
    lim, factor = _plot_limits(ot, ref, chain, planet, n_draws, want["ts"])
    out = [("rv draws", abs(got["rv"] - want["rv"]), lim[13] * factor)]
    row = op.map_row(ref, chain)
    nt, _ = op.orbits_of(ref, row)
    for k, obs in enumerate(op._rv_observations(ref)):
        t = obs.table
        g, w = got["obs"][k], want["obs"][k]
        lim, factor = _plot_limits(ot, ref, chain, planet, None, t["epoch"], rows=row)
        kep = (lim[13] * factor)[0]
        size = np.abs(w["resid"]).max() + np.abs(t["rv"]).max() + np.abs(w["rv_detrended"]).max()
        gp = 0.0
        if getattr(obs, "gaussian_process", None) is not None:
            theta_obs = nt.observations.get(obs.normalized_name, Params())
            jitter = theta_obs.get("jitter", ref.tensor(0.0)).reshape(-1)[0]
            epochs = ref.tensor(t["epoch"])
            K = obs.gaussian_process(theta_obs).matrix(epochs, epochs).reshape(
                len(epochs), len(epochs))
            K = K + torch.diag(ref.tensor(t["σ_rv"]) ** 2 + jitter**2)
            gp = 16 * float(torch.linalg.cond(K)) * F32_HALF_ULP * size
        data = kep + gp + 8 * F32_HALF_ULP * size
        phase = 8 * F32_HALF_ULP * (np.abs(t["epoch"] - want["tp_map"]) / want["P_map"] + 1.0)
        out += [(f"{obs.name} phase", _circular(g["phase"] - w["phase"], 1.0), phase),
                (f"{obs.name} detrended", abs(g["rv_detrended"] - w["rv_detrended"]), data),
                (f"{obs.name} residuals", abs(g["resid"] - w["resid"]), data)]
    return out


def _plot_panel(ot, kk, osk, label, name, model, ref, chain, kwargs) -> dict:
    """One panel's arrays on the card (after one call that warms it up; the
    launch counts set to 0 just before the timed call and read just after)
    and on the CPU, each timed by the host clock; every array held within
    its limit. No backward may run, and the orbits must go through a
    kernel."""
    op = _plots_module()
    from octofitter_tpu_torch.orbits import elements
    from octofitter_tpu_torch.plots import panels

    fn = getattr(op, f"_{name}_arrays", None) or getattr(panels, f"_{name}_arrays")
    # the warm-up call counts the forward kernel's launches by (B, T) and
    # keeps its inputs at each, for (e)
    inputs, fwd_shapes, forward = {}, {}, elements.orbit_solve_forward_cuda

    def keep_inputs(elems, t):
        shape = (elems.shape[1], t.shape[0])
        inputs.setdefault(shape, (elems.clone(), t.clone()))
        fwd_shapes[shape] = fwd_shapes.get(shape, 0) + 1
        return forward(elems, t)

    elements.orbit_solve_forward_cuda = keep_inputs
    try:
        fn(model, chain, **kwargs)
    finally:
        elements.orbit_solve_forward_cuda = forward
    torch.cuda.synchronize()
    _reset_launches(kk, osk)
    t0 = time.perf_counter()
    got = fn(model, chain, **kwargs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _launches(kk, osk)
    if sum(fwd_shapes.values()) != launches["orbit_solve_fwd"]:
        raise AssertionError(f"plots {label}: the warm-up call launched the forward "
                             f"{fwd_shapes}, the timed call {launches['orbit_solve_fwd']} times")
    shapes = {"fwd": fwd_shapes, "kepler": {(s, model.dtype): c for s, c in kk.launch_shapes.items()}}
    t0 = time.perf_counter()
    want = fn(ref, chain, **kwargs)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    worst, detail = 0.0, []
    for key, err, limit in _panel_checks(ot, name, ref, chain, kwargs, got, want):
        err, limit = np.broadcast_arrays(np.asarray(err, dtype=np.float64), limit)
        bad = ~(err <= limit)
        ratio = float(np.max(err / np.where(limit > 0, limit, np.inf), initial=0.0))
        if bad.any() or not np.isfinite(err).all():
            raise AssertionError(
                f"plots {label}: {key} on the card is {float(np.nanmax(err)):.3e} from the CPU's "
                f"at {int(bad.sum())} of {err.size} entries beyond their limits")
        worst = max(worst, ratio)
        detail.append(f"{key} {float(err.max()):.3e} ({ratio:.3f})")
    kern = {k: launches[k] for k in ("orbit_solve_fwd", "orbit_solve_bwd", "kepler_solve")}
    log(f"plots {label}: card {ms:.2f} ms, CPU float64 {cpu_ms:.2f} ms; launches {kern}, "
        f"forward by shape {shapes['fwd']}, kepler_solve by shape {shapes['kepler']}; "
        f"max |card - CPU| (of its limit): {'; '.join(detail)}")
    if launches["orbit_solve_bwd"]:
        raise AssertionError(f"plots {label}: the fused backward ran for a plot")
    if not launches["orbit_solve_fwd"] + launches["kepler_solve"]:
        raise AssertionError(f"plots {label}: no orbit went through a kernel")
    return {"ms": ms, "cpu_ms": cpu_ms, "launches": launches, "shapes": shapes,
            "worst": worst, "arrays": (got, want), "inputs": inputs}


def _mark_checks(ot, ref, chain, n_draws, got, want) -> None:
    """(c): astromplot's sep/PA summary of each marked epoch on the card
    against the CPU's: each mean and spread within the largest move of a
    draw's separation (its position's limits summed) and of its position
    angle (that over the separation)."""
    op = _plots_module()
    lim, _ = _plot_limits(ot, ref, chain, ref.system.planets[0].name, n_draws, want["marks"])
    pos = lim[9] + lim[10]
    sep = np.hypot(want["mark_ra"], want["mark_dec"])
    for k, t_mark in enumerate(want["marks"]):
        s_t = op.mark_summary(got["mark_ra"][:, k], got["mark_dec"][:, k])
        s_c = op.mark_summary(want["mark_ra"][:, k], want["mark_dec"][:, k])
        d_sep, d_pa = float(pos[:, k].max()), float(np.degrees((pos[:, k] / sep[:, k]).max()))
        diffs = (abs(s_t[0] - s_c[0]), abs(s_t[1] - s_c[1]),
                 float(_circular(s_t[2] - s_c[2], 360.0)), abs(s_t[3] - s_c[3]))
        log(f"plots marks n={n_draws} MJD {t_mark:.1f}: card sep {s_t[0]:.4f} ± {s_t[1]:.4f} mas, "
            f"PA {s_t[2]:.5f} ± {s_t[3]:.5f} deg; CPU sep {s_c[0]:.4f} ± {s_c[1]:.4f} mas, "
            f"PA {s_c[2]:.5f} ± {s_c[3]:.5f} deg; differences {[f'{d:.2e}' for d in diffs]} "
            f"(limits {d_sep:.2e} mas, {d_pa:.2e} deg)")
        if not (diffs[0] <= d_sep and diffs[1] <= d_sep and diffs[2] <= d_pa and diffs[3] <= d_pa):
            raise AssertionError(f"plots marks: the card's sep/PA summary at MJD {t_mark} "
                                 f"disagrees with the CPU's: {diffs}")


# (d)'s tables: a GOST forecast over DR4's 66 months (twice GOST_TRANSITS,
# which spans DR3's 34), and one of a hundred such stars in one file
NATIVE_TRANSITS = (2 * GOST_TRANSITS, 200 * GOST_TRANSITS)


def _native_check(directory) -> dict:
    """(d): the native table reader builds (g++, at first use) and reads a
    GOST forecast's numeric columns bit for bit as
    `scanlaw.read_csv_columns` (the `csv` module) does, so that
    `load_gost_csv` of either's columns agree; then
    both readers timed by the host clock at each of NATIVE_TRANSITS."""
    from octofitter_tpu_torch import native
    from octofitter_tpu_torch.astrom import scanlaw

    t0 = time.perf_counter()
    built = native.available()  # builds at first use in the checkout, then cached
    t_build = time.perf_counter() - t0
    if not built:
        raise AssertionError("plots: the native table reader did not build")
    res = {"build_s": t_build, "library": native.library_path().name, "ms": {}}
    for n in NATIVE_TRANSITS:
        path = synth_gost_csv(directory, n=n)
        fast, slow = native.read_csv_columns(path), scanlaw.read_csv_columns(path)
        # a column of text is NaN by the csv module, strtod's leading number natively
        numeric = [k for k in slow if np.isfinite(slow[k]).all()]
        same = list(fast) == list(slow) and all(np.array_equal(fast[k], slow[k]) for k in numeric)
        g_fast, g_slow = scanlaw.load_gost_csv(fast), scanlaw.load_gost_csv(slow)
        same = same and all(np.array_equal(g_fast[k], g_slow[k]) for k in g_slow)
        if not same:
            raise AssertionError(f"plots: the native reader's columns of {n} transits differ "
                                 f"from the csv module's")
        n_iter = 20
        times = {}
        for label, f in (("native", native.read_csv_columns), ("csv", scanlaw.read_csv_columns)):
            t0 = time.perf_counter()
            for _ in range(n_iter):
                f(path)
            times[label] = (time.perf_counter() - t0) / n_iter * 1e3
        res["ms"][n] = times
        log(f"plots native: {n} transits read bit for bit alike by the native reader "
            f"({times['native']:.4f} ms) and the csv module ({times['csv']:.4f} ms), "
            f"{n_iter} reads each by the host clock")
    log(f"plots native: {res['library']} available ({t_build:.2f} s here: it builds with g++ "
        f"at its first use in a checkout)")
    return res


def plots_phase(ot, kk, osk, elements, kepler_mod, main) -> dict:
    """Phase 36, with the card to this process: (a)-(c) each panel on the
    card and on the CPU (`_plot_panel`), (d) the native reader, then (e)
    the forward kernel and the Kepler kernel against their plain versions
    at the shapes the panels launched them with."""
    import tempfile

    t_phase = time.perf_counter()
    op = _plots_module()
    f32 = torch.float32
    res = {"panels": {}, "fwd_shapes": {}, "kepler_shapes": {}}
    fwd_inputs = {}

    def run(label, name, model, ref, chain, kwargs):
        r = _plot_panel(ot, kk, osk, label, name, model, ref, chain, kwargs)
        for part in ("fwd", "kepler"):
            acc = res[f"{part}_shapes"]
            for shape, count in r["shapes"][part].items():
                acc[shape] = acc.get(shape, 0) + count
        for shape, x in r["inputs"].items():
            fwd_inputs.setdefault(shape, x)
        res["panels"][label] = {k: r[k] for k in ("ms", "cpu_ms", "launches", "worst")}
        return r

    def octoplot_panels(case, model, ref, chain):
        for n_draws in PLOT_DRAWS:
            for _, name, kwargs in op._panel_jobs(model, chain, n_draws):
                if name != "masspostplot":
                    run(f"{case} {name} n={n_draws}", name, model, ref, chain, kwargs)

    # (a) octoplot's panels of the headline fit, and (c) its marks
    ref = build_model(ot, main["table"], device="cpu", dtype=torch.float64)
    octoplot_panels("headline", main["model"], ref, main["chain"])
    for n_draws in PLOT_DRAWS:
        r = run(f"headline astromplot marks n={n_draws}", "astromplot", main["model"], ref,
                main["chain"], dict(n_draws=n_draws, mark_epochs_mjd=PLOT_MARKS))
        _mark_checks(ot, ref, main["chain"], n_draws, *r["arrays"])

    # (b) examples/02's joint model, and examples/03's RV-GP model
    n_points = PLOT_POINT_CHAINS * PLOT_POINT_DRAWS
    data = joint_data(ot)
    model = build_joint_model(ot, data, device="cuda", dtype=f32)
    ref = build_joint_model(ot, data, device="cpu", dtype=torch.float64)
    chain = _float32_chain(ot, points_chain(
        ot, ref, joint_points_near_truth(ot, ref, n_points, seed=36), PLOT_POINT_CHAINS))
    octoplot_panels("joint", model, ref, chain)
    data = rvgp_data(ot)
    model = build_rvgp_model(ot, data, device="cuda", dtype=f32)
    ref = build_rvgp_model(ot, data, device="cpu", dtype=torch.float64)
    chain = _float32_chain(ot, points_chain(
        ot, ref, rvgp_points_near_truth(ot, ref, n_points, seed=36), PLOT_POINT_CHAINS))
    for n_draws in PLOT_DRAWS:
        for name in ("rvtimeplot", "rvpostplot"):
            run(f"rv-gp {name} n={n_draws}", name, model, ref, chain, dict(n_draws=n_draws))
    # the per-draw tracks of a basis that has no per-orbit-epoch solve (one
    # `orbitsolve`, so one Kepler launch, per draw): physorbitplot on the
    # headline's relative astrometry on AbsoluteVisual{KepOrbit}, in float64
    # on the card as every AbsoluteVisual path runs, at prior draws
    table = bench_table(ot)
    model = build_basis_model(ot, ABSOLUTE, table, device="cuda", dtype=torch.float64)
    ref = build_basis_model(ot, ABSOLUTE, table, device="cpu", dtype=torch.float64)
    theta = ref.link(ref.sample_priors(torch.Generator().manual_seed(36), n_points))
    chain = points_chain(ot, ref, theta, PLOT_POINT_CHAINS)
    r = run(f"absolute physorbitplot n={PLOT_DRAWS[0]}", "physorbitplot", model, ref, chain,
            dict(n_draws=PLOT_DRAWS[0]))
    if r["launches"]["kepler_solve"] != PLOT_DRAWS[0] or r["launches"]["orbit_solve_fwd"]:
        raise AssertionError(f"plots absolute physorbitplot: launches {r['launches']}, expected "
                             f"the Kepler kernel once per draw and no fused forward")

    with tempfile.TemporaryDirectory() as directory:
        res["native"] = _native_check(directory)
    imported = [m for m in ("matplotlib", "h5py") if m in sys.modules]
    if imported:
        raise AssertionError(f"plots: phase 36 imported {imported}")
    res["seconds_panels"] = time.perf_counter() - t_phase

    # (e) the kernels at the panels' shapes
    res["fwd"] = plots_forward_rows(osk, elements, fwd_inputs)
    res["kepler"] = {}
    for dtype in sorted({d for _, d in res["kepler_shapes"]}, key=str):
        shapes = [s for s, d in res["kepler_shapes"] if d == dtype]
        res["kepler"].update(kepler_path_phase(kk, kepler_mod, shapes, dtypes=(dtype,)))
    res["seconds"] = time.perf_counter() - t_phase
    log(f"plots phase: {res['seconds']:.2f} s ({res['seconds_panels']:.2f} s the panels and the "
        f"native reader, the rest the kernels at their shapes)")
    return res


def _forward_three_ways(osk, elements, elems, t) -> dict:
    """The forward kernel and the float32 plain version on the same float32
    inputs, each against the plain version in float64 on those inputs cast
    to float64, and against each other: {"kernel_vs_plain" |
    "kernel_vs_f64" | "plain_vs_f64": per-field worst share of
    `_field_tolerances` (14,)}, "err": the largest |kernel - plain|, and
    "fields": the rows compared (no sky fields where the orbit has no
    parallax)."""
    has_plx = bool(torch.isfinite(elems[7]).all())

    def plain(x, tt):
        orbit = elements.VisualOrbit(*x) if has_plx else elements.KepOrbit(*x[:7])
        with torch.no_grad():
            return torch.stack(elements._kep_visual_fields(orbit, tt)).double()

    out = osk.orbit_solve_forward_cuda(elems, t).double()
    p32, p64 = plain(elems, t), plain(elems.double(), t.double())
    torch.cuda.synchronize()
    fields = list(range(len(elements.FIELD_ROWS))) if has_plx else [
        k for k in range(len(elements.FIELD_ROWS)) if k not in (9, 10, 11, 12)]
    tol = _field_tolerances(elems, t, p64[0], torch.float32)

    def worst(x, y):
        err = (x - y).abs()
        # the true anomaly is an angle: compare it modulo 2 pi
        err[1] = (torch.remainder(err[1] + math.pi, 2 * math.pi) - math.pi).abs()
        ratio = (err / tol).amax(dim=(1, 2))
        ratio[[k for k in range(len(ratio)) if k not in fields]] = 0.0
        return ratio

    if not bool(torch.isfinite(out[fields]).all()):
        raise AssertionError("plots: the forward kernel returned non-finite values")
    return {"kernel_vs_plain": worst(out, p32), "kernel_vs_f64": worst(out, p64),
            "plain_vs_f64": worst(p32, p64), "err": float((out - p32)[fields].abs().max()),
            "fields": fields}


def plots_forward_rows(osk, elements, inputs) -> dict:
    """(e) for the forward kernel: at each shape (B, T) the panels launched
    it with, the kernel against its plain version, each field within its
    tolerance (`_field_tolerances`), on two sets of inputs: those a panel
    gave it there (the draws' elements and the panel's epochs, kept by
    `_plot_panel`), and `_orbit_inputs`' at (B, T), whose edge chains
    (e = 0.99, a = 0.3 AU up to 120 periods from tp) the earlier shape
    checks hold it on. Both sides are also held to the plain version in
    float64 on the same inputs, the kernel within its tolerance and the
    float32 plain version logged, so that a disagreement names the side
    that errs. Then both are timed on the panel's inputs (plain, kernel,
    kernel, plain). {(B, T): numbers}."""
    f32, rows = torch.float32, {}
    names = elements.FIELD_ROWS
    for (b, n_t), (elems, t) in sorted(inputs.items()):
        label = f"({b}, {n_t})"
        edge_elems, edge_t = _orbit_inputs(b, n_t, f32)
        checks = {"panel": _forward_three_ways(osk, elements, elems, t),
                  "edge": _forward_three_ways(osk, elements, edge_elems, edge_t)}
        for which, c in checks.items():
            parts = []
            for key in ("kernel_vs_plain", "kernel_vs_f64", "plain_vs_f64"):
                k = int(c[key].argmax())
                parts.append(f"{key} {names[k]} {float(c[key][k]):.3f}")
            log(f"plots forward at {label} on the {which} inputs, worst share of the tolerance: "
                f"{'; '.join(parts)}; max |kernel - plain| {c['err']:.3e}")
            for key in ("kernel_vs_plain", "kernel_vs_f64"):
                if not float(c[key].max()) <= 1.0:
                    raise AssertionError(
                        f"plots: the forward kernel at {label} on the {which} inputs, {key}: "
                        f"{dict(zip(names, c[key].tolist()))}")
        orbit = (elements.VisualOrbit(*elems) if bool(torch.isfinite(elems[7]).all())
                 else elements.KepOrbit(*elems[:7]))

        def plain_fwd():
            with torch.no_grad():
                return torch.stack(elements._kep_visual_fields(orbit, t))

        n_iter = 100
        ms_p_a = _time_ms(plain_fwd, n_iter)
        ms_k_a = _time_ms(lambda: osk.orbit_solve_forward_cuda(elems, t), n_iter)
        ms_k_b = _time_ms(lambda: osk.orbit_solve_forward_cuda(elems, t), n_iter)
        ms_p_b = _time_ms(plain_fwd, n_iter)
        rows[(b, n_t)] = dict(
            ms=min(ms_k_a, ms_k_b), plain_ms=min(ms_p_a, ms_p_b),
            err=max(c["err"] for c in checks.values()),
            err_over_tol=max(float(c["kernel_vs_plain"].max()) for c in checks.values()),
            edge={key: float(checks["edge"][key].max())
                  for key in ("kernel_vs_plain", "kernel_vs_f64", "plain_vs_f64")})
        log(f"timing plots forward {label}: kernel {rows[(b, n_t)]['ms']:.4f} ms, plain "
            f"{rows[(b, n_t)]['plain_ms']:.4f} ms (runs: kernel {ms_k_a:.4f}/{ms_k_b:.4f}, "
            f"plain {ms_p_a:.4f}/{ms_p_b:.4f})")
    return rows


def plots_kernel_keys(kernels, res) -> None:
    """Phase 36's entries of the `kernels` line: every kernel's launches by
    panel (`plots_launches`), and the forward kernel's and the Kepler
    kernel's rows at the shapes the panels launched them with
    (`plots_shapes`: float32, and float64 where the label says so; the
    forward's with `edge`, its shares of the tolerance on `_orbit_inputs`'
    edge chains)."""
    f32 = torch.float32
    for k in kernels:
        name = k["name"]
        k["plots_launches"] = {label: p["launches"].get(name, 0)
                               for label, p in res["panels"].items()}
        if name == "kepler_solve":
            k["plots_shapes"] = {}
            for (shape, dtype), count in sorted(res["kepler_shapes"].items(), key=str):
                row, n = res["kepler"][(shape, dtype)], int(np.prod(shape))
                label = str(shape) + ("" if dtype == f32 else " float64")
                bnd = bound_ms(3 * (4 if dtype == f32 else 8) * n, OPS_KEPLER * n, dtype)
                k["plots_shapes"][label] = {
                    "launches": count, "max_abs_err": row["err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": bnd[0], "bound_by": bnd[1]}
        elif name == "orbit_solve_fwd":
            k["plots_shapes"] = {}
            for (b, t), count in sorted(res["fwd_shapes"].items()):
                row = res["fwd"][(b, t)]
                bnd = bound_ms(4 * (8 * b + t + 14 * b * t), OPS_ORBIT_FWD * b * t, f32)
                k["plots_shapes"][f"({b}, {t})"] = {
                    "launches": count, "max_abs_err": row["err"],
                    "max_err_over_tol": row["err_over_tol"], "edge": row["edge"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": bnd[0], "bound_by": bnd[1]}


# After the main path, the longest paths run in processes of their own
# (`_Workers`), each on the same card beside this one: an evaluation keeps
# the card busy for under a fifth of its host time (PERF.md §5), so the
# processes' host dispatch overlaps. Each job is one module-level function
# of (ot, kk, osk, state) whose result crosses back through `_portable`;
# every kernel check and timing against a plain version runs in this
# process once the jobs have ended, with the card to itself.
WORKER_THREADS = 2  # torch's CPU threads in each job's process


def _job_nuts_joint(ot, kk, osk, state) -> dict:
    """NUTS and HMC on the headline model from the main path's starting
    points and Laplace covariance, then the joint fit."""
    model = build_model(ot, bench_table(ot), device="cuda", dtype=torch.float32)
    model.starting_points = model.tensor(state["starting_points"])
    model.laplace_sigma = model.tensor(state["laplace_sigma"])
    nuts = nuts_path_phase(ot, kk, osk, model)
    joint = joint_path_phase(ot, kk, osk, CHAINS, JOINT_ADAPTATION, JOINT_ITERATIONS)
    return {"nuts": nuts, "joint": joint}


def _job_discrete(ot, kk, osk, state) -> dict:
    """The calibration fit, then the outlier fit from its starting points."""
    cal = calibration_phase(ot, kk, osk)
    return {"cal": cal, "outlier": outlier_phase(ot, kk, osk, cal["model"])}


def _job_rvgp_absolute(ot, kk, osk, state) -> dict:
    """The RV-GP fit, then the absolute-astrometry paths, without their
    kernel checks."""
    from octofitter_tpu_torch.orbits import elements
    from octofitter_tpu_torch.orbits import kepler as kepler_mod

    rvgp = rvgp_phase(ot, kk, osk, checks=False, kepler_rows=False)
    absolute = absolute_astrometry_phases(ot, kk, osk, elements, kepler_mod,
                                          kernel_steps=False)
    return {"rvgp": rvgp, "absolute": absolute}


def _job_ex05(ot, kk, osk, state) -> dict:
    """examples/05's fits and the likelihood-map and GRAVITY evaluations,
    without their kernel checks."""
    return ex05_phases(ot, kk, osk)


def _job_evidence(ot, kk, osk, state) -> dict:
    """Nested sampling against the grid and on examples/04's models, the
    NSS warm start, then the ladder and the chains across processes from
    the main path's starting points and Laplace covariance (phases 30, 31,
    34 and 35)."""
    return {"nested": nested_evidence_phase(ot, kk, osk), "ex04": ex04_nested_phase(ot, kk, osk),
            "nss": nss_phase(ot, kk, osk), "parallel": parallel_phase(ot, kk, osk, state)}


def _job_validation(ot, kk, osk, state) -> dict:
    """SBC and the completeness map (phase 33); the scan law in a temporary
    directory."""
    import tempfile

    sbc = sbc_phase(ot, kk, osk)
    with tempfile.TemporaryDirectory() as directory:
        return {"sbc": sbc, "completeness": completeness_phase(ot, kk, osk, directory)}


JOBS = {"nuts_joint": _job_nuts_joint, "discrete": _job_discrete,
        "rvgp_absolute": _job_rvgp_absolute, "ex05": _job_ex05, "evidence": _job_evidence,
        "validation": _job_validation}
_DROPPED = object()


def _portable(obj):
    """`obj` with what another process cannot load left out (models,
    chains) and tensors moved to the host."""
    if isinstance(obj, dict):
        out = {k: _portable(v) for k, v in obj.items()}
        return {k: v for k, v in out.items() if v is not _DROPPED}
    if isinstance(obj, (list, tuple)):
        out = [_portable(v) for v in obj]
        return _DROPPED if any(v is _DROPPED for v in out) else type(obj)(out)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if obj is None or isinstance(obj, (bool, int, float, str, np.ndarray, np.generic,
                                       torch.dtype)):
        return obj
    return _DROPPED


def _worker(job, state, log_path, out_path, repo, target=None) -> None:
    """A job's process: runs `target` (by default JOBS[job]), its log in
    `log_path` and its portable result pickled into `out_path`; exits 1 on
    any failure."""
    import pickle
    import traceback

    with open(log_path, "w", buffering=1) as f, contextlib.redirect_stdout(f), \
            contextlib.redirect_stderr(f):
        try:
            sys.path.insert(0, repo)
            torch.set_num_threads(WORKER_THREADS)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            import octofitter_tpu_torch as ot
            from octofitter_tpu_torch.orbits.kernels import kepler as kk
            from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk

            t0 = time.perf_counter()
            res = _portable((target or JOBS[job])(ot, kk, osk, state))
            log(f"job {job}: {time.perf_counter() - t0:.2f} s in its own process")
            with open(out_path, "wb") as g:
                pickle.dump(res, g)
        except BaseException:
            traceback.print_exc()
            f.flush()
            os._exit(1)


class _Workers:
    """The jobs' processes (spawned: CUDA does not survive a fork), their
    logs and results under `directory`; leaving the block stops every
    process still running."""

    def __init__(self, directory):
        import multiprocessing

        self.ctx = multiprocessing.get_context("spawn")
        self.directory = Path(directory)
        self.procs = {}
        self.joined = set()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        for job, proc in self.procs.items():
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
            if exc_type is not None and job not in self.joined:
                self._print_log(job, proc)
        return False

    def start(self, job, state=None, target=None) -> None:
        """Start `job`: JOBS[job], or `target` under the name `job`."""
        proc = self.ctx.Process(
            target=_worker, name=job,
            args=(job, state, str(self.directory / f"{job}.log"),
                  str(self.directory / f"{job}.pkl"), str(Path(__file__).resolve().parent),
                  target))
        proc.start()
        self.procs[job] = proc

    def _print_log(self, job, proc) -> None:
        path = self.directory / f"{job}.log"
        log(f"--- job {job} (process {proc.pid}, exit code {proc.exitcode}): its log ---")
        log(path.read_text().rstrip() if path.exists() else "(no log)")
        log(f"--- end of job {job} ---")

    def join(self, job) -> dict:
        """Wait for `job`, print its log, and return its result; raise if
        it failed."""
        import pickle

        proc = self.procs[job]
        proc.join()
        self.joined.add(job)
        self._print_log(job, proc)
        if proc.exitcode != 0:
            raise AssertionError(f"job {job} failed (exit code {proc.exitcode})")
        with open(self.directory / f"{job}.pkl", "rb") as f:
            return pickle.load(f)

    def join_all(self, jobs, timeout_s) -> list:
        """`join` each of `jobs`, which work together (a process group):
        the first to fail, or `timeout_s` passing, stops the others, which
        would wait for it in a collective."""
        procs = [self.procs[job] for job in jobs]
        deadline = time.monotonic() + timeout_s
        while (any(p.exitcode is None for p in procs)
               and all(p.exitcode in (None, 0) for p in procs)):
            if time.monotonic() > deadline:
                log(f"jobs {jobs}: not ended within {timeout_s} s")
                break
            procs[0].join(timeout=1)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        failed = [job for job, p in zip(jobs, procs) if p.exitcode != 0]
        for job in failed:
            self.joined.add(job)
            self._print_log(job, self.procs[job])
        if failed:
            raise AssertionError(f"jobs {failed} failed (exit codes "
                                 f"{[self.procs[j].exitcode for j in failed]})")
        return [self.join(job) for job in jobs]


def main() -> int:
    import tempfile

    t_main = time.perf_counter()

    def elapsed(after):
        log(f"elapsed {time.perf_counter() - t_main:.1f} s after {after}")

    name, _ = device_phase()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.orbits import elements
    from octofitter_tpu_torch.orbits import kepler as kepler_mod
    from octofitter_tpu_torch.orbits.kernels import kepler as kk
    from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    # full float32 in matrix products and convolutions (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase([kk.SOURCE, osk.SOURCE, cc.SOURCE])
    elapsed("build_phase")
    kres = kernel_phase(kk, kepler_mod._markley, CHAINS)
    elapsed("kernel_phase")
    ores = orbit_phase(osk, elements, CHAINS)
    elapsed("orbit_phase")
    main = main_path_phase(ot, kk, osk, CHAINS, ADAPTATION, ITERATIONS)
    elapsed("main_path_phase")
    pres = kepler_path_phase(kk, kepler_mod, main["kepler_shapes"])
    elapsed("kepler_path_phase")
    fused_vs_composed_phase(ot, main["model"], main["chain"], main["table"], CHAINS)
    elapsed("fused_vs_composed_phase")

    # the jobs beside this process's own paths; then the jobs' results
    threads = torch.get_num_threads()
    with tempfile.TemporaryDirectory() as directory, _Workers(directory) as workers:
        headline_state = {"starting_points": main["model"].starting_points.cpu(),
                          "laplace_sigma": main["model"].laplace_sigma.cpu()}
        pa_init = os.path.join(directory, "pa_init.pt")
        workers.start("nuts_joint", headline_state)
        workers.start("discrete")
        workers.start("rvgp_absolute")
        workers.start("ex05")
        workers.start("evidence", dict(headline_state, pa_init=pa_init))
        workers.start("validation")
        log("started jobs nuts_joint, discrete, rvgp_absolute, ex05, evidence and validation in "
            "processes of their own")
        cpus = min(threads, len(os.sched_getaffinity(0)))
        torch.set_num_threads(max(WORKER_THREADS, cpus - len(workers.procs) * WORKER_THREADS))
        pt = pt_path_phase(ot, kk, osk, PT_ROUNDS, share_init=pa_init)
        elapsed("pt_path_phase")
        pt_nuts = pt_nuts_phase(ot, kk, osk, pt["model"])
        elapsed("pt_nuts_phase")
        rej = rejection_phase(ot, kk, osk)
        elapsed("rejection_phase")
        cap = cap_phase(ot, kk, osk)
        elapsed("cap_phase")
        g23h = g23h_phases(ot, kk, osk, elements, kepler_mod, kernel_step=False)
        elapsed("g23h_phases")
        cv = cv_phase(ot, kk, osk, main)
        elapsed("cv_phase")
        done = {job: workers.join(job) for job in JOBS}
        elapsed("the jobs")
    torch.set_num_threads(threads)
    nuts, joint = done["nuts_joint"]["nuts"], done["nuts_joint"]["joint"]
    cal, outlier = done["discrete"]["cal"], done["discrete"]["outlier"]
    rvgp, absolute = done["rvgp_absolute"]["rvgp"], done["rvgp_absolute"]["absolute"]
    ex05 = done["ex05"]

    # every kernel against its plain version at the shapes the paths gave it
    jres = kepler_path_phase(kk, kepler_mod, joint["kepler_shapes"])
    ptres = kepler_path_phase(kk, kepler_mod, pt["kepler_shapes"])
    rres = kepler_path_phase(kk, kepler_mod, rej["kepler_shapes"])
    cres = kepler_path_phase(kk, kepler_mod, cal["kepler_shapes"])
    elapsed("kepler_path_phase (joint, PT, rejection, calibration)")
    diagnostics_phase(ot, [("headline", main["x"]), ("joint", joint["x"])])
    elapsed("diagnostics_phase")
    dres = discrete_kernel_phase(osk, elements)
    elapsed("discrete_kernel_phase")
    rvgp.update(rvgp_phase(ot, kk, osk, fit=False))
    t_step = time.perf_counter()
    gres = kepler_path_phase(kk, kepler_mod, rvgp["kepler_shapes"])
    log(f"rv-gp Kepler step: {time.perf_counter() - t_step:.2f} s")
    elapsed("rvgp checks")
    absolute_kernel_step(kk, osk, elements, kepler_mod, absolute)
    g23h_kernel_step(kk, osk, elements, kepler_mod, g23h)
    elapsed("absolute-astrometry and g23h kernel steps")
    ex05_kernel_step(kk, osk, elements, kepler_mod, ex05)
    elapsed("examples/05 kernel step")
    evidence = {"evidence": done["evidence"], "validation": done["validation"], "cv": cv}
    evidence_kernel_step(osk, elements, evidence)
    elapsed("evidence and validation kernel step")
    parallel = done["evidence"]["parallel"]
    parallel_kernel_step(osk, elements, parallel)
    elapsed("parallel kernel step")
    plots = plots_phase(ot, kk, osk, elements, kepler_mod, main)
    elapsed("plots phase")

    f32 = torch.float32
    small, big = f"({CHAINS}, {N_EPOCHS})", f"({BIG_CHAINS}, {BIG_EPOCHS})"
    jshape = f"({CHAINS}, {JOINT_EPOCHS})"
    n_small = CHAINS * N_EPOCHS

    def fwd_bound(b, t):
        return bound_ms(4 * (8 * b + t + 14 * b * t), OPS_ORBIT_FWD * b * t, f32)

    def bwd_bound(b, t):  # reads the elements, the epochs, E and the cotangent
        return bound_ms(4 * (8 * b + t + 15 * b * t + 8 * b), OPS_ORBIT_BWD * b * t, f32)

    # the standalone kernel's row is at the largest shape the main path
    # launched it with (the Laplace step's); the composed path's shape,
    # which only this script's comparisons run, goes under its own keys
    path_shape = max(main["kepler_shapes"], key=lambda s: int(np.prod(s)))
    path_row = pres[(path_shape, f32)]
    path_row["err_over_tol"] = path_row["err"] / TOL[f32]
    joint_kepler_shape = max(joint["kepler_shapes"], key=lambda s: int(np.prod(s)))
    joint_kepler_row = jres[(joint_kepler_shape, f32)]
    # each kernel at the joint path's shape: (row, bound)
    joint_rows = {
        "kepler_solve": (joint_kepler_row, bound_ms(12 * joint_kepler_row["n"],
                                                    OPS_KEPLER * joint_kepler_row["n"], f32)),
        "orbit_solve_fwd": (ores["fwd"][(jshape, f32)], fwd_bound(CHAINS, JOINT_EPOCHS)),
        "orbit_solve_bwd": (ores["bwd"][(jshape, f32)], bwd_bound(CHAINS, JOINT_EPOCHS)),
    }
    # and at the partial-arc PT path's: the whole ladder in every fused call
    pt_shape = f"({PT_CHAINS}, {N_EPOCHS})"
    pt_kepler_shape = max(pt["kepler_shapes"], key=lambda s: int(np.prod(s)))
    pt_kepler_row = ptres[(pt_kepler_shape, f32)]
    pt_rows = {
        "kepler_solve": (str(pt_kepler_shape), pt_kepler_row,
                         bound_ms(12 * pt_kepler_row["n"], OPS_KEPLER * pt_kepler_row["n"], f32)),
        "orbit_solve_fwd": (pt_shape, ores["fwd"][(pt_shape, f32)], fwd_bound(PT_CHAINS, N_EPOCHS)),
        "orbit_solve_bwd": (pt_shape, ores["bwd"][(pt_shape, f32)], bwd_bound(PT_CHAINS, N_EPOCHS)),
    }
    # the NUTS path's shape; the NUTS explorer's ladder has the headline's
    nshape = f"({NUTS_CHAINS}, {N_EPOCHS})"
    pt_nuts_shape = f"({PT_NUTS_CHAINS}, {N_EPOCHS})"
    nuts_rows = {
        "orbit_solve_fwd": (ores["fwd"][(nshape, f32)], fwd_bound(NUTS_CHAINS, N_EPOCHS)),
        "orbit_solve_bwd": (ores["bwd"][(nshape, f32)], bwd_bound(NUTS_CHAINS, N_EPOCHS)),
    }
    # the rejection path's bulk shape, float64: reads M and e, writes E
    f64 = torch.float64
    rej_shape = (REJECTION_KWARGS["batch_size"], OFTI_EPOCHS)
    rej_row = rres[(rej_shape, f64)]
    rej_bound = bound_ms(24 * rej_row["n"], OPS_KEPLER * rej_row["n"], f64)
    kernels = []
    for kname, source, replaces, shape, row, row_big, bnd, bnd_big in (
        ("kepler_solve", "kepler.cu", "octofitter_tpu/orbits/pallas_kepler.py:103",
         str(path_shape), path_row, dict(zip(("ms", "plain_ms"), kres["timing"][("2^23", f32)])),
         bound_ms(12 * path_row["n"], OPS_KEPLER * path_row["n"], f32),
         bound_ms(12 * 2**23, OPS_KEPLER * 2**23, f32)),
        ("orbit_solve_fwd", "orbit_solve.cu", "octofitter_tpu/orbits/pallas_kepler.py:103",
         small, ores["fwd"][(small, f32)], ores["fwd"][(big, f32)],
         fwd_bound(CHAINS, N_EPOCHS), fwd_bound(BIG_CHAINS, BIG_EPOCHS)),
        ("orbit_solve_bwd", "orbit_solve.cu", "octofitter_tpu/orbits/kepler.py:67",
         small, ores["bwd"][(small, f32)], ores["bwd"][(big, f32)],
         bwd_bound(CHAINS, N_EPOCHS), bwd_bound(BIG_CHAINS, BIG_EPOCHS)),
    ):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"octofitter_tpu_torch/orbits/kernels/csrc/{source}",
            "replaces": replaces,
            "launches": main["launches"][kname],
            "max_abs_err": row["err"],
            "max_err_over_tol": row.get("err_over_tol"),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": bnd[0],
            "bound_by": bnd[1],
            "library_ms": None,  # no single PyTorch call computes this function
            "shape": shape,
            "large_shape": "2^23" if kname == "kepler_solve" else big,
            "large_ms": row_big["ms"],
            "large_plain_ms": row_big["plain_ms"],
            "large_bound_ms": bnd_big[0],
            "large_bound_by": bnd_big[1],
            "joint_shape": (str(joint_kepler_shape) if kname == "kepler_solve" else jshape),
            "joint_launches": joint["launches"][kname],
            "joint_max_abs_err": joint_rows[kname][0]["err"],
            "joint_ms": joint_rows[kname][0]["ms"],
            "joint_plain_ms": joint_rows[kname][0]["plain_ms"],
            "joint_bound_ms": joint_rows[kname][1][0],
            "pt_shape": pt_rows[kname][0],
            "pt_launches": pt["launches"][kname],
            "pt_max_abs_err": pt_rows[kname][1]["err"],
            "pt_ms": pt_rows[kname][1]["ms"],
            "pt_plain_ms": pt_rows[kname][1]["plain_ms"],
            "pt_bound_ms": pt_rows[kname][2][0],
            "nuts_launches": nuts["launches"][kname],
            "hmc_launches": nuts["hmc_launches"][kname],
            "pt_nuts_launches": pt_nuts["launches"][kname],
            "rejection_launches": rej["launches"][kname],
        })
        if kname in nuts_rows:
            kernels[-1].update({
                "nuts_shape": nshape,
                "nuts_max_abs_err": nuts_rows[kname][0]["err"],
                "nuts_ms": nuts_rows[kname][0]["ms"],
                "nuts_plain_ms": nuts_rows[kname][0]["plain_ms"],
                "nuts_bound_ms": nuts_rows[kname][1][0],
                "pt_nuts_shape": pt_nuts_shape,
            })
    # the discrete paths: the calibration fit (marginalized, K = 2), the
    # outlier fit (Gibbs) and the cap case (K = 4096), each kernel at the
    # shapes they launch it with
    marg_shape, sweep_shape = f"({2 * CHAINS}, {N_EPOCHS})", f"({2 * CHAINS}, {OUTLIER_EPOCHS})"
    gibbs_shape = f"({CHAINS}, {OUTLIER_EPOCHS})"
    cap_shape = f"({CAP_CHAINS * 4096}, {CAP_EPOCHS})"
    cal_kepler_shape = max(cal["kepler_shapes"], key=lambda s: int(np.prod(s)))
    cal_kepler_row = cres[(cal_kepler_shape, f32)]
    discrete_rows = {
        "marg": (cal_kepler_row, bound_ms(12 * cal_kepler_row["n"],
                                          OPS_KEPLER * cal_kepler_row["n"], f32))}
    for kname in ("orbit_solve_fwd", "orbit_solve_bwd"):
        part = "fwd" if kname.endswith("fwd") else "bwd"
        bnd = fwd_bound if part == "fwd" else bwd_bound
        for key, label, b, t in (("marg", marg_shape, 2 * CHAINS, N_EPOCHS),
                                 ("gibbs", gibbs_shape, CHAINS, OUTLIER_EPOCHS),
                                 ("gibbs_sweep", sweep_shape, 2 * CHAINS, OUTLIER_EPOCHS),
                                 ("cap", cap_shape, CAP_CHAINS * 4096, CAP_EPOCHS)):
            discrete_rows[(kname, key)] = (label, dres[part][(label, f32)], bnd(b, t))
    for k in kernels:
        kname = k["name"]
        k.update({"marg_launches": cal["launches"][kname],
                  "gibbs_launches": outlier["launches"][kname],
                  "cap_launches": cap["launches"][kname]})
        if kname == "kepler_solve":
            row, bnd = discrete_rows["marg"]
            k.update({"marg_shape": str(cal_kepler_shape), "marg_max_abs_err": row["err"],
                      "marg_ms": row["ms"], "marg_plain_ms": row["plain_ms"],
                      "marg_bound_ms": bnd[0]})
            continue
        for key in ("marg", "gibbs", "gibbs_sweep", "cap"):
            label, row, bnd = discrete_rows[(kname, key)]
            k.update({f"{key}_shape": label, f"{key}_max_abs_err": row["err"],
                      f"{key}_ms": row["ms"], f"{key}_plain_ms": row["plain_ms"],
                      f"{key}_bound_ms": bnd[0]})
    composed_ms, composed_plain_ms = kres["timing"][(small, f32)]
    kernels[0].update({
        "max_abs_err_f64": pres[(path_shape, torch.float64)]["err"],
        "launch_shapes": {str(s): k for s, k in main["kepler_shapes"].items()},
        "composed_shape": small,
        "composed_max_abs_err": kres["errs"][f32],
        "composed_ms": composed_ms,
        "composed_plain_ms": composed_plain_ms,
        "composed_bound_ms": bound_ms(12 * n_small, OPS_KEPLER * n_small, f32)[0],
        "rejection_shape": str(rej_shape),
        "rejection_dtype": "float64",
        "rejection_launch_shapes": {str(sh): k for sh, k in rej["kepler_shapes"].items()},
        "rejection_max_abs_err": rej_row["err"],
        "rejection_ms": rej_row["ms"],
        "rejection_plain_ms": rej_row["plain_ms"],
        "rejection_bound_ms": rej_bound[0],
        "rejection_bound_by": rej_bound[1],
    })
    # the RV-GP path: the standalone Kepler kernel at the fit's chains x 80
    # epochs (every evaluation), and the celerite pair at its shapes
    rvgp_kepler_shape = (CHAINS, RVGP_EPOCHS)
    rvgp_kepler_row = gres[(rvgp_kepler_shape, f32)]
    kernels[0].update({
        "rvgp_launches": rvgp["launches"]["kepler_solve"],
        "rvgp_launch_shapes": {str(sh): k for sh, k in rvgp["kepler_shapes"].items()},
        "rvgp_shape": str(rvgp_kepler_shape),
        "rvgp_max_abs_err": rvgp_kepler_row["err"],
        "rvgp_ms": rvgp_kepler_row["ms"],
        "rvgp_plain_ms": rvgp_kepler_row["plain_ms"],
        "rvgp_bound_ms": bound_ms(12 * rvgp_kepler_row["n"], OPS_KEPLER * rvgp_kepler_row["n"],
                                  f32)[0],
    })
    for k in kernels:
        k["rvgp_launches"] = rvgp["launches"][k["name"]]
    main_label = _cel_label(CHAINS, RVGP_EPOCHS, 1)
    for part in ("fwd", "bwd"):
        shapes = {}
        for label, row in rvgp["celerite"]["shapes"].items():
            bnd = celerite_bound(row["B"], row["n"], row["J"], part)
            shapes[label] = {
                "ms": row[part], "device_us": row["device_us"].get(part),
                "plain_ms": row[f"plain_{part}"], "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": row[f"library_{part}"],
                "ll_err": row["ll_err"], "grad_err": row["grad_err"],
                "err_over_tol": row["err_over_tol"], "ll_err_f64": row["ll_err_f64"],
                "grad_err_f64": row["grad_err_f64"]}
        main_row = shapes[main_label]
        kernels.append({
            "name": f"celerite_{part}",
            "route": "cuda",
            "source": "octofitter_tpu_torch/rv/csrc/celerite.cu",
            "replaces": "octofitter_tpu/rv/celerite.py:111",
            "replaces_what": "the lax.scan recursion of celerite.py:111-173 (no Pallas kernel)",
            "launches": rvgp["launches"][f"celerite_{part}"],
            "max_abs_err": main_row["ll_err"] if part == "fwd" else main_row["grad_err"],
            "max_err_over_tol": main_row["err_over_tol"],
            "error_measure": ("log-likelihood, worst row, relative to max(|ll|, 1)" if part == "fwd"
                              else "gradient, worst row, relative to its largest entry"),
            "ms": main_row["ms"],
            "device_us": main_row["device_us"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "occupancy": {k: v for k, v in rvgp["celerite"]["occupancy"].items()
                          if k.endswith(part)},
            "library_calls": "celerite dense matrix + torch.linalg.cholesky_ex + "
                             "torch.linalg.solve_triangular" + (" (autograd)" if part == "bwd" else ""),
            "shape": main_label,
            "shapes": shapes,
            "launch_shapes": {str(sh): k for sh, k in rvgp["celerite_shapes"].items()},
            "rvgp_evaluation_us": rvgp["evaluation"]["us"],
            "rvgp_evaluation_device_ops": rvgp["evaluation"]["ops"],
            "rvgp_evaluation_busy_us": rvgp["evaluation"]["busy_us"],
            "rvgp_laplace": rvgp["laplace"],
        })
    kernels[-1]["associative"] = rvgp["extra"]["assoc"]
    absolute_kernel_keys(kernels, absolute)
    g23h_kernel_keys(kernels, g23h)
    ex05_kernel_keys(kernels, ex05)
    evidence_kernel_keys(kernels, evidence, ores)
    parallel_kernel_keys(kernels, parallel)
    plots_kernel_keys(kernels, plots)
    if tuple(k["name"] for k in kernels) != KERNEL_NAMES:
        raise AssertionError(f"the kernels line names {[k['name'] for k in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
