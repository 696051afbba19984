"""Simulation-based-calibration rank plots.

A copy of `octofitter_tpu/plots/sbc_plots.py`, matplotlib imported when a
figure is drawn. Counterpart of the reference's `calibrationplots`
(`src/sbc.jl:215-250`): per-parameter rank-statistic
histograms (uniform under a calibrated pipeline) plus a rank corner
plot. Input is the output of `analysis.sbc.calibrate` — a dict
``{name: {"ranks": array, "ks_distance": float}}`` — or a plain
``{name: array}`` of ranks in [0, 1].

Design: one series per panel (no legend needed); the shaded band is the
central 99% binomial envelope of a uniform histogram, so miscalibration
reads as bars escaping the band rather than by eyeballing flatness.
"""

from __future__ import annotations

import numpy as np

from ._util import pyplot


def _rank_arrays(results) -> dict:
    out = {}
    for k, v in results.items():
        if isinstance(v, dict):
            v = v.get("ranks")
        v = np.asarray(v, dtype=float).reshape(-1)
        if v.size:
            out[k] = v
    return out


def calibrationplots(results, *, n_bins=None, fname=None):
    """Rank-uniformity histograms, one panel per parameter.

    n_bins defaults to floor(sqrt(n_trials)) like the reference
    (`sbc.jl:234`). Returns the figure.
    """
    plt = pyplot("calibrationplots")
    ranks = _rank_arrays(results)
    if not ranks:
        raise ValueError("calibrationplots: no rank arrays in results")
    names = list(ranks)
    k = len(names)
    ncol = min(4, k)
    nrow = (k + ncol - 1) // ncol
    fig, axes = plt.subplots(
        nrow, ncol, figsize=(2.6 * ncol, 2.2 * nrow), squeeze=False
    )
    for ax in axes.flat[k:]:
        ax.set_visible(False)
    for ax, name in zip(axes.flat, names):
        r = ranks[name]
        n = len(r)
        nb = n_bins or max(2, int(np.floor(np.sqrt(n))))
        # central 99% binomial envelope for a uniform histogram
        from scipy import stats as sps

        lo = sps.binom.ppf(0.005, n, 1.0 / nb)
        hi = sps.binom.ppf(0.995, n, 1.0 / nb)
        ax.axhspan(lo, hi, color="0.85", zorder=0)
        ax.axhline(n / nb, color="0.55", lw=1, zorder=1)
        ax.hist(
            r, bins=np.linspace(0, 1, nb + 1), color="C0",
            histtype="stepfilled", alpha=0.8, zorder=2,
        )
        ks = None
        if isinstance(results.get(name), dict):
            ks = results[name].get("ks_distance")
        title = name if ks is None else f"{name}  (KS {ks:.2f})"
        ax.set_title(title, fontsize=8)
        ax.set_xlim(0, 1)
        ax.set_yticks([])
        ax.tick_params(labelsize=7)
    fig.suptitle("SBC rank statistics", fontsize=10)
    fig.tight_layout()
    if fname:
        fig.savefig(fname, dpi=150)
    return fig


def sbc_corner(results, *, n_bins=5, fname=None):
    """Pairwise 2-D rank histograms (the reference's rank corner,
    `sbc.jl:242-245`): joint uniformity, coarse bins."""
    plt = pyplot("sbc_corner")
    ranks = _rank_arrays(results)
    names = list(ranks)
    k = len(names)
    if k == 0:
        raise ValueError("sbc_corner: no rank arrays in results")
    fig, axes = plt.subplots(k, k, figsize=(1.8 * k, 1.8 * k), squeeze=False)
    edges = np.linspace(0, 1, n_bins + 1)
    for i, vy in enumerate(names):
        for j, vx in enumerate(names):
            ax = axes[i][j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(ranks[vx], bins=edges, color="C0",
                        histtype="stepfilled", alpha=0.8)
                ax.set_yticks([])
            else:
                ax.hist2d(ranks[vx], ranks[vy], bins=[edges, edges],
                          cmap="Blues")
            if i == k - 1:
                ax.set_xlabel(vx, fontsize=8)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(vy, fontsize=8)
            else:
                ax.set_yticklabels([])
            ax.tick_params(labelsize=7)
    fig.tight_layout(h_pad=0.1, w_pad=0.1)
    if fname:
        fig.savefig(fname, dpi=150)
    return fig
