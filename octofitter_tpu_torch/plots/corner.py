"""Corner plots.

A copy of `octofitter_tpu/plots/corner.py` (numpy and matplotlib over a
Chains), matplotlib imported when a figure is drawn. Equivalent of the
reference's `octocorner`
(`ext/OctofitterPairPlotsExt.jl:15-236`): an N x N
marginal/joint grid over the posterior, including derived quantities
(they are already columns of our Chains object).
"""

from __future__ import annotations

import numpy as np

from ._util import pyplot


def _hist2d(ax, x, y, bins=40):
    h, xe, ye = np.histogram2d(x, y, bins=bins)
    h = h.T
    # contour levels enclosing ~39%, 86%, 98% of mass (1/2/3 sigma 2D)
    hs = np.sort(h.reshape(-1))[::-1]
    cum = np.cumsum(hs) / hs.sum()
    levels = []
    for frac in (0.989, 0.865, 0.393):
        i = np.searchsorted(cum, frac)
        levels.append(hs[min(i, len(hs) - 1)])
    levels = sorted(set(l for l in levels if l > 0))
    xc = 0.5 * (xe[1:] + xe[:-1])
    yc = 0.5 * (ye[1:] + ye[:-1])
    ax.contourf(xc, yc, h, levels=levels + [h.max() + 1], cmap="Blues", alpha=0.8)
    ax.contour(xc, yc, h, levels=levels, colors="C0", linewidths=0.7)


def octocorner(model_or_chain, chain=None, *, variables=None, small=False,
               fname=None, truths=None):
    """Corner plot of posterior (and derived) quantities.

    octocorner(model, chain) or octocorner(chain). `small=True` keeps
    only the headline orbit parameters per planet, like the reference's
    `small=true` mode.
    """
    if chain is None:
        chain = model_or_chain
        model = None
    else:
        model = model_or_chain

    if variables is None:
        variables = list(chain.data.keys())
        if small and model is not None:
            keep = []
            for n in variables:
                base = n.split("_")[-1]
                if base in ("a", "e", "i", "mass", "M", "plx", "tp", "P"):
                    keep.append(n)
            variables = keep or variables
        # drop auxiliary x/y components of UniformCircular by default
        variables = [
            v for v in variables
            if not (v.endswith("x") and v[:-1] + "y" in chain.data)
            and not (v.endswith("y") and v[:-1] + "x" in chain.data)
        ]

    plt = pyplot("octocorner")
    data = {v: chain.flat(v) for v in variables}
    # drop constant columns (break histogramming)
    variables = [v for v in variables if np.std(data[v]) > 0]
    k = len(variables)
    if k == 0:
        raise ValueError(
            "octocorner: no non-constant columns to plot (did the "
            "sampler return a single draw?)"
        )
    fig, axes = plt.subplots(k, k, figsize=(1.8 * k, 1.8 * k))
    if k == 1:
        axes = np.array([[axes]])
    for i, vy in enumerate(variables):
        for j, vx in enumerate(variables):
            ax = axes[i, j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(data[vx], bins=50, color="C0", histtype="stepfilled", alpha=0.7)
                if truths and vx in truths:
                    ax.axvline(truths[vx], color="C3", lw=1)
                ax.set_yticks([])
            else:
                _hist2d(ax, data[vx], data[vy])
                if truths and vx in truths and vy in truths:
                    ax.plot(truths[vx], truths[vy], "s", color="C3", ms=4)
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
