"""BDCM entropy and consensus plots, the port of ``graphdyn/plotting.py``.

The reference notebook exists to compute "BDCM entropy plots"
(`code/README.md:1`); it stores result grids and the author plots the tilted
entropy ``s(m_init) = φ + λ·m_init`` against the BP mean initial
magnetization, one curve per mean degree. These helpers render exactly that
from the solver results, headless (Agg backend) so they work on hosts with
no display. matplotlib is imported lazily — the rest of the framework
has no hard dependency on it.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def masked_mean(values, visited=None, axis: int = 0) -> np.ndarray:
    """Mean of ``values`` over ``axis`` restricted to ``visited`` AND finite
    entries; positions with no contributing entries give NaN (so downstream
    finite-masking drops them). The one masking rule shared by the grid
    'mean' plot and the CLI's union-ensemble member mean — degraded −inf/NaN
    members must not poison the mean of the finite ones at the same λ."""
    v = np.asarray(values, float)
    ok = np.isfinite(v)
    if visited is not None:
        ok &= visited
    cnt = ok.sum(axis=axis)
    mean = np.where(ok, v, 0.0).sum(axis=axis) / np.maximum(cnt, 1)
    return np.where(cnt == 0, np.nan, mean)


def plot_entropy_curve(result, *, ax=None, label=None, save_path=None):
    """Plot one tilted-entropy curve s(m_init) from an
    :class:`~graphdyn_torch.models.entropy.EntropyResult` (or any object with
    ``m_init``/``ent1`` arrays over the visited λ ladder).

    Points where the entropy degraded to −inf (empty attractor set) are
    dropped. Returns the matplotlib Axes."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 3.6), dpi=120)
    m = np.asarray(result.m_init, float).reshape(-1)
    s = np.asarray(result.ent1, float).reshape(-1)
    keep = np.isfinite(m) & np.isfinite(s)
    ax.plot(m[keep], s[keep], marker="o", ms=3, lw=1.2, label=label)
    ax.set_xlabel(r"$m_{\mathrm{init}}$")
    ax.set_ylabel(r"$s(m_{\mathrm{init}}) = \phi + \lambda\, m_{\mathrm{init}}$")
    ax.axhline(0.0, color="0.7", lw=0.8, zorder=0)
    if label:
        ax.legend(frameon=False, fontsize=8)
    if save_path:
        ax.figure.tight_layout()
        ax.figure.savefig(save_path)
    return ax


def plot_entropy_grid(grid, *, rep: int | str = "mean", save_path=None):
    """Plot the deg-grid family of s(m_init) curves from an
    :class:`~graphdyn_torch.models.entropy.EntropyGridResult` — the notebook
    driver's deg × rep × λ grids (`ipynb:484-492`), one curve per mean
    degree.

    ``rep``: a repetition index, or ``"mean"`` to average the grids over
    repetitions (zero entries from early-exited λ points are masked out).
    Returns the matplotlib Axes."""
    plt = _mpl()
    _, ax = plt.subplots(figsize=(5.5, 4), dpi=120)
    deg = np.asarray(grid.deg, float)
    for di in range(deg.size):
        m = np.asarray(grid.m_init[di], float)     # [rep, λ]
        s = np.asarray(grid.ent1[di], float)
        if rep == "mean":
            # visited λ cells come from the explicit per-rep count when the
            # grid carries it; legacy grids (or cells restored from old
            # checkpoints) fall back to the zero-value sentinel, OR-ed in so
            # a legitimately-(0, 0) visited point is kept when counted
            lam_count = getattr(grid, "n_lambda", None)
            visited = (m != 0) | (s != 0)
            if lam_count is not None:
                counted = (
                    np.arange(m.shape[1])[None, :]
                    < np.asarray(lam_count)[di][:, None]
                )
                visited |= counted
            # joint finiteness: a rep degraded in EITHER grid drops out of
            # BOTH means, so each plotted (m, s) point averages one
            # population
            visited &= np.isfinite(m) & np.isfinite(s)
            m_v = masked_mean(m, visited)
            s_v = masked_mean(s, visited)
        else:
            m_v, s_v = m[int(rep)], s[int(rep)]
        finite = np.isfinite(m_v) & np.isfinite(s_v)
        ax.plot(m_v[finite], s_v[finite], marker="o", ms=3, lw=1.2,
                label=f"deg={deg[di]:g}")
    ax.set_xlabel(r"$m_{\mathrm{init}}$")
    ax.set_ylabel(r"$s(m_{\mathrm{init}})$")
    ax.axhline(0.0, color="0.7", lw=0.8, zorder=0)
    ax.legend(frameon=False, fontsize=8)
    if save_path:
        ax.figure.tight_layout()
        ax.figure.savefig(save_path)
    return ax


def plot_consensus_curve(rows, *, title=None, save_path=None):
    """Render the m(0)→consensus curve family from
    :func:`graphdyn_torch.models.consensus.consensus_curve` rows: consensus
    fraction (near + strict) vs m(0) on the left, mean first-passage steps
    on the right. Returns the (ax_fraction, ax_steps) pair."""
    plt = _mpl()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9.2, 3.6), dpi=120)
    m0s = [r["m0"] for r in rows]
    frac = [r["consensus_fraction"] for r in rows]
    yerr = [r.get("consensus_fraction_std") for r in rows]
    if any(e is not None for e in yerr):
        # ensemble rows: instance spread as error bars
        ax1.errorbar(m0s, frac, yerr=[e or 0.0 for e in yerr],
                     fmt="o-", ms=4, lw=1.2, capsize=2.5,
                     label="near (|m| ≥ 1−ε), ±σ over instances")
    else:
        ax1.plot(m0s, frac, "o-", ms=4, lw=1.2, label="near (|m| ≥ 1−ε)")
    if "strict_fraction" in rows[0]:
        ax1.plot(m0s, [r["strict_fraction"] for r in rows],
                 "s--", ms=4, lw=1.0, label="strict (all equal)")
    ax1.set_xlabel("initial magnetization m(0)")
    ax1.set_ylabel("consensus fraction")
    ax1.set_ylim(-0.05, 1.05)
    ax1.legend(frameon=False, fontsize=8)
    if title:
        ax1.set_title(title, fontsize=9)
    steps = [(r["m0"], r["mean_steps_to_consensus"]) for r in rows
             if r["mean_steps_to_consensus"] is not None]
    if steps:
        ax2.plot(*zip(*steps), "o-", ms=4, lw=1.2)
    ax2.set_xlabel("initial magnetization m(0)")
    ax2.set_ylabel("mean steps to consensus")
    ax2.set_title("first-passage time", fontsize=9)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return ax1, ax2
