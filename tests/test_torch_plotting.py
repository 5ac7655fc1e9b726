"""The port's figures (``graphdyn_torch.plotting``) against the JAX
package's (``tests/test_plotting.py``): drawn from the same result, the
Axes hold the same line data and the PNG is written; the ``entropy --plot``
and ``consensus --plot`` commands write their files."""

import contextlib
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

from graphdyn import plotting as jplot  # noqa: E402
from graphdyn_torch import plotting as tplot  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _lines(ax):
    return [(ln.get_label(), np.asarray(ln.get_xdata(), float).tolist(),
             np.asarray(ln.get_ydata(), float).tolist()) for ln in ax.lines]


def _grid():
    L = 5
    lam = np.linspace(0, 0.4, L)
    m = np.stack([np.linspace(0.8, 0.6, L), np.linspace(0.82, 0.62, L)])
    ent = np.stack([0.17 - 0.1 * lam, 0.16 - 0.1 * lam])
    ent1 = ent + lam * m
    ent1[1, -1] = -np.inf                    # a degraded member
    z = np.zeros((1, 2))
    return SimpleNamespace(deg=np.array([1.0]), ent=ent[None],
                           m_init=m[None], ent1=ent1[None],
                           n_lambda=np.array([[5, 4]]), counts=z)


@pytest.mark.parametrize("rep", ["mean", 0, 1])
def test_entropy_grid_figure_equals_jax(tmp_path, rep):
    got = tplot.plot_entropy_grid(_grid(), rep=rep,
                                  save_path=str(tmp_path / "t.png"))
    want = jplot.plot_entropy_grid(_grid(), rep=rep,
                                   save_path=str(tmp_path / "j.png"))
    assert _lines(got) == _lines(want)
    assert (tmp_path / "t.png").stat().st_size > 0


def test_entropy_curve_figure_equals_jax(tmp_path):
    res = SimpleNamespace(m_init=np.array([0.8, 0.7, 0.6]),
                          ent1=np.array([0.1, 0.12, -np.inf]))
    got = tplot.plot_entropy_curve(res, label="deg=1",
                                   save_path=str(tmp_path / "t.png"))
    want = jplot.plot_entropy_curve(res, label="deg=1")
    assert _lines(got) == _lines(want)
    (line,) = [ln for ln in got.lines if ln.get_label() == "deg=1"]
    assert line.get_xdata().size == 2            # the -inf point dropped
    assert (tmp_path / "t.png").stat().st_size > 0


def test_consensus_figure_equals_jax(tmp_path):
    rows = [{"m0": m, "consensus_fraction": f, "strict_fraction": f / 2,
             "mean_steps_to_consensus": s}
            for m, f, s in ((0.0, 0.1, None), (0.1, 0.5, 12.0),
                            (0.3, 1.0, 4.0))]
    g1, g2 = tplot.plot_consensus_curve(rows, title="t",
                                        save_path=str(tmp_path / "t.png"))
    w1, w2 = jplot.plot_consensus_curve(rows, title="t")
    assert _lines(g1) == _lines(w1) and _lines(g2) == _lines(w2)
    assert (tmp_path / "t.png").stat().st_size > 0


@pytest.mark.parametrize("argv", [
    ["entropy", "--n", "60", "--deg", "1.0", "--num-rep", "1",
     "--lmbd-max", "0.2"],
    ["entropy", "--n", "40", "--deg", "1.5", "--num-rep", "1",
     "--lmbd-max", "0.1", "--union", "2"],
    ["consensus", "--n", "200", "--replicas", "32", "--m0", "0.0", "0.3",
     "--max-steps", "20"],
], ids=["entropy", "entropy_union", "consensus"])
def test_cli_plot_flag_writes_the_png(tmp_path, argv):
    from graphdyn_torch.cli import main

    p = str(tmp_path / "fig.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main([*argv, "--device", "cpu", "--plot", p]) == 0
    assert (tmp_path / "fig.png").stat().st_size > 0
