"""The entropy λ-ladders held against the JAX package's record
``entropy_ref.json`` and the notebook's golden triples.

The record (written by ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_entropy.py --write``) holds:

- ``golden``: the seed-9425 networkx instance of the tight golden anchor
  (``tests/test_entropy.py:214-256``: ER n=1000, c=1, 370 isolates, 485
  edges) as its node count and edge list, so that the port rebuilds it with
  :func:`~graphdyn_torch.graphs.graph_from_edges` without networkx, and the
  JAX package's float64 ``entropy_sweep`` curve on it over λ = 0..0.9;
- ``union``: ``entropy_ensemble_union`` at config 4's reduced shape
  (``benchmarks/config4_bdcm_entropy.py:135``: 4 × ER(300, 1.5/299), 8 λ in
  ``linspace(0, 3.1, 8)``, ``max_sweeps=400``), float32 and float64.

Each curve carries per λ: φ (``ent``), ``m_init``, ``ent1``, the sweep
count and the final delta of the fixed point.

The rule (:func:`hold_curve`): sweep counts equal, except at a near tie —
the JAX run stopped one sweep earlier with its final delta within
``NEAR_TIE_REL`` (relative) of eps, where the port's delta, a rounding away,
may read just above eps. Rows from the first near tie on differ by that
sweep (about eps in chi) and are not held to the tight bound. φ, m_init and
ent1 within ``atol`` on the rows before it.
"""

from __future__ import annotations

import numpy as np

from graphdyn_torch.config import EntropyConfig
from graphdyn_torch.graphs import erdos_renyi_graph, graph_from_edges

# the notebook's ten stored (λ, m_init, ent1) triples at deg 1.0, n=1000,
# p=c=1, damp 0.1, eps 1e-6 (`ER_BDCM_entropy.ipynb:18-46`, BASELINE.md)
GOLDEN_TRIPLES = (
    (0.0, 0.7859766580538275, 0.1720699495590459),
    (0.1, 0.7699358367558866, 0.17127259171924963),
    (0.2, 0.7545492129205356, 0.16897079877838897),
    (0.3, 0.7399806499309954, 0.16533606458353123),
    (0.4, 0.7263552613663471, 0.1605754636000715),
    (0.5, 0.7137593656167142, 0.15491615729839237),
    (0.6, 0.7022428278329915, 0.14859118078564132),
    (0.7, 0.6918229572378949, 0.14182740343380668),
    (0.8, 0.6824890587925729, 0.13484592378355741),
    (0.9, 0.6742072244439773, 0.12780494062947345),
)
GOLDEN_TOL = 5e-3
GOLDEN_SEED = 0               # the chi init seed of the golden run
# config 4's reduced shape (`benchmarks/config4_bdcm_entropy.py:135`)
UNION_SHAPE = dict(n=300, c=1.5, members=4, n_lambda=8, lmbd_max=3.1,
                   max_sweeps=400, seed=0)
NEAR_TIE_REL = 1e-9
CURVE_FIELDS = ("ent", "m_init", "ent1")


def golden_config() -> EntropyConfig:
    return EntropyConfig(lmbd_max=0.9, lmbd_step=0.1, dtype="float64")


def golden_graph(ref: dict):
    """The golden instance, rebuilt from the record's edge list."""
    gold = ref["golden"]
    return graph_from_edges(int(gold["n"]),
                            np.asarray(gold["edges"], np.int64).reshape(-1, 2))


def union_config(dtype: str) -> EntropyConfig:
    return EntropyConfig(max_sweeps=UNION_SHAPE["max_sweeps"], dtype=dtype)


def union_lambdas() -> np.ndarray:
    return np.linspace(0.0, UNION_SHAPE["lmbd_max"], UNION_SHAPE["n_lambda"])


def union_graphs(erdos_renyi=erdos_renyi_graph) -> list:
    """The reduced config-4 members (the same numpy sampler in both
    packages: pass the JAX package's ``erdos_renyi_graph`` to build its
    graphs)."""
    n, c = UNION_SHAPE["n"], UNION_SHAPE["c"]
    return [erdos_renyi(n, c / (n - 1), seed=k)
            for k in range(UNION_SHAPE["members"])]


def curve_record(res, deltas=None) -> dict:
    """A ladder result as the record's JSON fields (``deltas``: the final
    delta of each visited λ, when known)."""
    out = {"lambdas": np.asarray(res.lambdas, float).tolist(),
           "sweeps": np.asarray(res.sweeps).astype(int).tolist(),
           "nonconverged": float(res.nonconverged)}
    for f in CURVE_FIELDS:
        out[f] = np.asarray(getattr(res, f), np.float64).tolist()
    if deltas is not None:
        out["delta"] = [float(d) for d in deltas]
    return out


def hold_curve(got: dict, want: dict, *, atol: float, eps: float) -> dict:
    """Hold a port curve (:func:`curve_record`) to a JAX one by the module's
    rule. Returns ``{"rows": compared rows, "max_abs_err": ..., "near_tie":
    λ or None}``; raises ``AssertionError`` on a fault."""
    lw, lg = np.asarray(want["lambdas"]), np.asarray(got["lambdas"])
    sw, sg = np.asarray(want["sweeps"]), np.asarray(got["sweeps"])
    dw = np.asarray(want["delta"])
    rows, tie = min(lw.size, lg.size), None
    for k in range(rows):
        if sw[k] == sg[k]:
            continue
        if sg[k] == sw[k] + 1 and dw[k] >= eps * (1.0 - NEAR_TIE_REL):
            rows, tie = k, float(lw[k])
            break
        raise AssertionError(
            f"sweeps differ at lambda={lw[k]}: port {sg[k]}, JAX {sw[k]} "
            f"(JAX final delta {dw[k]}, eps {eps}): not a near tie")
    if tie is None and (lw.size != lg.size
                        or float(want["nonconverged"])
                        != float(got["nonconverged"])):
        raise AssertionError(
            f"ladders differ: port visited {lg.size} lambda (nonconverged "
            f"{got['nonconverged']}), JAX {lw.size} ({want['nonconverged']})")
    if not np.array_equal(lw[:rows], lg[:rows]):
        raise AssertionError("ladders visit different lambda")
    err = 0.0
    for f in CURVE_FIELDS:
        a = np.asarray(got[f], np.float64)[:rows]
        b = np.asarray(want[f], np.float64)[:rows]
        same = (a == b) | (np.abs(a - b) <= atol)   # −inf == −inf
        if not same.all():
            raise AssertionError(
                f"{f} differs beyond {atol}: port {a[~same]}, JAX {b[~same]}")
        fin = np.isfinite(a) & np.isfinite(b)
        if fin.any():
            err = max(err, float(np.abs(a[fin] - b[fin]).max()))
    return {"rows": int(rows), "max_abs_err": err, "near_tie": tie}


def hold_golden_triples(res) -> float:
    """Every one of the ten notebook triples within :data:`GOLDEN_TOL` of a
    golden-instance curve; returns the largest difference."""
    lam = np.round(np.asarray(res.lambdas, float), 2)
    if lam.size != len(GOLDEN_TRIPLES):
        raise AssertionError(f"golden curve visited {lam.size} of 10 lambda")
    err = 0.0
    for k, (lg, m_g, e_g) in enumerate(GOLDEN_TRIPLES):
        if lam[k] != lg:
            raise AssertionError(f"golden ladder point {k}: {lam[k]} != {lg}")
        err = max(err, abs(float(res.m_init[k]) - m_g),
                  abs(float(res.ent1[k]) - e_g))
    if err > GOLDEN_TOL:
        raise AssertionError(f"golden triples off by {err} > {GOLDEN_TOL}")
    return err
