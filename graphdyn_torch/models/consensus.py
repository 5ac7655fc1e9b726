"""Forward opinion-consensus experiment: which initial magnetizations m(0)
flow to consensus, and how fast (the port of
``graphdyn/models/consensus.py``).

Sweep m(0), draw biased packed replicas on the device, run the chunked
consensus scan (:func:`graphdyn_torch.ops.packed.packed_consensus_scan`),
and record the fraction of replicas reaching consensus, the first-passage
time and the final magnetization. On CUDA every step of the scan is one
launch of the packed-step kernel.

Two consensus notions are tracked per replica (both returned):

- ``strict``: the absorbing homogeneous state, all spins equal — blocked on
  sparse ER at an O(1) rate by frozen/blinking small components;
- ``near``: |m_final| ≥ 1 − near_eps (default 0.99) — the giant component
  has consensed.

Every entry point takes ``device=`` and defaults to CUDA; without a CUDA
device it raises unless the caller passes ``device="cpu"``.

``mesh=`` (a 1-D ``DeviceMesh``, one rank per card) shards the packed WORD
axis: every gather of the scan indexes the node axis, so each rank rolls
its own ``[n+1, W/P]`` word slab through K1/K2′ with no per-step
collective; one scalar ``all_reduce`` per slab of steps keeps the early
exit common, and the per-replica flags are gathered at the end. The slab
holds the bits of the unsharded draw, so sharded and unsharded points are
equal bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from graphdyn_torch import obs
from graphdyn_torch.graphs import (
    erdos_renyi_graph,
    random_regular_graph,
    remove_isolates,
)
from graphdyn_torch.ops import packed
from graphdyn_torch.utils.platform import resolve_device


def _word_shard(mesh, W: int, R: int):
    """``(axis, slab)``: the mesh's one dimension and this rank's slice of
    the W packed words (each rank owns whole words, 32 replicas each)."""
    from graphdyn_torch.parallel.mesh import axis_index, axis_size

    (axis,) = mesh.mesh_dim_names
    P = axis_size(mesh, axis)
    if W % P:
        raise ValueError(
            f"the mesh size {P} must divide the packed word count W={W} "
            f"(R={R}): each device owns whole words (32 replicas each)")
    k, Wl = axis_index(mesh, axis), W // P
    return axis, slice(k * Wl, (k + 1) * Wl)


def _gather_flags(out: dict, mesh, axis: str) -> dict:
    """The per-replica outputs of every rank's slab, in replica order."""
    from graphdyn_torch.parallel.mesh import all_gather_tiled

    return {k: (all_gather_tiled(v, mesh, axis) if isinstance(v, torch.Tensor)
                and v.ndim == 1 else v) for k, v in out.items()}


def _device_tables(g, dev: torch.device):
    return (torch.as_tensor(g.nbr, dtype=torch.int32, device=dev),
            torch.as_tensor(g.deg, dtype=torch.int32, device=dev))


def er_consensus_ensemble(n: int, c: float = 6.0, seed: int = 0,
                          device: str | torch.device | None = None):
    """The standard opinion-dynamics ensemble — ER G(n, c/n) with isolates
    removed (`ER_BDCM_entropy.ipynb:283-291`). Returns
    ``(graph, n_isolates, nbr_device, deg_device)``; the device tables are
    uploaded once for a whole sweep."""
    dev = resolve_device(device)
    g, n_iso = remove_isolates(erdos_renyi_graph(n, c / n, seed=seed))
    return (g, n_iso, *_device_tables(g, dev))


def rrg_consensus_ensemble(n: int, d: int = 4, seed: int = 0,
                           device: str | torch.device | None = None):
    """RRG variant of :func:`er_consensus_ensemble` — the SA search's own
    graph ensemble (`SA_RRG.py:45-46`). No isolates by construction.
    Returns the same ``(graph, 0, nbr_device, deg_device)`` tuple shape."""
    dev = resolve_device(device)
    g = random_regular_graph(n, d, seed=seed)
    return (g, 0, *_device_tables(g, dev))


def _point_stats(out: dict, R: int, m0: float, max_steps: int,
                 chunk: int) -> dict:
    """Reduce a scan's per-replica outputs to the point's row (host numpy,
    the same reductions as the JAX package)."""
    near = out["near"][:R].cpu().numpy()
    near_step = out["near_step"][:R].cpu().numpy()
    m_final = out["m_final"][:R].cpu().numpy()
    n_near = int(near.sum())
    return {
        "m0": float(m0),
        "consensus_fraction": n_near / R,
        "strict_fraction": float(out["strict"][:R].cpu().numpy().mean()),
        "mean_steps_to_consensus": (
            float(near_step[near].mean()) if n_near else None
        ),
        "mean_abs_m_final": float(np.abs(m_final).mean()),
        "max_steps": int(max_steps),
        "step_resolution": int(chunk),
        "replicas": int(R),
    }


def consensus_point(g, R: int, m0: float, max_steps: int, chunk: int = 10,
                    seed: int = 1000, nbr_dev=None, deg_dev=None,
                    rule: str = "majority", tie: str = "stay",
                    near_eps: float = 0.01, mesh=None,
                    device: str | torch.device | None = None) -> dict:
    """One m(0) point: biased on-device init, chunked consensus scan,
    per-replica statistics reduced to a plain dict (the JAX package's keys).
    Callers sweeping many points pass ``nbr_dev``/``deg_dev`` once. The scan
    runs all W·32 packed replicas; the row reports the first ``R``.
    ``mesh``: word-axis sharding (module docstring); every rank of the mesh
    calls this with the same arguments and returns the same row."""
    dev = resolve_device(device)
    W = -(-R // 32)
    all_done = axis = None
    draw = {}
    if mesh is not None:
        from graphdyn_torch.parallel.mesh import psum

        axis, draw["cols"] = _word_shard(mesh, W, R)

        def all_done(local: bool) -> bool:
            # the slab loop goes on while any rank has a replica short of
            # near-consensus: one scalar all_reduce per slab
            return int(psum(torch.tensor([int(not local)], device=dev),
                            mesh, axis)) == 0

    sp = packed.draw_packed_biased(seed, g.n, W, m0, device=dev, **draw)
    if nbr_dev is None or deg_dev is None:
        nbr_dev, deg_dev = _device_tables(g, dev)
    # one m(0) point = one chunked scan, whose last read of the flags ends
    # after the card: the span's wall is the scan's; the gauge reports
    # spin-updates/s
    with obs.timed("ops.packed.scan", m0=float(m0), R=W * 32) as sw:
        out = packed.packed_consensus_scan(
            nbr_dev.to(dev), deg_dev.to(dev), sp, R=sp.shape[1] * 32,
            max_steps=max_steps, chunk=chunk, near_eps=near_eps, rule=rule,
            tie=tie, all_done=all_done,
        )
        if mesh is not None:
            out = _gather_flags(out, mesh, axis)
    if obs.enabled():
        steps_run = int(out["steps_run"])
        obs.gauge("ops.rollout.rate",
                  g.n * W * 32 * steps_run / max(sw.wall_s, 1e-9),
                  solver="consensus", m0=float(m0), steps=steps_run)
        obs.memband.emit_memory_gauges(dev, loop="consensus.scan",
                                       m0=float(m0))
    return _point_stats(out, R, m0, max_steps, chunk)


def consensus_curve_ensemble(n: int, R: int, m0_list: Sequence[float],
                             max_steps: int, *, c: float = 6.0,
                             graph: str = "er", d: int = 4,
                             graph_seeds: Sequence[int] = (0, 1, 2),
                             chunk: int = 10, rule: str = "majority",
                             tie: str = "stay", near_eps: float = 0.01,
                             mesh=None, progress=None,
                             device: str | torch.device | None = None):
    """The consensus curve over an ENSEMBLE of graph instances: one
    :func:`consensus_curve` per graph seed, plus per-m(0) aggregates (mean
    and instance spread). ``graph`` picks ``"er"`` (G(n, c/n), isolates
    removed) or ``"rrg"`` (d-regular). Returns ``(per_seed, aggregate)``."""
    dev = resolve_device(device)
    per_seed = []
    for s in graph_seeds:
        if graph == "er":
            g, n_iso, nbr_dev, deg_dev = er_consensus_ensemble(
                n, c=c, seed=s, device=dev)
        elif graph == "rrg":
            g, n_iso, nbr_dev, deg_dev = rrg_consensus_ensemble(
                n, d=d, seed=s, device=dev)
        else:
            raise ValueError(f"graph must be 'er' or 'rrg', got {graph!r}")
        rows = consensus_curve(
            g, R, m0_list, max_steps, chunk, nbr_dev=nbr_dev,
            deg_dev=deg_dev, rule=rule, tie=tie, near_eps=near_eps,
            graph_seed=s, device=dev, mesh=mesh,
            progress=(lambda pt, s=s: progress(s, pt)) if progress else None,
        )
        per_seed.append({"graph_seed": int(s), "n": g.n,
                         "isolates_removed": n_iso, "rows": rows})
    aggregate = []
    for j, m0 in enumerate(m0_list):
        fr = np.array([ps["rows"][j]["consensus_fraction"]
                       for ps in per_seed])
        steps = [ps["rows"][j]["mean_steps_to_consensus"]
                 for ps in per_seed]
        steps = [x for x in steps if x is not None]
        aggregate.append({
            "m0": float(m0),
            "consensus_fraction_mean": float(fr.mean()),
            # None (not 0.0) for a single instance: no spread was measured
            "consensus_fraction_std": float(fr.std(ddof=1))
            if len(fr) > 1 else None,
            "consensus_fraction_min": float(fr.min()),
            "consensus_fraction_max": float(fr.max()),
            "mean_steps_to_consensus": (float(np.mean(steps))
                                        if steps else None),
            "instances": len(per_seed),
            # alias for single-run consumers
            "consensus_fraction": float(fr.mean()),
        })
    return per_seed, aggregate


def consensus_ensemble_doc(n: int, per_seed: list[dict],
                           aggregate: list[dict], *, c: float = 6.0,
                           rule: str = "majority", tie: str = "stay",
                           near_eps: float = 0.01,
                           kind: str = "erdos_renyi", d: int | None = None,
                           device: str | torch.device | None = None,
                           **extra) -> dict:
    """Artifact schema for a multi-instance sweep: ``rows`` carries the
    per-m(0) aggregates, ``per_seed`` the raw curves. ``backend`` is the
    torch device type the sweep ran on."""
    ens = "ER" if kind == "erdos_renyi" else f"RRG-d{d}"
    return {
        "what": (f"{ens}-{rule} consensus fraction & first-passage vs "
                 f"m(0), {len(per_seed)}-instance ensemble"),
        "graph": {"kind": kind, "n": n,
                  **({"c": c} if kind == "erdos_renyi" else {"d": d}),
                  "graph_seeds": [ps["graph_seed"] for ps in per_seed],
                  "n_kept": [ps["n"] for ps in per_seed],
                  "isolates_removed": [ps["isolates_removed"]
                                       for ps in per_seed]},
        "dynamics": {"rule": rule, "tie": tie,
                     "update": "parallel/synchronous"},
        "near_consensus_def": f"|m_final| >= {1.0 - near_eps:g}",
        "backend": resolve_device(device).type,
        "rows": aggregate,
        "per_seed": per_seed,
        **extra,
    }


def m_half(aggregate: Sequence[dict]):
    """The half-consensus bias: first upward 0.5-crossing of the mean
    consensus fraction over an aggregate curve (linear interpolation in
    m0). None when the curve starts at/above 0.5 or never crosses."""
    m0s = [r["m0"] for r in aggregate]
    fr = [r["consensus_fraction_mean"] for r in aggregate]
    if fr and fr[0] >= 0.5:
        return None
    for j in range(1, len(fr)):
        if fr[j - 1] < 0.5 <= fr[j]:
            t = (0.5 - fr[j - 1]) / (fr[j] - fr[j - 1])
            return m0s[j - 1] + t * (m0s[j] - m0s[j - 1])
    return None


def consensus_doc(g, n_iso: int, rows: list[dict], *, c: float = 6.0,
                  seed: int = 0, rule: str = "majority", tie: str = "stay",
                  near_eps: float = 0.01, kind: str = "erdos_renyi",
                  d: int | None = None,
                  device: str | torch.device | None = None,
                  **extra) -> dict:
    """The one artifact schema for a consensus sweep (the JAX package's
    keys); ``backend`` is the torch device type the sweep ran on."""
    ens = "ER" if kind == "erdos_renyi" else f"RRG-d{d}"
    return {
        "what": f"{ens}-{rule} consensus fraction & first-passage vs m(0)",
        "graph": {"kind": kind, "n": g.n,
                  **({"c": c} if kind == "erdos_renyi" else {"d": d}),
                  "isolates_removed": n_iso, "seed": seed},
        "dynamics": {"rule": rule, "tie": tie,
                     "update": "parallel/synchronous"},
        "near_consensus_def": f"|m_final| >= {1.0 - near_eps:g}",
        "backend": resolve_device(device).type,
        "rows": rows,
        **extra,
    }


def draw_seed(graph_seed: int, k: int) -> int:
    """The replica-draw seed for curve point ``k`` on graph instance
    ``graph_seed``: both coordinates folded through a SeedSequence, so every
    (instance, point) pair draws an independent initial replica set."""
    return int(np.random.SeedSequence([int(graph_seed), 1000 + int(k)])
               .generate_state(1)[0])


def consensus_curve(g, R: int, m0_list: Sequence[float], max_steps: int,
                    chunk: int = 10, nbr_dev=None, deg_dev=None,
                    rule: str = "majority", tie: str = "stay",
                    near_eps: float = 0.01, mesh=None,
                    progress=None, graph_seed: int = 0,
                    device: str | torch.device | None = None) -> list[dict]:
    """The m(0)→consensus curve as a list of row dicts (one per m(0); the
    replica-draw seed folds ``(graph_seed, k)`` via :func:`draw_seed`).
    ``progress`` is an optional per-row callback."""
    dev = resolve_device(device)
    if nbr_dev is None or deg_dev is None:
        nbr_dev, deg_dev = _device_tables(g, dev)
    rows = []
    for k, m0 in enumerate(m0_list):
        pt = consensus_point(
            g, R, m0, max_steps, chunk, seed=draw_seed(graph_seed, k),
            nbr_dev=nbr_dev, deg_dev=deg_dev, rule=rule, tie=tie,
            near_eps=near_eps, device=dev, mesh=mesh,
        )
        rows.append(pt)
        if progress is not None:
            progress(pt)
    return rows
