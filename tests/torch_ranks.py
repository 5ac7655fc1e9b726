"""Spawned gloo ranks on the CPU for the port's sharded tests.

:func:`run_ranks` starts ``world`` fresh processes (the ``spawn`` start
method: no forked JAX state) through :func:`graphdyn_torch.scripts.
halo_ranks.run_ranks`: each takes one intra-op thread, makes its gloo
process group with a ``FileStore`` under a test's own directory (never a
fixed port: several test workers run at once) and calls a worker function
of this module. The parent reads every rank's result. This module imports
neither JAX nor the JAX package, so the ranks import only torch and the
port.
"""

from __future__ import annotations

import os

#: seconds a whole spawn may take before the parent gives up on it
TIMEOUT_S = 240


def run_ranks(fn_name: str, world: int, root: str, *args,
              timeout: float = TIMEOUT_S) -> list:
    """Run ``fn_name(rank, world, *args)`` (a function of this module) on
    ``world`` spawned gloo ranks; return the per-rank results. Raises with
    the failing rank's traceback."""
    from graphdyn_torch.scripts.halo_ranks import run_ranks as spawn

    return spawn(globals()[fn_name], world, *args, device="cpu",
                 backend="gloo", root=root, timeout=timeout)


# ---------------------------------------------------------------------------
# worker functions (one per test module)
# ---------------------------------------------------------------------------


def _mesh_for(P: int, world: int):
    """A (replica, node) mesh over the whole world whose node dimension has
    P ranks."""
    from graphdyn_torch.parallel.mesh import make_mesh

    return make_mesh((world // P, P), ("replica", "node"), device="cpu")


def halo_worker(rank: int, world: int, cases: list) -> dict:
    """``packed_rollout(partition=)`` for every case ``(key, graph_args,
    P, rule, tie, hub_threshold, steps, W, seed)`` on a mesh whose node
    dimension has P ranks; returns ``{key: uint32 words}`` (the global
    result every rank holds) and the shard-launch bytes gauge inputs."""
    import numpy as np
    import torch

    from graphdyn_torch import graphs as tg
    from graphdyn_torch.interop import words_from_numpy, words_to_numpy
    from graphdyn_torch.ops.packed import packed_rollout

    out = {}
    meshes = {}
    for key, gargs, P, rule, tie, hub, steps, W, seed in cases:
        g = _graph(*gargs)
        part = tg.partition_graph(g, P, seed=0, hub_threshold=hub)
        if P not in meshes:
            meshes[P] = _mesh_for(P, world)
        sp = np.random.default_rng(seed).integers(
            0, 2**32, size=(g.n, W), dtype=np.uint32)
        nbr = torch.as_tensor(g.nbr, dtype=torch.int32)
        deg = torch.as_tensor(g.deg, dtype=torch.int32)
        res = packed_rollout(nbr, deg, words_from_numpy(sp), steps, rule,
                             tie, partition=part, mesh=meshes[P])
        out[key] = words_to_numpy(res)
    return out


def _graph(kind: str, *a):
    from graphdyn_torch import graphs as tg

    if kind == "rrg":
        n, d, s = a
        return tg.random_regular_graph(n, d, seed=s)
    if kind == "er":
        n, c, s = a
        return tg.erdos_renyi_graph(n, c / (n - 1), seed=s)
    if kind == "powerlaw":
        n, gamma, s = a
        return tg.powerlaw_graph(n, gamma=gamma, dmin=2, seed=s)
    raise ValueError(kind)


def sharded_worker(rank: int, world: int) -> dict:
    """The gather-mode primitives on a 2 × 2 replica × node mesh: the
    sharded rollout at n = 256 and 253 (pad rows) under both ties, one
    sharded SA step, and the mesh-mean consensus fraction."""
    import numpy as np
    import torch

    from graphdyn_torch import graphs as tg
    from graphdyn_torch.observe import consensus_fraction_psum
    from graphdyn_torch.parallel.mesh import make_mesh
    from graphdyn_torch.parallel.sharded import (
        make_sharded_rollout,
        make_sharded_sa_step,
        pad_nodes,
        place_sharded,
    )

    mesh = make_mesh((2, 2), ("replica", "node"), device="cpu")
    out = {}
    for n in (256, 253):
        g = tg.random_regular_graph(n, 4, seed=0)
        nbr_pad, n_pad = pad_nodes(g, 2)
        rng = np.random.default_rng(1)
        s = np.ones((8, n_pad), np.int8)
        s[:, :n] = (2 * rng.integers(0, 2, size=(8, n)) - 1).astype(np.int8)
        nbr_d = place_sharded(mesh, nbr_pad, ("node", None), device="cpu")
        s_d = place_sharded(mesh, s, ("replica", "node"), device="cpu")
        for tie in ("stay", "change"):
            f = make_sharded_rollout(mesh, n_real=n, steps=5, tie=tie)
            out[f"rollout-{n}-{tie}"] = _gather_2d(f(nbr_d, s_d), mesh)
        out[f"s-{n}"] = s
    # one SA step, its returned sums against a rollout of its state
    g = tg.random_regular_graph(253, 4, seed=3)
    nbr_pad, n_pad = pad_nodes(g, 2)
    rng = np.random.default_rng(4)
    s = np.ones((8, n_pad), np.int8)
    s[:, :253] = (2 * rng.integers(0, 2, size=(8, 253)) - 1).astype(np.int8)
    nbr_d = place_sharded(mesh, nbr_pad, ("node", None), device="cpu")
    s_d = place_sharded(mesh, s, ("replica", "node"), device="cpu")
    roll = make_sharded_rollout(mesh, n_real=253, steps=1)
    end = _gather_2d(roll(nbr_d, s_d), mesh)[:, :253]
    sum_end = end.astype(np.int64).sum(axis=1).astype(np.int32)
    step = make_sharded_sa_step(mesh, rollout_steps=1, n_real=253)

    def rep(x):
        return place_sharded(mesh, x, ("replica",), device="cpu")

    f32 = torch.float32
    res = step(nbr_d, s_d, rep(sum_end), rep(np.full(8, 0.01 * 253, np.float32)),
               rep(np.full(8, 0.01 * 253, np.float32)),
               rep(np.arange(8, dtype=np.int64)), rep(np.zeros(8, np.int32)),
               torch.tensor(1.0005, dtype=f32), torch.tensor(1.0005, dtype=f32),
               torch.tensor(4.5 * 253, dtype=f32),
               torch.tensor(5.0 * 253, dtype=f32))
    s_new = _gather_2d(res[0], mesh)
    out["step"] = {
        "s0": s, "s_new": s_new,
        "sum_end_new": _gather_rep1(res[1], mesh),
        "want": _gather_2d(roll(nbr_d, res[0]), mesh)[:, :253].astype(
            np.int64).sum(axis=1),
        "consensus": float(res[6]),
    }
    # consensus_fraction_psum: replicas 0..7 split over the replica axis
    s_end = np.ones((8, 16), np.int8)
    s_end[[1, 4, 6], 3] = -1
    loc = place_sharded(mesh, s_end, ("replica", None), device="cpu")
    out["psum"] = float(consensus_fraction_psum(loc, mesh, "replica"))
    # the rank-local block helpers and the hybrid mesh (one host: the DCN
    # axis has size 1 and the node axis spans the host's 4 ranks)
    from graphdyn_torch.parallel.mesh import (
        device_pool,
        make_hybrid_mesh,
        replicate,
        shard_batch,
        shard_stack,
    )

    x = np.arange(16).reshape(8, 2)
    hyb = make_hybrid_mesh((4,), ("replica", "node"), device="cpu")
    out["helpers"] = {
        "shard_batch": shard_batch(mesh, x, "replica", device="cpu").numpy(),
        "replicate": replicate(mesh, x, device="cpu").numpy(),
        "shard_stack": shard_stack(mesh, x, "node", device="cpu").numpy(),
        "scalar": shard_stack(mesh, np.int64(7), "node", device="cpu").item(),
        "hybrid": (tuple(hyb.shape), hyb.mesh_dim_names,
                   hyb.get_local_rank("node")),
        "pool": [str(d) for d in device_pool(3, device="cpu")],
        "coords": (mesh.get_local_rank("replica"),
                   mesh.get_local_rank("node")),
    }
    return out


def _gather_2d(x, mesh):
    from graphdyn_torch.parallel.mesh import all_gather_tiled

    y = all_gather_tiled(x.contiguous(), mesh, "node", dim=1)
    return all_gather_tiled(y, mesh, "replica", dim=0).numpy()


def _gather_rep1(x, mesh):
    from graphdyn_torch.parallel.mesh import all_gather_tiled

    return all_gather_tiled(x.contiguous(), mesh, "replica", dim=0).numpy()


def consensus_worker(rank: int, world: int, cases: list) -> dict:
    """``consensus_curve(mesh=)`` on a 1-D mesh of ``world`` ranks (word
    slabs) for every case ``(key, graph args, R, m0s, max_steps, chunk,
    rule, tie)``."""
    from graphdyn_torch.models.consensus import consensus_curve
    from graphdyn_torch.parallel.mesh import make_mesh

    mesh = make_mesh((world,), ("replica",), device="cpu")
    out = {}
    for key, gargs, R, m0s, max_steps, chunk, rule, tie in cases:
        g = _graph(*gargs)
        out[key] = consensus_curve(g, R, m0s, max_steps, chunk, rule=rule,
                                   tie=tie, mesh=mesh, device="cpu")
    return out


def _sa_inputs(gargs, R, L, seed, up=0.85):
    """A graph, initial spins (+1 with probability ``up``, so most chains
    reach consensus inside the budget) and injected streams."""
    import numpy as np

    g = _graph(*gargs)
    rng = np.random.default_rng(seed)
    s0 = np.where(rng.random((R, g.n)) < up, 1, -1).astype(np.int8)
    proposals = rng.integers(0, g.n, size=(R, L)).astype(np.int32)
    uniforms = rng.random(size=(R, L))
    return g, s0, proposals, uniforms


def _sa_result(res) -> dict:
    return {f: getattr(res, f) for f in res._fields}


def sa_sharded_worker(rank: int, world: int, cases: list,
                      resume: dict | None, root: str) -> dict:
    """``sa_sharded`` for every case (a dict: key, graph args, R, L, seed,
    mesh shape, node_mode, rollout_mode, hub threshold, injected, a0
    ladder, max_steps) and, with ``resume``, one chain preempted at one
    mesh shape and resumed at the next ones (``resume["legs"]``)."""
    from graphdyn_torch import graphs as tg
    from graphdyn_torch.config import DynamicsConfig, SAConfig
    from graphdyn_torch.parallel.mesh import make_mesh
    from graphdyn_torch.parallel.sa_sharded import sa_sharded
    from graphdyn_torch.resilience import faults

    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("replica", "node"),
                                      device="cpu")
        return meshes[shape]

    out = {}
    for c in cases:
        g, s0, prop, unif = _sa_inputs(c["graph"], c["R"], c["L"], c["seed"])
        kw = {}
        if c.get("hub"):
            kw["partition"] = tg.partition_graph(
                g, c["shape"][1], seed=0, hub_threshold=c["hub"])
        if c.get("injected", True):
            kw.update(proposals=prop, uniforms=unif)
        else:
            kw.update(seed=c["prng_seed"])
        cfg = SAConfig(dynamics=DynamicsConfig(p=c.get("p", 1), c=1))
        res = sa_sharded(
            g, cfg, mesh=mesh(c["shape"]), s0=s0, a0=c.get("a0"),
            max_steps=c.get("max_steps"), node_mode=c["node_mode"],
            rollout_mode=c["rollout_mode"], chunk_steps=c.get("chunk", 64),
            device="cpu", **kw)
        out[c["key"]] = _sa_result(res)
    if resume is not None:
        g, s0, prop, unif = _sa_inputs(resume["graph"], resume["R"],
                                       resume["L"], resume["seed"])
        cfg = SAConfig(dynamics=DynamicsConfig(p=resume.get("p", 1), c=1))
        path = f"{root}/ck/sa"
        legs = []
        for i, leg in enumerate(resume["legs"]):
            plan = faults.FaultPlan([faults.FaultSpec(
                "chunk.boundary", "preempt", at=leg["preempt_at"])]) \
                if leg.get("preempt_at") else None
            try:
                if plan is not None:
                    plan.__enter__()
                res = sa_sharded(
                    g, cfg, mesh=mesh(leg["shape"]), s0=s0, proposals=prop,
                    uniforms=unif, node_mode=leg["node_mode"],
                    rollout_mode=leg["rollout_mode"], chunk_steps=32,
                    checkpoint_path=path, checkpoint_interval_s=0.0,
                    device="cpu")
                legs.append(("done", _sa_result(res)))
            except faults.InjectedPreemption:
                legs.append(("preempted", None))
            finally:
                if plan is not None:
                    plan.__exit__(None, None, None)
        out["resume"] = legs
    return out


def cli_worker(rank: int, world: int, argv: list, legs: list,
               root: str) -> list:
    """``python -m graphdyn_torch`` on every rank, once per leg: a leg is
    ``(signal_rank, at)`` (a graceful-shutdown request on that rank at the
    ``at``-th chunk boundary) or None. Each rank runs in its own directory
    (where a flight post-mortem lands) and returns ``(exit code, stdout)``
    per leg."""
    import contextlib
    import io

    from graphdyn_torch.cli import main
    from graphdyn_torch.resilience import faults

    out = []
    cwd = os.path.join(root, f"cwd{rank}")
    os.makedirs(cwd, exist_ok=True)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        for leg in legs:
            plan = (faults.FaultPlan([faults.FaultSpec(
                "chunk.boundary", "signal", at=leg[1])])
                if leg is not None and leg[0] == rank
                else contextlib.nullcontext())
            buf = io.StringIO()
            with plan, contextlib.redirect_stdout(buf):
                rc = main(list(argv))
            out.append((rc, buf.getvalue()))
    finally:
        os.chdir(old)
    return out
