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

import contextlib
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


# ---------------------------------------------------------------------------
# the sharded out-of-core stream
# ---------------------------------------------------------------------------

#: hub threshold of the power-law stream cases (the JAX tests' THR)
STREAM_THR = 12


def stream_graph(kind: str, n: int = 200, seed: int = 5):
    """The JAX stream tests' graphs (``tests/test_stream_shard.py:_graph``)."""
    from graphdyn_torch import graphs as tg

    if kind == "rrg":
        return tg.random_regular_graph(n, 3, seed=seed)
    return tg.powerlaw_graph(n, gamma=2.3, dmin=2, seed=seed)


def stream_sp0(n: int, R: int, seed: int):
    """Packed uint32 words of ±1 spins drawn from ``seed``."""
    import numpy as np

    from graphdyn_torch.interop import words_to_numpy
    from graphdyn_torch.ops.packed import pack_spins

    rng = np.random.default_rng(seed)
    s = (2 * rng.integers(0, 2, size=(R, n)) - 1).astype(np.int8)
    return words_to_numpy(pack_spins(s))


def stream_churn(g, steps: int = 5, seed: int = 3):
    """Background churn plus one batch that pushes a node over
    :data:`STREAM_THR` and one that strips the top hub below it, so both a
    promotion and a demotion repartition (``test_stream_shard.py:
    _churn_with_repartition``)."""
    import numpy as np

    from graphdyn_torch.ops.streamed import ChurnBatch, seeded_churn

    THR = STREAM_THR
    deg = g.deg.astype(int)
    v = int(np.argmax((deg < THR) & (deg >= THR - 6)))
    others = [u for u in range(g.n) if u != v][: (THR - deg[v]) + 4]
    adds = np.array([[v, u] for u in others], np.int64)
    hub = int(np.argmax(deg))
    nbrs = g.nbr[hub, : deg[hub]].astype(np.int64)
    drops = np.array([[hub, int(u)] for u in nbrs[: deg[hub] - THR + 3]],
                     np.int64)
    empty = np.empty((0, 2), np.int64)
    return sorted(seeded_churn(g.n, steps, rate=6.0, seed=seed)
                  + [ChurnBatch(step=1, adds=adds, drops=empty),
                     ChurnBatch(step=3, adds=empty, drops=drops)],
                  key=lambda b: b.step)


def stream_shard_worker(rank: int, world: int, cases: list,
                        root: str) -> dict:
    """``sharded_streamed_rollout`` (and ``sa_sharded(layout='streamed')``)
    for every case, a dict with ``key``, ``what`` and its arguments, on a
    (replica, node) mesh whose node dimension has ``P`` ranks. Returns
    ``{key: result}`` (the global words, stats, journal ops, ledger
    gauges, or the SA result) from every rank."""
    import json

    import numpy as np

    from graphdyn_torch import graphs as tg
    from graphdyn_torch.interop import words_to_numpy
    from graphdyn_torch.ops.streamed import seeded_churn
    from graphdyn_torch.parallel.stream import sharded_streamed_rollout
    from graphdyn_torch.resilience import faults

    meshes = {}

    def mesh(P):
        if P not in meshes:
            meshes[P] = _mesh_for(P, world)
        return meshes[P]

    out = {}
    for c in cases:
        key, what = c["key"], c["what"]
        if what == "sa":
            from graphdyn_torch.config import SAConfig
            from graphdyn_torch.parallel.sa_sharded import sa_sharded

            g = tg.random_regular_graph(40, 3, seed=5)
            rng = np.random.default_rng(6)
            R, L = 4, 2000
            s0 = (2 * rng.integers(0, 2, size=(R, g.n)) - 1).astype(np.int8)
            prop = rng.integers(0, g.n, size=(R, L)).astype(np.int32)
            unif = rng.random(size=(R, L))
            res = sa_sharded(g, SAConfig(), mesh=mesh(c["P"]), s0=s0,
                             proposals=prop, uniforms=unif, max_steps=30,
                             layout="streamed", stream_chunks=2,
                             hub_threshold=c.get("hub"), device="cpu")
            out[key] = _sa_result(res)
            continue
        g = stream_graph(c["kind"], c.get("n", 200))
        sp = stream_sp0(g.n, c.get("R", 32), c["seed"])
        churn = None
        if c.get("churn") == "repart":
            churn = stream_churn(g)
        elif c.get("churn") == "random":
            churn = seeded_churn(g.n, c["steps"], rate=6.0, seed=9)
        P = c["P"] if "P" in c else c["legs"][0][0]
        kw = dict(n_shards=P, rule=c.get("rule", "majority"),
                  tie=c.get("tie", "stay"), n_chunks=c.get("n_chunks"),
                  device_budget_bytes=c.get("budget"),
                  hub_threshold=c.get("hub"), churn=churn, mesh=mesh(P),
                  device="cpu")
        if c.get("partition"):
            kw["partition"] = tg.partition_graph(g, P, seed=0,
                                                 hub_threshold=c.get("hub"))
        if what == "roll":
            stats: dict = {}
            led = None
            if c.get("record"):
                from graphdyn_torch import obs

                led = os.path.join(root, f"{key}-obs{rank}.jsonl")
                with obs.recording(led):
                    res = sharded_streamed_rollout(g, sp, c["steps"],
                                                   stats_out=stats, **kw)
                from graphdyn_torch.obs.recorder import read_ledger

                events, _ = read_ledger(led)
                led = [(e.get("name"), e.get("attrs", {}).get("shard"))
                       for e in events if e.get("ev") == "gauge"]
            else:
                res = sharded_streamed_rollout(g, sp, c["steps"],
                                               stats_out=stats, **kw)
            out[key] = {"words": words_to_numpy(res), "stats": stats,
                        "gauges": led}
        elif what == "requeue":
            # legs (P, preempt at the k-th chunk boundary or None) on one
            # checkpoint path
            ck = os.path.join(root, key, "run.ckpt")
            legs = []
            for P, at in c["legs"]:
                kw.update(n_shards=P, mesh=mesh(P))
                plan = (faults.FaultPlan([faults.FaultSpec(
                    "chunk.boundary", "preempt", at=at)])
                    if at is not None else None)
                try:
                    if plan is not None:
                        plan.__enter__()
                    res = sharded_streamed_rollout(
                        g, sp, c["steps"], checkpoint_path=ck,
                        checkpoint_interval_s=0.0, **kw)
                    legs.append(("done", words_to_numpy(res)))
                except faults.InjectedPreemption:
                    legs.append(("preempted", None))
                finally:
                    if plan is not None:
                        plan.__exit__(None, None, None)
            from graphdyn_torch.resilience.store import journal_path_for

            jp = journal_path_for(ck)
            ops = sorted({str(json.loads(line).get("op"))
                          for line in open(jp)})
            out[key] = {"legs": legs, "ops": ops, "ckpt": ck}
        else:
            raise ValueError(what)
    return out


# ---------------------------------------------------------------------------
# the edge-sharded BDCM sweep and the ensemble meshes
# ---------------------------------------------------------------------------


def bdcm_graphs(kind: str):
    """The JAX package's sharded-sweep and entropy-mesh test graphs
    (``tests/test_parallel.py:96-172``)."""
    from graphdyn_torch import graphs as tg

    if kind == "rrg":
        return tg.random_regular_graph(200, 4, seed=2)
    if kind == "er":
        return tg.erdos_renyi_graph(300, 3.0 / 299, seed=2)
    if kind == "er64":
        return tg.erdos_renyi_graph(200, 2.5 / 199, seed=3)
    if kind == "union":
        return [tg.erdos_renyi_graph(60, 1.8 / 59, seed=k) for k in range(4)]
    if kind == "congruent":
        return [tg.random_regular_graph(24, 3, seed=k) for k in range(8)]
    raise ValueError(kind)


def bdcm_mesh_worker(rank: int, world: int, cases: list) -> dict:
    """The edge-sharded sweep and fixed point and the entropy meshes for
    every case (a dict: key, what, graph kind, P, dtype, sweeps), each on a
    mesh whose sharded dimension has P ranks; ``fp_spans`` records a fixed
    point to ``<ledger>-<rank>.jsonl`` and counts its spans. Returns
    ``{key: result}``."""
    import torch

    from graphdyn_torch.config import EntropyConfig
    from graphdyn_torch.models.entropy import (
        entropy_ensemble,
        entropy_ensemble_union,
    )
    from graphdyn_torch.ops.bdcm import BDCMData
    from graphdyn_torch.parallel.mesh import make_mesh
    from graphdyn_torch.parallel.sharded import (
        make_sharded_fixed_point,
        make_sharded_sweep,
    )

    meshes = {}

    def mesh(P, axis):
        if (P, axis) not in meshes:
            meshes[P, axis] = make_mesh((world // P, P), ("rest", axis),
                                        device="cpu")
        return meshes[P, axis]

    out = {}
    for c in cases:
        key, what, P = c["key"], c["what"], c["P"]
        if what == "sweep":
            data = BDCMData(bdcm_graphs(c["graph"]), p=1, c=1,
                            dtype=c["dtype"])
            sw = make_sharded_sweep(data, mesh(P, "edge"), damp=0.2,
                                    device="cpu")
            chi = data.init_messages(seed=4)
            lam = torch.tensor(0.7, dtype=data.dtype)
            for _ in range(c["sweeps"]):
                chi = sw(chi, lam)
            out[key] = chi.numpy()
        elif what == "fixed_point":
            data = BDCMData(bdcm_graphs(c["graph"]), p=1, c=1,
                            dtype=c["dtype"])
            cfg = EntropyConfig(max_sweeps=c["sweeps"], eps=1e-7)
            fp = make_sharded_fixed_point(
                data, mesh(P, "edge"), damp=cfg.damp, eps=cfg.eps,
                max_sweeps=cfg.max_sweeps, device="cpu")
            chi, t, delta = fp(data.init_messages(seed=4), 0.5)
            out[key] = (chi.numpy(), t, delta)
        elif what == "fp_spans":
            from graphdyn_torch import obs
            from graphdyn_torch.obs.recorder import read_ledger

            data = BDCMData(bdcm_graphs(c["graph"]), p=1, c=1,
                            dtype=c["dtype"])
            cfg = EntropyConfig(max_sweeps=c["sweeps"], eps=0.0)
            fp = make_sharded_fixed_point(
                data, mesh(P, "edge"), damp=cfg.damp, eps=cfg.eps,
                max_sweeps=cfg.max_sweeps, device="cpu")
            path = f"{c['ledger']}-{rank}.jsonl"
            with obs.recording(path):
                chi, t, _ = fp(data.init_messages(seed=4), 0.5)
            names = [e["name"] for e in read_ledger(path)[0]
                     if e.get("ev") == "span"]
            out[key] = {"chi": chi.numpy(), "t": t,
                        "classes": len(data.edge_classes),
                        "contract": names.count("parallel.sharded.contract"),
                        "gather": names.count("parallel.sharded.gather")}
        elif what == "union":
            cfg = EntropyConfig(lmbd_max=1.0, lmbd_step=0.5, max_sweeps=300)
            out[key] = entropy_ensemble_union(
                bdcm_graphs("union"), cfg, seed=0, mesh=mesh(P, "edge"),
                device="cpu")._asdict()
        elif what == "congruent":
            cfg = EntropyConfig(lmbd_max=1.0, lmbd_step=0.5, max_sweeps=300)
            out[key] = entropy_ensemble(
                bdcm_graphs("congruent"), cfg, seed=0,
                mesh=mesh(P, "graph"), device="cpu")._asdict()
        else:
            raise ValueError(what)
    return out


@contextlib.contextmanager
def replayed_sa_draws(table):
    """The SA chains' counter-stream draws replaced by a table
    ``(key0, proposals int32[K, L], uniforms f32[K, L])``: the chain keyed
    ``key0 + k`` reads row ``k`` at its step counter, clamped to ``L − 1``
    (the JAX package's ``jax.random`` draws of keys ``key0 + k``, made by
    the test process). ``None``: the port's own stream."""
    if table is None:
        yield
        return
    import torch

    from graphdyn_torch.models import sa as tsa

    key0, prop, unif = table
    prop, unif = torch.from_numpy(prop), torch.from_numpy(unif)
    own = tsa.draw_sa_proposal

    def replay(key, t, proposals, uniforms, *, injected, stream_len, n, dt,
               steps=1):
        if injected:
            return own(key, t, proposals, uniforms, injected=True,
                       stream_len=stream_len, n=n, dt=dt, steps=steps)
        row = (key.cpu().to(torch.int64) - key0)[:, None]
        tt = (t.cpu().to(torch.int64)[:, None] + torch.arange(steps)).clamp(
            max=prop.shape[1] - 1)
        return (prop[row, tt].to(torch.int64).to(key.device),
                unif[row, tt].to(device=key.device, dtype=dt))

    tsa.draw_sa_proposal = replay
    try:
        yield
    finally:
        tsa.draw_sa_proposal = own


@contextlib.contextmanager
def replayed_swaps(table):
    """The ladder's swap uniforms replaced by ``table[round]`` (float32
    ``[rounds, K]``, the JAX package's draws); ``None``: the port's own."""
    if table is None:
        yield
        return
    import torch

    from graphdyn_torch.search import tempering as tt

    own = tt.swap_uniforms

    def replay(seed, swap_round, K, dt):
        return torch.from_numpy(table[int(swap_round)]).to(dt)

    tt.swap_uniforms = replay
    try:
        yield
    finally:
        tt.swap_uniforms = own


def ensemble_mesh_worker(rank: int, world: int, cases: list,
                         root: str) -> dict:
    """The ensemble meshes for every case (a dict: key, what, P and the
    driver's arguments): ``hpr_solve_batch(mesh=)`` (with a resume leg),
    the entropy cell group, ``run_sa_group``/``sa_ensemble_grouped`` and
    ``temper_search(mesh=)`` (with a requeue leg), each on a mesh whose
    sharded dimension has P ranks. A case may carry the JAX package's
    streams: ``U`` (HPr uniforms ``[sweeps, R, n]``, with ``dtype``),
    ``draws`` (:func:`replayed_sa_draws`), ``I``/``U``/``SW`` (a ladder's
    proposals, uniforms and swap uniforms). Returns ``{key: result}``."""
    import numpy as np

    from graphdyn_torch import graphs as tg
    from graphdyn_torch.config import (
        DynamicsConfig,
        EntropyConfig,
        HPRConfig,
        SAConfig,
    )
    from graphdyn_torch.parallel.mesh import make_mesh
    from graphdyn_torch.resilience import ShutdownRequested, faults

    meshes = {}

    def mesh(P, axis):
        if (P, axis) not in meshes:
            meshes[P, axis] = make_mesh((world // P, P), ("rest", axis),
                                        device="cpu")
        return meshes[P, axis]

    def legs_of(c, run):
        """Run ``run(P, ckpt)`` per leg ``(P, signal at or None)`` on one
        checkpoint path."""
        ck = os.path.join(root, c["key"], "ck")
        legs = []
        for P, at in c["legs"]:
            plan = (faults.FaultPlan([faults.FaultSpec(
                c.get("site", "chunk.boundary"), "signal", at=at)])
                if at is not None else None)
            try:
                if plan is not None:
                    plan.__enter__()
                legs.append(("done", run(P, ck)))
            except ShutdownRequested:
                from graphdyn_torch.resilience.shutdown import (
                    clear_shutdown,
                )

                clear_shutdown()
                legs.append(("preempted", None))
            finally:
                if plan is not None:
                    plan.__exit__(None, None, None)
        return legs

    out = {}
    for c in cases:
        key, what = c["key"], c["what"]
        if what == "hpr":
            from graphdyn_torch.models.hpr import hpr_solve_batch

            g = tg.random_regular_graph(30, 3, seed=1)
            cfg = HPRConfig(max_sweeps=c.get("max_sweeps", 2000),
                            dtype=c.get("dtype", "float32"))
            U = c.get("U")

            def hpr(P, ck=None, c=c, g=g, cfg=cfg, U=U):
                return hpr_solve_batch(
                    g, cfg, n_replicas=c["R"], seed=0,
                    mesh=mesh(P, "replica"), replica_axis="replica",
                    checkpoint_path=ck, checkpoint_interval_s=0.0,
                    chunk_sweeps=c.get("chunk", 200),
                    uniforms=None if U is None else (lambda t: U[t]),
                    device="cpu")._asdict()

            out[key] = (legs_of(c, hpr) if "legs" in c else hpr(c["P"]))
        elif what == "cells":
            from graphdyn_torch.ops.bdcm import BDCMData
            from graphdyn_torch.pipeline.entropy_group import (
                EntropyCellExec,
                run_cell_ladder,
            )

            cfg = EntropyConfig(lmbd_max=0.2, lmbd_step=0.1)
            cells, chis = [], []
            for sd in range(4):
                g = tg.erdos_renyi_graph(40, (1.0 + 0.3 * sd) / 39, seed=sd)
                sub, n_iso = tg.remove_isolates(g)
                data = BDCMData(sub, p=1, c=1, class_bucket=32)
                cells.append((data, g.n, n_iso))
                chis.append(data.init_messages(sd).numpy())
            ex = EntropyCellExec(cells, cfg, group_size=4,
                                 mesh=mesh(c["P"], "cell"), device="cpu")
            res = run_cell_ladder(ex, chis, np.array([0.0, 0.1, 0.2]),
                                  eps=cfg.eps, ent_floor=cfg.ent_floor)
            out[key] = res._asdict()
        elif what == "sa_group":
            from graphdyn_torch.pipeline.sa_group import sa_ensemble_grouped

            cfg = SAConfig(dynamics=DynamicsConfig(p=c.get("p", 1), c=1))

            def sag(P, ck=None, c=c, cfg=cfg):
                return sa_ensemble_grouped(
                    c["n"], 3, cfg, n_stat=c["n_stat"], seed=7,
                    max_steps=c["max_steps"], group_size=c["group"],
                    chunk_steps=c.get("chunk", 256),
                    checkpoint_path=ck, checkpoint_interval_s=0.0,
                    mesh=mesh(P, "group"), device="cpu")._asdict()

            with replayed_sa_draws(c.get("draws")):
                out[key] = (legs_of(c, sag) if "legs" in c
                            else sag(c["P"]))
        elif what == "temper":
            from graphdyn_torch.search.tempering import temper_search

            g = tg.random_regular_graph(c["n"], c.get("d", 3), seed=c["gs"])
            cfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))

            def tmp(P, ck=None, c=c, g=g, cfg=cfg):
                return temper_search(
                    g, cfg, n_lanes=c["lanes"], seed=c["seed"],
                    max_steps=c["max_steps"],
                    swap_interval=c["swap_interval"], m_target=0.95,
                    stop_on_first=c.get("stop_on_first", False),
                    checkpoint_path=ck, checkpoint_interval_s=0.0,
                    proposals=c.get("I"), uniforms=c.get("U"),
                    mesh=mesh(P, "lane"), device="cpu")._asdict()

            with replayed_swaps(c.get("SW")):
                out[key] = (legs_of(c, tmp) if "legs" in c
                            else tmp(c["P"]))
        else:
            raise ValueError(what)
    return out


def stall_worker(rank: int, world: int, secs: float = 60.0) -> None:
    """A rank that only sleeps: the parent's stop test must end it."""
    import time

    time.sleep(secs)


#: the mesh ladders' checkpoint cases: a 3-point ladder preempted after
#: its first ``MESH_CKPT_AT`` λ
MESH_CKPT_CFG = dict(lmbd_max=1.0, lmbd_step=0.5, max_sweeps=300)
MESH_CKPT_AT = 1


def mesh_ladder(what: str, mesh=None, **kw):
    """``entropy_ensemble_union`` (``what='union'``, edge axis) or
    ``entropy_ensemble`` (``'congruent'``, graph axis) on the sharded-sweep
    test graphs, as a dict of the result's fields."""
    from graphdyn_torch.config import EntropyConfig
    from graphdyn_torch.models.entropy import (
        entropy_ensemble,
        entropy_ensemble_union,
    )

    cfg = EntropyConfig(**MESH_CKPT_CFG)
    fn = entropy_ensemble_union if what == "union" else entropy_ensemble
    return fn(bdcm_graphs(what), cfg, seed=0, mesh=mesh, device="cpu",
              **kw)._asdict()


def mesh_ckpt_worker(rank: int, world: int, root: str) -> dict:
    """Each mesh ladder at P = world with ``checkpoint_path``: preempted
    after λ ``MESH_CKPT_AT`` (every rank), the snapshot copied aside for a
    one-process resume, then resumed at P = world; and a run whose
    shutdown request reaches rank 1 alone (``signal``), which every rank
    honours at the same λ. Returns ``{what: {...}}``."""
    import glob
    import shutil

    import torch.distributed as dist

    from graphdyn_torch.parallel.mesh import make_mesh
    from graphdyn_torch.resilience import faults
    from graphdyn_torch.resilience.shutdown import (
        ShutdownRequested,
        clear_shutdown,
    )

    out = {}
    for what, axis in (("union", "edge"), ("congruent", "graph")):
        mesh = make_mesh((world,), (axis,), device="cpu")
        ck = os.path.join(root, f"{what}-ck")
        kw = dict(checkpoint_path=ck, checkpoint_interval_s=0.0)
        plan = faults.FaultPlan([faults.FaultSpec(
            "lambda.boundary", "preempt", at=MESH_CKPT_AT)])
        try:
            with plan:
                mesh_ladder(what, mesh, **kw)
            cut = None
        except faults.InjectedPreemption as e:
            cut = str(e)
        dist.barrier()
        if rank == 0:
            for f in glob.glob(ck + ".*"):
                shutil.copy(f, f.replace(f"{what}-ck", f"{what}-ck-p1", 1))
        dist.barrier()
        res = mesh_ladder(what, mesh, **kw)
        dist.barrier()                    # rank 0 removes the snapshot
        left = sorted(os.path.basename(f) for f in glob.glob(ck + ".*npz"))
        # a shutdown request on one rank stops every rank at one λ
        sig = faults.FaultPlan([faults.FaultSpec(
            "lambda.boundary", "signal", at=1)] if rank == 1 else [])
        sk = os.path.join(root, f"{what}-sig")
        try:
            with sig:
                mesh_ladder(what, mesh, checkpoint_path=sk,
                            checkpoint_interval_s=3600.0)
            stopped = None
        except ShutdownRequested as e:
            stopped = e.where
        finally:
            clear_shutdown()
        dist.barrier()
        sig_res = mesh_ladder(what, mesh, checkpoint_path=sk,
                              checkpoint_interval_s=3600.0)
        out[what] = {"cut": cut, "resumed": res, "left": left,
                     "stopped": stopped, "sig_resumed": sig_res}
    return out
