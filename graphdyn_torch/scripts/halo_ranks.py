"""The halo rollout on spawned ranks: each partitioned rollout equal to the
unsharded one, and its step and exchange timed apart.

    python -m graphdyn_torch.scripts.halo_ranks [--ranks N] [--P 2 4]
        [--shapes headline config3] [--steps 20] [--timed 10] [--device cuda]

Spawns ``--ranks`` processes (default: one per card), which make one process
group (:func:`graphdyn_torch.parallel.mesh.init_distributed`: NCCL when
every rank has a card of its own, gloo otherwise, e.g. ranks sharing one
card or ``--device cpu``). For each shape (``headline``: d=3 RRG n=10⁶,
R=16384, BASELINE.md:27; ``config3``: ER n=10⁵ c=6 with isolates removed,
R=512, :31; ``small``: d=3 RRG n=2000, R=64, for a CPU run) and each P
dividing the rank count, the ranks form a (ranks/P) × P replica × node mesh
and run :func:`halo_leg`: ``packed_rollout(partition=)`` for ``--steps``
steps, held to the unsharded rollout bit for bit on every rank, then a
``HaloProgram`` for ``--timed`` steps with the card synchronised around the
step and around the exchange. The partitions are built once, in the parent
(``partition_graph`` seed 0), and their host seconds reported. Prints one
JSON line per (shape, P) with every rank's medians, then
``{"ok": true, ...}``; exits non-zero when a rank fails or a result differs.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch

SHAPES = {
    # name: (graph builder args, replicas)
    "headline": (("rrg", 10**6, 3), 16384),
    "config3": (("er", 100_000, 6.0), 512),
    "small": (("rrg", 2000, 3), 64),
}


def build_graph(kind: str, n: int, a):
    from graphdyn_torch import graphs

    if kind == "rrg":
        return graphs.random_regular_graph(n, a, seed=0)
    return graphs.remove_isolates(
        graphs.erdos_renyi_graph(n, a / n, seed=0))[0]


def halo_leg(g, part, W: int, seed: int, mesh, label: str, *, steps: int,
             timed: int, device="cuda") -> dict:
    """On this rank: ``packed_rollout(partition=part, mesh=mesh)`` for
    ``steps`` steps with the packed-step counts zeroed before it and read
    after (the main path), equal to the unsharded rollout; then, for
    P >= 2, a ``HaloProgram`` advanced ``timed`` steps with the step and
    the exchange timed apart (medians over the steps, host clock with the
    card synchronised around each part)."""
    from graphdyn_torch.ops import packed_cuda
    from graphdyn_torch.ops.packed import draw_packed_biased, packed_rollout
    from graphdyn_torch.parallel.halo import HaloProgram
    from graphdyn_torch.parallel.mesh import rank_device

    dev = rank_device(device)
    nbr = torch.as_tensor(g.nbr, dtype=torch.int32, device=dev)
    deg = torch.as_tensor(g.deg, dtype=torch.int32, device=dev)
    sp = draw_packed_biased(seed, g.n, W, 0.0, device=dev)
    packed_cuda.LAUNCHES = packed_cuda.SHARD_LAUNCHES = 0
    _sync(dev)
    t0 = time.perf_counter()
    got = packed_rollout(nbr, deg, sp, steps, partition=part, mesh=mesh)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {"packed_step": packed_cuda.LAUNCHES,
                "shard": packed_cuda.SHARD_LAUNCHES}
    want = packed_rollout(nbr, deg, sp, steps)
    out = {"label": label, "P": part.P, "W": W, "wall_s": wall,
           "launches": launches, "equal": bool(torch.equal(got, want)),
           "edge_cut": int(part.edge_cut)}
    del got, want
    if part.P > 1 and timed > 0:
        prog = HaloProgram(g, part, steps=1, mesh=mesh, device=device)
        loc = prog.place(sp)
        step_ms, exch_ms = [], []
        for _ in range(timed):
            prog.stats.clear()
            loc = prog.advance(loc, timed=True)
            step_ms.append(1e3 * prog.stats["step_s"])
            exch_ms.append(1e3 * prog.stats["exchange_s"])
        out.update(step_ms=float(np.median(step_ms)),
                   exchange_ms=float(np.median(exch_ms)),
                   exchange_ms_range=[min(exch_ms), max(exch_ms)],
                   halo_bytes_per_step=prog.tables.halo_bytes_per_step(W),
                   halo_rows=int(prog.tables.n_halo_words),
                   slab_rows=int(prog.tables.n_slab_words))
        del loc, prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _legs(rank: int, world: int, job: dict) -> dict:
    """One rank of :func:`main`: every leg of ``job`` on its mesh."""
    import torch.distributed as dist

    from graphdyn_torch.parallel.mesh import make_mesh

    res = {"backend": dist.get_backend()}
    meshes = {}
    for name, g, part, W in job["legs"]:
        if part.P not in meshes:
            meshes[part.P] = make_mesh((world // part.P, part.P),
                                       ("replica", "node"),
                                       device=job["device"])
        res[(name, part.P)] = halo_leg(
            g, part, W, 1, meshes[part.P], name, steps=job["steps"],
            timed=job["timed"], device=job["device"])
    return res


def _entry(rank: int, world: int, root: str, fn, args: tuple, device,
           backend) -> None:
    import traceback

    try:
        import torch.distributed as dist

        from graphdyn_torch.parallel.mesh import init_distributed

        torch.set_num_threads(1)
        os.environ.setdefault("LOCAL_RANK", str(rank))
        os.environ.setdefault("LOCAL_WORLD_SIZE", str(world))
        init_distributed(init_method=f"file://{os.path.join(root, 'store')}",
                         world_size=world, rank=rank, device=device,
                         backend=backend)
        out = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        payload = {"ok": True, "result": out}
    except BaseException:          # noqa: BLE001 - reported to the parent
        payload = {"ok": False, "error": traceback.format_exc()}
    # graftlint: disable-next-line=GD007  a rank's result handed to its parent under the spawn's own root, read once after the join; a torn file fails the spawn
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f, protocol=4)


def run_ranks(fn, world: int, *args, device="cuda", backend=None,
              root: str | None = None, timeout: float = 1800,
              stop=None) -> list:
    """Run ``fn(rank, world, *args)`` (a module-level function) on
    ``world`` spawned processes and return its values in rank order. Each
    process takes one intra-op thread and joins one process group
    (:func:`graphdyn_torch.parallel.mesh.init_distributed` on ``device``
    and ``backend``, its default when None, through a ``FileStore`` under
    ``root``, default a temporary directory). Every process is joined, or
    killed at the timeout (or as soon as ``stop()``, polled while they run,
    returns true), before this returns; a rank that failed or left no
    result raises ``RuntimeError``, failures first."""
    import multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        root = root or tmp
        os.makedirs(root, exist_ok=True)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_entry, args=(r, world, root, fn, args,
                                                  device, backend))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + timeout
        for p in procs:
            while (p.is_alive() and not (stop and stop())
                   and time.perf_counter() < deadline):
                p.join(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        payloads = []
        for r, p in enumerate(procs):
            path = os.path.join(root, f"rank{r}.pkl")
            if not os.path.exists(path):
                payloads.append({"ok": False, "missing": True,
                                 "error": f"left no result (exit code "
                                          f"{p.exitcode})"})
                continue
            with open(path, "rb") as f:
                payloads.append(pickle.load(f))
    # a rank's own error first: the others may only have waited on it
    failed = sorted((x.get("missing", False), r, x["error"])
                    for r, x in enumerate(payloads) if not x["ok"])
    if failed:
        _, r, err = failed[0]
        raise RuntimeError(f"rank {r} of {fn.__name__} failed:\n{err}")
    return [x["result"] for x in payloads]


def main(argv=None) -> int:
    from graphdyn_torch import graphs
    from graphdyn_torch.utils.platform import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.scripts.halo_ranks",
        description="the halo rollout on spawned ranks: equality with the "
                    "unsharded rollout and the step and exchange timed apart")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes to spawn (default: one per card)")
    ap.add_argument("--P", type=int, nargs="+", default=[2],
                    help="node-axis sizes, each dividing --ranks")
    ap.add_argument("--shapes", nargs="+", default=["headline", "config3"],
                    choices=sorted(SHAPES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--timed", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    world = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                           else 2)
    for P in args.P:
        if P < 2 or world % P:
            ap.error(f"--P {P} must be >= 2 and divide --ranks {world}")
    legs = []
    for name in args.shapes:
        gargs, R = SHAPES[name]
        g = build_graph(*gargs)
        for P in args.P:
            t0 = time.perf_counter()
            part = graphs.partition_graph(g, P, seed=0)
            print(json.dumps({"shape": name, "P": P, "partition_s":
                              time.perf_counter() - t0,
                              "edge_cut": int(part.edge_cut)}), flush=True)
            legs.append((name, g, part, R // 32))
    t0 = time.perf_counter()
    ranks = run_ranks(_legs, world, {"legs": legs, "steps": args.steps,
                                     "timed": args.timed,
                                     "device": args.device},
                      device=args.device)
    ok = True
    for name, _, part, W in legs:
        rows = [r[(name, part.P)] for r in ranks]
        # on the card every rank's main path must have launched the shard
        # kernel; the CPU runs its plain twin
        ok &= all(x["equal"] and (dev.type != "cuda"
                                  or x["launches"]["shard"] > 0)
                  for x in rows)
        print(json.dumps({
            "shape": name, "P": part.P, "W": W, "ranks": world,
            "backend": ranks[0]["backend"],
            "equal_on_every_rank": all(x["equal"] for x in rows),
            "shard_launches": [x["launches"]["shard"] for x in rows],
            "main_path_wall_s": [x["wall_s"] for x in rows],
            "step_ms": [x["step_ms"] for x in rows],
            "exchange_ms": [x["exchange_ms"] for x in rows],
            "exchange_ms_range": [x["exchange_ms_range"] for x in rows],
            "halo_bytes_per_step": rows[0]["halo_bytes_per_step"],
            "edge_cut": rows[0]["edge_cut"]}), flush=True)
    device = (torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu")
    print(json.dumps({"ok": ok, "device": device, "ranks": world,
                      "spawn_wall_s": time.perf_counter() - t0}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
