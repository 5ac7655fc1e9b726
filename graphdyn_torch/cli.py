"""Command line of the port: ``python -m graphdyn_torch consensus ...``.

The ``consensus`` subcommand with the JAX package's flags and defaults
(``graphdyn/cli.py``), plus ``--device`` (default ``cuda``). It prints one
JSON document, the sweep's :func:`~graphdyn_torch.models.consensus.
consensus_doc`, and with ``--out`` also writes it atomically.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graphdyn_torch",
        description="graphdyn on PyTorch/CUDA (the port of the graphdyn "
                    "JAX package)",
        allow_abbrev=False,
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    cons = sub.add_parser(
        "consensus",
        help="forward opinion-consensus m(0) sweep "
             "(`ER_BDCM_entropy.ipynb:113-123`)",
    )
    cons.add_argument("--n", type=int, default=100_000)
    cons.add_argument(
        "--graph", choices=["er", "rrg"], default="er",
        help="ensemble: ER G(n, c/n) (config 3) or random d-regular",
    )
    cons.add_argument("--c", type=float, default=6.0, help="ER mean degree")
    cons.add_argument("--d", type=int, default=4, help="RRG degree")
    cons.add_argument("--rule", choices=["majority", "minority"],
                      default="majority")
    cons.add_argument("--tie", choices=["stay", "change"], default="stay")
    cons.add_argument("--replicas", type=int, default=512)
    cons.add_argument(
        "--m0", type=float, nargs="+",
        default=[0.0, 0.01, 0.02, 0.03, 0.05, 0.07, 0.1, 0.15, 0.2, 0.3],
        help="initial-magnetization grid",
    )
    cons.add_argument("--max-steps", type=int, default=2000)
    cons.add_argument(
        "--chunk", type=int, default=10,
        help="steps per consensus check (= first-passage resolution)",
    )
    cons.add_argument(
        "--near-eps", type=float, default=0.01,
        help="near-consensus threshold: |m_final| >= 1 - near_eps",
    )
    cons.add_argument("--seed", type=int, default=0, help="graph seed")
    cons.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; 'cpu' runs the plain "
             "PyTorch version)",
    )
    cons.add_argument("--out", default=None, help="json path for the curve")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from graphdyn_torch.models.consensus import (
        consensus_curve,
        consensus_doc,
        er_consensus_ensemble,
        rrg_consensus_ensemble,
    )
    from graphdyn_torch.utils.platform import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    if args.graph == "rrg":
        g, n_iso, nbr_dev, deg_dev = rrg_consensus_ensemble(
            args.n, d=args.d, seed=args.seed, device=dev
        )
    else:
        g, n_iso, nbr_dev, deg_dev = er_consensus_ensemble(
            args.n, c=args.c, seed=args.seed, device=dev
        )
    rows = consensus_curve(
        g, args.replicas, args.m0, args.max_steps, chunk=args.chunk,
        nbr_dev=nbr_dev, deg_dev=deg_dev, rule=args.rule, tie=args.tie,
        near_eps=args.near_eps, graph_seed=args.seed, device=dev,
    )
    doc = consensus_doc(
        g, n_iso, rows, c=args.c, seed=args.seed, rule=args.rule,
        tie=args.tie, near_eps=args.near_eps, solver="consensus",
        kind=("random_regular" if args.graph == "rrg" else "erdos_renyi"),
        d=args.d, device=dev,
    )
    if args.out:
        from graphdyn_torch.utils.io import write_json_atomic

        write_json_atomic(args.out, doc, indent=1)
    print(json.dumps(doc))
    return 0
