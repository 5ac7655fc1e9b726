"""Command line of the port: ``python -m graphdyn_torch <command> ...``.

- ``consensus``: the JAX package's flags and defaults (``graphdyn/cli.py``),
  plus ``--device`` (default ``cuda``). It prints one JSON document, the
  sweep's :func:`~graphdyn_torch.models.consensus.consensus_doc`, and with
  ``--out`` also writes it atomically.
- ``fused``: the fused one-kernel annealer with the JAX package's flags and
  defaults, ``--kernel {auto,cuda,plain}`` for ``{auto,xla,pallas}`` and
  ``--device`` (default ``cuda``). It prints the reference's JSON keys, and
  with ``--out`` writes the reference's npz keys.
- ``hpr``: HPr reinforced BP with the JAX package's flags and defaults
  (an ensemble of ``--n-rep`` fresh RRGs, or ``--batch-replicas`` chains on
  one graph), ``--kernel {auto,cuda,plain}`` for ``{auto,xla,pallas}`` and
  ``--device`` (default ``cuda``). It prints the reference's JSON keys, and
  with ``--out`` writes the reference's npz keys. ``--checkpoint`` and
  ``--device-init`` are refused (not ported yet).
- ``entropy``: the BDCM entropy λ-ladders with the JAX package's flags and
  defaults (the grouped ``entropy_grid``, or ``--union G`` ER members per
  degree through ``entropy_ensemble_union``), ``--kernel {auto,cuda,plain}``
  and ``--device`` (default ``cuda``). It prints the reference's JSON keys,
  and with ``--out`` writes the reference's npz keys. ``--checkpoint`` and
  ``--plot`` are refused (not ported yet).
- ``sa``: the SA initialization search (`SA_RRG.py`), ``n_stat`` fresh RRGs
  through ``sa_ensemble`` (grouped by default, serial with
  ``--rollout-mode lightcone`` or ``--group-size 0``); ``temper``: the
  replica-exchange ladder (``temper_search``); ``chromatic``: the chromatic
  block sweeps (``chromatic_anneal``). The reference's flags and defaults,
  ``--device`` for ``--backend``; each prints the reference's JSON keys and
  with ``--out`` writes its npz keys. Refused with the reason (not ported
  yet): ``--sharded``/``--shards``/``--lane-shards`` (A15) and
  ``--checkpoint`` (A16). ``sa --layout bucketed|streamed`` runs the serial
  repetition loop on that layout (``--stream-chunks`` chunks when
  streamed). ``sa --chunk-steps`` is the number of masked MCMC steps
  between two host reads (default 256; the chain does not depend on it).
- ``stream``: the out-of-core streamed rollout (``streamed_rollout``) on a
  seeded power-law graph, with the reference's flags and defaults, chunks
  on ``--device`` (default ``cuda``). It prints the reference's JSON keys
  and with ``--out`` writes its npz keys (``conf``, ``m_end``). Refused
  (not ported yet): ``--shards`` ≥ 2 and ``--hub-threshold`` (A15),
  ``--checkpoint`` (A16).
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

    fus = sub.add_parser(
        "fused",
        help="one-kernel annealing: the chromatic class-at-a-time chain with "
             "the rule compiled to a popcount LUT, counter-based RNG, and the "
             "anneal schedule advanced inside one CUDA launch per chunk "
             "(p=c=1 only)",
    )
    fus.add_argument("--n", type=int, default=10_000)
    fus.add_argument("--d", type=int, default=3)
    _add_dynamics_flags(fus, p_default=1)
    _add_sa_schedule_flags(fus)
    fus.add_argument("--replicas", type=int, default=32,
                     help="independent packed chains (32 per 32-bit word)")
    fus.add_argument("--m-target", type=float, default=0.9)
    fus.add_argument("--max-sweeps", type=int, default=5000)
    fus.add_argument(
        "--chunk-sweeps", type=int, default=256, metavar="S",
        help="full sweeps per kernel launch (the chunk plan is host-side; no "
             "device read-back between chunks, and the counter RNG makes "
             "splits chain-invariant)",
    )
    fus.add_argument("--stop-on-first", action="store_true",
                     help="stop at the first replica reaching --m-target "
                          "(adds a per-chunk stop test)")
    fus.add_argument(
        "--kernel", choices=["auto", "cuda", "plain"], default="auto",
        help="'auto' runs the CUDA kernel on the card and the plain PyTorch "
             "version on the CPU; 'cuda' requires the card; 'plain' forces "
             "the plain version (for tests). Both run the same chain bit for "
             "bit",
    )
    fus.add_argument(
        "--ladder-beta-max", type=float, default=None, metavar="B",
        help="per-replica drive ladder on the packed replica axis: replica r "
             "scales (b0, b-cap) by geomspace(1, B, replicas)[r]",
    )
    fus.add_argument("--seed", type=int, default=0)
    fus.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; 'cpu' runs the plain "
             "PyTorch version)",
    )
    fus.add_argument("--out", default=None,
                     help="npz path (per-replica arrays)")

    hpr = sub.add_parser("hpr", help="HPr reinforced BP (`HPR_pytorch_RRG.py`)")
    hpr.add_argument("--n", type=int, default=10_000)
    hpr.add_argument("--d", type=int, default=4)
    _add_dynamics_flags(hpr)
    hpr.add_argument("--damp", type=float, default=0.4)
    hpr.add_argument("--lmbd", type=float, default=25.0)
    hpr.add_argument("--pie", type=float, default=0.3)
    hpr.add_argument("--gamma", type=float, default=0.1)
    hpr.add_argument("--max-sweeps", type=int, default=10_000)
    hpr.add_argument("--n-rep", type=int, default=1)
    hpr.add_argument("--seed", type=int, default=0)
    hpr.add_argument("--out", default=None, help="npz path (`HPR:377` keys)")
    hpr.add_argument("--checkpoint", default=None,
                     help="not ported yet (ROADMAP A16): refused")
    hpr.add_argument(
        "--group-size", type=int, default=None, metavar="G",
        help="run G repetitions at a time as one batched program (element-"
             "wise identical to the serial loop; default min(reps, 8); 0 "
             "forces the serial repetition loop)",
    )
    hpr.add_argument(
        "--prefetch", type=int, default=2, metavar="D",
        help="build up to D upcoming graphs on a background thread while "
             "the current group computes (deterministic; 0 disables)",
    )
    hpr.add_argument(
        "--kernel", choices=["auto", "cuda", "plain"], default="auto",
        help="BDCM sweep core: 'auto' runs every edge class through the CUDA "
             "kernel on the card (every class with T = p + c <= 6; T >= 7 "
             "raises) and the plain PyTorch version on the CPU; 'cuda' "
             "requires the card; 'plain' forces the plain version (for "
             "tests)",
    )
    hpr.add_argument(
        "--dtype", choices=["float32", "float64"], default="float32",
        help="float64 matches the reference's solver precision "
             "(`HPR_pytorch_RRG.py:11`)",
    )
    hpr.add_argument(
        "--batch-replicas", type=int, default=0, metavar="R",
        help="run R independent chains on ONE graph as a single batched "
             "program (hpr_solve_batch) instead of --n-rep fresh-graph "
             "repetitions",
    )
    hpr.add_argument("--device-init", action="store_true",
                     help="not ported yet (ROADMAP A11's remainder): refused")
    hpr.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; 'cpu' runs the plain "
             "PyTorch version)",
    )

    ent = sub.add_parser("entropy", help="BDCM entropy λ-sweep (notebook)")
    ent.add_argument("--n", type=int, default=1000)
    ent.add_argument("--deg", type=float, nargs="+", default=[1.0, 1.5, 2.0])
    _add_dynamics_flags(ent)
    ent.add_argument("--lmbd-max", type=float, default=12.0)
    ent.add_argument("--lmbd-step", type=float, default=0.1)
    ent.add_argument("--eps", type=float, default=1e-6)
    ent.add_argument("--damp", type=float, default=0.1)
    ent.add_argument("--max-sweeps", type=int, default=1300)
    ent.add_argument("--ent-floor", type=float, default=-0.05)
    ent.add_argument(
        "--plateau-eps", type=float, default=0.0,
        help="stop the ladder when (m_init, ent1) move less than this for "
             "--plateau-patience consecutive lambda (0 = off, reference "
             "behavior; useful at p+c>=3 where the curve floors at positive "
             "ent1)")
    ent.add_argument("--plateau-patience", type=int, default=3)
    ent.add_argument("--num-rep", type=int, default=3)
    ent.add_argument("--seed", type=int, default=0)
    ent.add_argument("--verbose", action="store_true")
    ent.add_argument("--out", default=None, help="npz path (`ipynb:515` keys)")
    ent.add_argument("--checkpoint", default=None,
                     help="not ported yet (ROADMAP A16): refused")
    ent.add_argument(
        "--group-size", type=int, default=None, metavar="G",
        help="advance G grid cells' λ-ladders at a time as ONE batched "
             "program over stacked ragged BDCM tables (element-wise "
             "identical to the serial cell loop; default min(cells, 8); 0 "
             "forces the serial cell loop)",
    )
    ent.add_argument(
        "--prefetch", type=int, default=2, metavar="D",
        help="build up to D upcoming grid cells' ER graphs + BDCM tables "
             "on a background thread while the current cells sweep "
             "(deterministic; 0 disables)",
    )
    ent.add_argument(
        "--kernel", choices=["auto", "cuda", "plain"], default="auto",
        help="BDCM sweep core: 'auto' runs every edge class through the CUDA "
             "kernel on the card (a class the kernel does not take raises) "
             "and the plain PyTorch version on the CPU; 'cuda' requires the "
             "card; 'plain' forces the plain version (for tests)",
    )
    ent.add_argument(
        "--dtype", choices=["float32", "float64"], default="float32",
        help="float64 matches the reference's precision",
    )
    ent.add_argument("--plot", default=None, metavar="PNG",
                     help="not ported yet (ROADMAP A17: plotting): refused")
    ent.add_argument(
        "--union", type=int, default=None, metavar="G",
        help="instead of the deg x rep grid, run each degree as ONE "
             "disjoint-union program over G ER instances "
             "(entropy_ensemble_union — per-member phi/m_init by block "
             "reductions); npz keys gain a member axis",
    )
    ent.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; 'cpu' runs the plain "
             "PyTorch version)",
    )
    _add_search_parsers(sub)
    return p


def _add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; 'cpu' runs on the CPU)",
    )


def _add_not_ported_checkpoint_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--checkpoint", default=None,
                    help="not ported yet (ROADMAP A16): refused")
    ap.add_argument("--checkpoint-interval", type=float, default=30.0,
                    help="with --checkpoint (not ported yet)")
    ap.add_argument("--max-save-retries", type=int, default=None,
                    metavar="N", help="with --checkpoint (not ported yet)")


def _add_search_parsers(sub) -> None:
    """The SA search commands: ``sa``, ``temper`` and ``chromatic``."""
    sa = sub.add_parser("sa", help="SA initialization search (`SA_RRG.py`)")
    sa.add_argument("--n", type=int, default=10_000)
    sa.add_argument("--d", type=int, default=4)
    _add_dynamics_flags(sa, p_default=3)
    _add_sa_schedule_flags(sa)
    sa.add_argument("--n-stat", type=int, default=5)
    sa.add_argument("--max-steps", type=int, default=None)
    sa.add_argument("--seed", type=int, default=0)
    _add_device_flag(sa)
    sa.add_argument("--out", default=None,
                    help="npz path (`SA_RRG.py:92` keys)")
    _add_not_ported_checkpoint_flags(sa)
    sa.add_argument(
        "--group-size", type=int, default=None, metavar="G",
        help="run G repetitions at a time as ONE batched program (element-"
             "wise identical to the serial loop; default: auto, min(reps, "
             "8); 0 forces the serial repetition loop)",
    )
    sa.add_argument(
        "--prefetch", type=int, default=2, metavar="D",
        help="build up to D upcoming graphs on a background thread while "
             "the current group computes (deterministic; 0 disables)",
    )
    sa.add_argument(
        "--rollout-mode", choices=["full", "lightcone"], default="full",
        help="candidate evaluation: full graph re-roll (reference cost "
             "structure) or O(ball) light-cone roll vs a cached trajectory "
             "(bit-identical chains; runs the serial repetition loop)",
    )
    sa.add_argument("--sharded", action="store_true",
                    help="not ported yet (ROADMAP A15): refused")
    sa.add_argument("--n-replicas", type=int, default=32,
                    help="replica count for --sharded (not ported yet)")
    sa.add_argument(
        "--chunk-steps", type=int, default=None, metavar="K",
        help="masked MCMC steps per chunk between two host reads (default "
             "256); splitting the loop cannot change the chain",
    )
    sa.add_argument("--shards", type=int, default=None, metavar="P",
                    help="not ported yet (ROADMAP A15): refused")
    sa.add_argument("--ladder-max-frac", type=float, default=None,
                    help="with --sharded (not ported yet)")
    sa.add_argument(
        "--layout", choices=["auto", "padded", "bucketed", "streamed"],
        default="auto",
        help="node layout of each repetition's chain: padded tables, the "
             "degree-bucketed relabeling, or the out-of-core streamed chain "
             "(both run the serial repetition loop); auto picks bucketed "
             "when the degree CV crosses the threshold",
    )
    sa.add_argument(
        "--stream-chunks", type=int, default=4, metavar="K",
        help="with --layout streamed: host-resident chunk count of the "
             "stream plan (two chunks device-resident at a time)",
    )
    _add_stream_parser(sub)

    tmp = sub.add_parser(
        "temper",
        help="replica-exchange (parallel tempering) SA search: K lanes on "
             "the batched replica axis anneal in lockstep with seeded "
             "even/odd swap moves at chunk boundaries",
    )
    tmp.add_argument("--n", type=int, default=10_000)
    tmp.add_argument("--d", type=int, default=3)
    _add_dynamics_flags(tmp, p_default=1)
    _add_sa_schedule_flags(tmp)
    tmp.add_argument("--lanes", type=int, default=8,
                     help="temperature-ladder lanes K (one batched program)")
    tmp.add_argument(
        "--beta-min", type=float, default=1.0,
        help="drive ladder lower rung: lane k scales (b0, b-cap) by beta_k "
             "in geomspace(beta-min, beta-max, lanes); beta=1 is the "
             "reference chain",
    )
    tmp.add_argument("--beta-max", type=float, default=64.0)
    tmp.add_argument(
        "--swap-interval", type=int, default=1000, metavar="K",
        help="MCMC steps between swap moves, also the chunk (one host read "
             "each); part of the chain law",
    )
    tmp.add_argument("--no-swaps", action="store_true",
                     help="disable swap moves (a plain batched ladder)")
    tmp.add_argument(
        "--m-target", type=float, default=1.0,
        help="first-passage record: the step a lane's rolled-out end-state "
             "magnetization first reaches this (1.0 = consensus)",
    )
    tmp.add_argument("--stop-on-first", action="store_true",
                     help="stop the whole ladder at the first lane reaching "
                          "--m-target")
    tmp.add_argument("--max-steps", type=int, default=None)
    tmp.add_argument("--seed", type=int, default=0)
    tmp.add_argument("--lane-shards", type=int, default=None, metavar="P",
                     help="not ported yet (ROADMAP A15): refused")
    _add_not_ported_checkpoint_flags(tmp)
    _add_device_flag(tmp)
    tmp.add_argument("--out", default=None, help="npz path (per-lane arrays)")

    chrom = sub.add_parser(
        "chromatic",
        help="chromatic block-sweep annealing: a distance-2 coloring "
             "partitions the graph into chi classes and each class step "
             "proposes/accepts a whole independent set (p=c=1 only)",
    )
    chrom.add_argument("--n", type=int, default=10_000)
    chrom.add_argument("--d", type=int, default=3)
    _add_dynamics_flags(chrom, p_default=1)
    _add_sa_schedule_flags(chrom)
    chrom.add_argument("--replicas", type=int, default=32,
                       help="independent packed chains (32 per 32-bit word)")
    chrom.add_argument("--m-target", type=float, default=0.9)
    chrom.add_argument("--max-sweeps", type=int, default=5000)
    chrom.add_argument(
        "--chunk-sweeps", type=int, default=64, metavar="S",
        help="full sweeps per chunk (one host read each, the stop-poll "
             "granularity)",
    )
    chrom.add_argument("--stop-on-first", action="store_true")
    chrom.add_argument("--seed", type=int, default=0)
    _add_device_flag(chrom)
    chrom.add_argument("--out", default=None,
                       help="npz path (per-replica arrays)")


def _add_stream_parser(sub) -> None:
    """The ``stream`` command: the reference's flags and defaults."""
    strm = sub.add_parser(
        "stream",
        help="out-of-core streamed rollout: dynamics on a graph larger than "
             "the device budget, with host-to-device chunk copies overlapped "
             "with the chunk steps and optional live edge churn",
    )
    strm.add_argument("--n", type=int, default=4096)
    strm.add_argument("--gamma", type=float, default=2.5,
                      help="power-law degree exponent of the generated graph")
    strm.add_argument("--dmin", type=int, default=2,
                      help="power-law minimum degree")
    strm.add_argument("--graph-seed", type=int, default=0)
    strm.add_argument("--rule", choices=["majority", "minority"],
                      default="majority")
    strm.add_argument("--tie", choices=["stay", "change"], default="stay")
    strm.add_argument("--steps", type=int, default=32,
                      help="synchronous update steps")
    strm.add_argument("--replicas", type=int, default=32,
                      help="bit-packed replica count (32 per word)")
    strm.add_argument("--seed", type=int, default=0,
                      help="initial-spin seed")
    strm.add_argument("--chunks", type=int, default=4, metavar="K",
                      help="host-resident chunk count (ignored when "
                           "--device-budget is given)")
    strm.add_argument("--device-budget", type=int, default=None,
                      metavar="BYTES",
                      help="pack chunks greedily so two fit in BYTES instead "
                           "of a fixed --chunks count")
    strm.add_argument("--prefetch-depth", type=int, default=2, metavar="D",
                      help="host-prefetch lookahead; 0 makes the gathers and "
                           "copies synchronous")
    strm.add_argument("--shards", type=int, default=1, metavar="P",
                      help="P >= 2 is not ported yet (ROADMAP A15): refused")
    strm.add_argument("--hub-threshold", type=int, default=None, metavar="D",
                      help="not ported yet (ROADMAP A15): refused")
    strm.add_argument("--churn-rate", type=float, default=0.0, metavar="R",
                      help="live edge churn: Poisson(R/2) adds and drops "
                           "per step (seeded_churn)")
    strm.add_argument("--churn-seed", type=int, default=0)
    strm.add_argument("--checkpoint", default=None,
                      help="not ported yet (ROADMAP A16): refused")
    strm.add_argument("--checkpoint-interval", type=float, default=30.0,
                      help="with --checkpoint (not ported yet)")
    _add_device_flag(strm)
    strm.add_argument("--out", default=None, help="npz path (conf, m_end)")


def _add_dynamics_flags(ap: argparse.ArgumentParser, p_default: int = 1):
    ap.add_argument("--p", type=int, default=p_default, help="transient length")
    ap.add_argument("--c", type=int, default=1, help="cycle length")
    ap.add_argument("--rule", choices=["majority", "minority"],
                    default="majority")
    ap.add_argument("--tie", choices=["stay", "change"], default="stay")
    ap.add_argument("--attr-value", type=int, choices=[1, -1], default=1)


def _add_sa_schedule_flags(ap: argparse.ArgumentParser) -> None:
    """The reference SA annealing schedule (`SA_RRG.py:44-52`)."""
    ap.add_argument("--a0-frac", type=float, default=0.015)
    ap.add_argument("--b0-frac", type=float, default=0.010)
    ap.add_argument("--par-a", type=float, default=1.0005)
    ap.add_argument("--par-b", type=float, default=1.0005)
    ap.add_argument("--a-cap-frac", type=float, default=4.5)
    ap.add_argument("--b-cap-frac", type=float, default=5.0)


def _sa_config(args):
    from graphdyn_torch.config import DynamicsConfig, SAConfig

    return SAConfig(
        dynamics=DynamicsConfig(p=args.p, c=args.c, rule=args.rule,
                                tie=args.tie, attr_value=args.attr_value),
        a0_frac=args.a0_frac, b0_frac=args.b0_frac,
        par_a=args.par_a, par_b=args.par_b,
        a_cap_frac=args.a_cap_frac, b_cap_frac=args.b_cap_frac,
    )


def _fused_main(args, dev) -> int:
    import numpy as np

    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.search.fused import fused_anneal
    from graphdyn_torch.utils.io import save_results_npz

    betas = None
    if args.ladder_beta_max is not None:
        if args.ladder_beta_max < 1.0:
            raise SystemExit("--ladder-beta-max must be >= 1.0")
        betas = np.geomspace(1.0, args.ladder_beta_max, args.replicas)
    g = random_regular_graph(args.n, args.d, seed=args.seed)
    res = fused_anneal(
        g, _sa_config(args), n_replicas=args.replicas, seed=args.seed,
        m_target=args.m_target, max_sweeps=args.max_sweeps,
        chunk_sweeps=args.chunk_sweeps, stop_on_first=args.stop_on_first,
        kernel=args.kernel, betas=betas, device=dev,
    )
    if args.out:
        save_results_npz(
            args.out, conf=res.s, mag_reached=res.mag_reached,
            m_end=res.m_end, steps_to_target=res.steps_to_target,
        )
    print(json.dumps({
        "solver": "fused",
        "kernel": res.kernel_used,
        "chi": res.chi,
        "sweeps": res.sweeps,
        "device_steps": res.device_steps,
        "accepted": res.accepted,
        "m_end": res.m_end.tolist(),
        "steps_to_target": res.steps_to_target.tolist(),
        "sweeps_to_target": res.sweeps_to_target.tolist(),
        "out": args.out,
    }))
    return 0


def _hpr_main(args, dev) -> int:
    from graphdyn_torch.config import DynamicsConfig, HPRConfig
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.models.hpr import hpr_ensemble, hpr_solve_batch
    from graphdyn_torch.utils.io import save_results_npz

    cfg = HPRConfig(
        dynamics=DynamicsConfig(p=args.p, c=args.c, rule=args.rule,
                                tie=args.tie, attr_value=args.attr_value),
        damp=args.damp, lmbd=args.lmbd, pie=args.pie, gamma=args.gamma,
        max_sweeps=args.max_sweeps, dtype=args.dtype,
    )
    if args.batch_replicas < 0:
        raise SystemExit("--batch-replicas must be >= 1")
    if args.device_init and not args.batch_replicas:
        raise SystemExit("--device-init requires --batch-replicas")
    if args.batch_replicas:
        g = random_regular_graph(args.n, args.d, seed=args.seed)
        res = hpr_solve_batch(
            g, cfg, n_replicas=args.batch_replicas, seed=args.seed,
            checkpoint_path=args.checkpoint, device_init=args.device_init,
            kernel=args.kernel, device=dev,
        )
        if args.out:
            save_results_npz(
                args.out, conf=res.s, mag_reached=res.mag_reached,
                num_steps=res.num_steps, m_final=res.m_final,
                time=res.elapsed_s,
            )
        print(json.dumps({
            "solver": "hpr_batch",
            "mag_reached": res.mag_reached.tolist(),
            "num_steps": res.num_steps.tolist(),
            "m_final": res.m_final.tolist(),
            "elapsed_s": res.elapsed_s,
            "out": args.out,
        }))
        return 0
    out = hpr_ensemble(
        args.n, args.d, cfg, n_rep=args.n_rep, seed=args.seed,
        save_path=args.out, checkpoint_path=args.checkpoint,
        group_size=args.group_size, prefetch=args.prefetch,
        kernel=args.kernel, device=dev,
    )
    print(json.dumps({
        "solver": "hpr",
        "mag_reached": out.mag_reached.tolist(),
        "num_steps": out.num_steps.tolist(),
        "time": out.time.tolist(),
        "out": args.out,
    }))
    return 0


def _entropy_main(args, dev) -> int:
    import numpy as np

    from graphdyn_torch.config import DynamicsConfig, EntropyConfig
    from graphdyn_torch.graphs import erdos_renyi_graph
    from graphdyn_torch.models.entropy import (
        entropy_ensemble_union,
        entropy_grid,
    )
    from graphdyn_torch.utils.io import save_results_npz

    if args.plot:
        raise SystemExit("--plot is not ported to graphdyn_torch yet "
                         "(ROADMAP.md A17: plotting)")
    if args.checkpoint:
        raise SystemExit("--checkpoint is not ported to graphdyn_torch yet "
                         "(ROADMAP.md A16: checkpoints and resilience)")
    cfg = EntropyConfig(
        dynamics=DynamicsConfig(p=args.p, c=args.c, rule=args.rule,
                                tie=args.tie, attr_value=args.attr_value),
        lmbd_max=args.lmbd_max, lmbd_step=args.lmbd_step, eps=args.eps,
        damp=args.damp, max_sweeps=args.max_sweeps, ent_floor=args.ent_floor,
        num_rep=args.num_rep, plateau_eps=args.plateau_eps,
        plateau_patience=args.plateau_patience, dtype=args.dtype,
    )
    if args.union is not None:
        per_deg = []                       # indexed by degree position
        for di, deg in enumerate(args.deg):
            graphs = [erdos_renyi_graph(args.n, deg / (args.n - 1),
                                        seed=args.seed + 1000 * di + k)
                      for k in range(args.union)]
            per_deg.append(entropy_ensemble_union(
                graphs, cfg, seed=args.seed + 1000 * di,
                verbose=args.verbose, kernel=args.kernel, device=dev,
            ))
        if args.out:
            save_results_npz(
                args.out, deg=np.asarray(args.deg),
                **{f"{k}_deg{di}": getattr(per_deg[di], k)
                   for di in range(len(args.deg))
                   for k in ("lambdas", "ent", "m_init", "ent1", "sweeps")},
            )
        print(json.dumps({
            "solver": "entropy_union",
            "deg": list(args.deg),
            "members": args.union,
            "ent1_first_lambda": {str(deg): per_deg[di].ent1[0].tolist()
                                  for di, deg in enumerate(args.deg)},
            "nonconverged": {str(deg): per_deg[di].nonconverged
                             for di, deg in enumerate(args.deg)},
            "out": args.out,
            "plot": args.plot,
        }))
        return 0
    out = entropy_grid(
        args.n, np.asarray(args.deg), cfg, seed=args.seed,
        verbose=args.verbose, save_path=args.out, prefetch=args.prefetch,
        group_size=args.group_size, kernel=args.kernel, device=dev,
    )
    print(json.dumps({
        "solver": "entropy",
        "deg": out.deg.tolist(),
        "ent1_first_lambda": out.ent1[:, :, 0].tolist(),
        "counts": out.counts.tolist(),
        "out": args.out,
        "plot": args.plot,
    }))
    return 0


def _refuse(reason: str, item: str):
    raise SystemExit(f"{reason} is not ported to graphdyn_torch yet "
                     f"(ROADMAP.md {item})")


def _sa_main(args, dev):
    """The ``sa`` command; returns the ``SAEnsembleResult``."""
    from graphdyn_torch.models.sa import CHUNK_STEPS, sa_ensemble

    if args.sharded or args.shards is not None:
        _refuse("--sharded/--shards (the multi-device SA solver)",
                "A15: parallel/ onto torch.distributed")
    if args.checkpoint:
        _refuse("--checkpoint", "A16: checkpoints and resilience")
    out = sa_ensemble(
        args.n, args.d, _sa_config(args), n_stat=args.n_stat, seed=args.seed,
        max_steps=args.max_steps, save_path=args.out,
        rollout_mode=args.rollout_mode, group_size=args.group_size,
        prefetch=args.prefetch, layout=args.layout,
        chunk_steps=args.chunk_steps or CHUNK_STEPS,
        stream_chunks=args.stream_chunks, device=dev,
    )
    print(json.dumps({
        "solver": "sa",
        "mag_reached": out.mag_reached.tolist(),
        "num_steps": out.num_steps.tolist(),
        "m_final": out.m_final.tolist(),
        "out": args.out,
    }))
    return out


def _temper_main(args, dev):
    """The ``temper`` command; returns the ``TemperResult``."""
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.search.tempering import ladder_betas, temper_search
    from graphdyn_torch.utils.io import save_results_npz

    if args.lane_shards is not None:
        _refuse("--lane-shards", "A15: parallel/ onto torch.distributed")
    if args.checkpoint:
        _refuse("--checkpoint", "A16: checkpoints and resilience")
    g = random_regular_graph(args.n, args.d, seed=args.seed)
    res = temper_search(
        g, _sa_config(args),
        betas=ladder_betas(args.lanes, args.beta_min, args.beta_max),
        seed=args.seed, max_steps=args.max_steps,
        swap_interval=args.swap_interval, swap_moves=not args.no_swaps,
        m_target=args.m_target, stop_on_first=args.stop_on_first,
        device=dev,
    )
    if args.out:
        save_results_npz(
            args.out, conf=res.s, mag_reached=res.mag_reached,
            num_steps=res.num_steps, m_final=res.m_final,
            t_target=res.t_target, betas=res.betas,
        )
    print(json.dumps({
        "solver": "temper",
        "lanes": int(res.betas.size),
        "lane_shards": args.lane_shards,
        "betas": res.betas.tolist(),
        "num_steps": res.num_steps.tolist(),
        "m_final": res.m_final.tolist(),
        "t_target": res.t_target.tolist(),
        "steps_to_target": res.steps_to_target,
        "target_lane": res.target_lane,
        "swap_attempts": res.swap_attempts,
        "swap_accepts": res.swap_accepts,
        "swap_acceptance_rate": res.swap_acceptance_rate,
        "out": args.out,
    }))
    return res


def _chromatic_main(args, dev):
    """The ``chromatic`` command; returns the ``ChromaticResult``."""
    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.search.chromatic import chromatic_anneal
    from graphdyn_torch.utils.io import save_results_npz

    g = random_regular_graph(args.n, args.d, seed=args.seed)
    res = chromatic_anneal(
        g, _sa_config(args), n_replicas=args.replicas, seed=args.seed,
        m_target=args.m_target, max_sweeps=args.max_sweeps,
        chunk_sweeps=args.chunk_sweeps, stop_on_first=args.stop_on_first,
        device=dev,
    )
    if args.out:
        save_results_npz(
            args.out, conf=res.s, mag_reached=res.mag_reached,
            m_end=res.m_end, steps_to_target=res.steps_to_target,
        )
    print(json.dumps({
        "solver": "chromatic",
        "chi": res.chi,
        "sweeps": res.sweeps,
        "device_steps": res.device_steps,
        "accepted": res.accepted,
        "m_end": res.m_end.tolist(),
        "steps_to_target": res.steps_to_target.tolist(),
        "sweeps_to_target": res.sweeps_to_target.tolist(),
        "out": args.out,
    }))
    return res


def _stream_main(args, dev) -> dict:
    """The ``stream`` command; returns its JSON document."""
    import numpy as np

    from graphdyn_torch.graphs import powerlaw_graph
    from graphdyn_torch.ops.packed import pack_spins, unpack_spins
    from graphdyn_torch.ops.streamed import seeded_churn, streamed_rollout
    from graphdyn_torch.utils.io import save_results_npz

    if args.shards < 1:
        raise SystemExit("--shards must be >= 1")
    if args.shards >= 2 or args.hub_threshold is not None:
        _refuse("--shards >= 2 / --hub-threshold (the sharded stream)",
                "A15: parallel/ onto torch.distributed")
    if args.checkpoint:
        _refuse("--checkpoint", "A16: checkpoints and resilience")
    g = powerlaw_graph(args.n, gamma=args.gamma, dmin=args.dmin,
                       seed=args.graph_seed)
    rng = np.random.default_rng(args.seed)
    s0 = (2 * rng.integers(0, 2, size=(args.replicas, args.n)) - 1
          ).astype(np.int8)
    churn = (seeded_churn(args.n, args.steps, rate=args.churn_rate,
                          seed=args.churn_seed)
             if args.churn_rate > 0 else None)
    stats: dict = {}
    sp_end = streamed_rollout(
        g, pack_spins(s0), args.steps,
        rule=args.rule, tie=args.tie,
        n_chunks=None if args.device_budget is not None else args.chunks,
        device_budget_bytes=args.device_budget,
        prefetch_depth=args.prefetch_depth, churn=churn, seed=args.seed,
        stats_out=stats, device=dev,
    )
    s_end = unpack_spins(sp_end, args.replicas).numpy()
    m_end = s_end.astype(np.float64).sum(axis=1) / args.n
    if args.out:
        save_results_npz(args.out, conf=s_end, m_end=m_end)
    doc = {
        "solver": "stream", "n": args.n, "steps": args.steps,
        "shards": args.shards,
        "chunks": stats.get("chunks"),
        "overlap_frac": stats.get("overlap_frac"),
        "h2d_bytes": stats.get("h2d_bytes"),
        "d2h_bytes": stats.get("d2h_bytes"),
        "mutations": stats.get("mutations"),
        "repartitions": stats.get("repartitions"),
        "m_end_mean": float(m_end.mean()),
        "out": args.out,
    }
    print(json.dumps(doc))
    return doc


_SEARCH_COMMANDS = {"sa": _sa_main, "temper": _temper_main,
                    "chromatic": _chromatic_main, "stream": _stream_main}


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
    if args.cmd == "fused":
        return _fused_main(args, dev)
    if args.cmd == "hpr":
        return _hpr_main(args, dev)
    if args.cmd == "entropy":
        return _entropy_main(args, dev)
    if args.cmd in _SEARCH_COMMANDS:
        _SEARCH_COMMANDS[args.cmd](args, dev)
        return 0
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
