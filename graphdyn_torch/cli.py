"""Command line of the port: ``python -m graphdyn_torch <command> ...``.

- ``consensus``: the JAX package's flags and defaults (``graphdyn/cli.py``),
  plus ``--device`` (default ``cuda``). It prints one JSON document, the
  sweep's :func:`~graphdyn_torch.models.consensus.consensus_doc`, with
  ``--out`` also writes it atomically, and with ``--plot PNG`` renders the
  curve (needs matplotlib). ``--sharded`` shards the packed word axis over
  the ranks of a ``torchrun`` job (one rank per card; a single process is a
  one-rank mesh), bit-identical to the unsharded sweep; rank 0 prints and
  writes.
- ``fused``: the fused one-kernel annealer with the JAX package's flags and
  defaults, ``--kernel {auto,cuda,plain}`` for ``{auto,xla,pallas}`` and
  ``--device`` (default ``cuda``). It prints the reference's JSON keys, and
  with ``--out`` writes the reference's npz keys.
- ``hpr``: HPr reinforced BP with the JAX package's flags and defaults
  (an ensemble of ``--n-rep`` fresh RRGs, or ``--batch-replicas`` chains on
  one graph), ``--kernel {auto,cuda,plain}`` for ``{auto,xla,pallas}`` and
  ``--device`` (default ``cuda``). It prints the reference's JSON keys, and
  with ``--out`` writes the reference's npz keys. ``--device-init`` (with
  ``--batch-replicas``) draws the initial state on the device.
- ``entropy``: the BDCM entropy λ-ladders with the JAX package's flags and
  defaults (the grouped ``entropy_grid``, or ``--union G`` ER members per
  degree through ``entropy_ensemble_union``), ``--kernel {auto,cuda,plain}``
  and ``--device`` (default ``cuda``). It prints the reference's JSON keys,
  and with ``--out`` writes the reference's npz keys. ``--plot PNG`` renders
  the curves (needs matplotlib; refused before the run without it).
- ``sa``: the SA initialization search (`SA_RRG.py`), ``n_stat`` fresh RRGs
  through ``sa_ensemble`` (grouped by default, serial with
  ``--rollout-mode lightcone`` or ``--group-size 0``); ``temper``: the
  replica-exchange ladder (``temper_search``); ``chromatic``: the chromatic
  block sweeps (``chromatic_anneal``). The reference's flags and defaults,
  ``--device`` for ``--backend``; each prints the reference's JSON keys and
  with ``--out`` writes its npz keys. ``sa --sharded`` runs the mesh
  solver (``parallel.sa_sharded``) over the ranks of a ``torchrun --nproc-
  per-node N`` job with the reference's flags (``--n-replicas``,
  ``--chunk-steps``, ``--shards P`` for a node axis of P ranks in the halo
  mode, ``--ladder-max-frac``, ``--rollout-mode``), its refusals and its
  JSON keys (``"solver": "sa_sharded"``, ``"mesh"``, ``"node_mode"``),
  printed by rank 0; every rank exits with the same code, 75 after a
  SIGTERM on any of them. Refused with the reason (not ported yet):
  ``temper --lane-shards`` and ``sa --sharded --layout streamed`` (A15b).
  ``sa --layout bucketed|streamed`` runs the serial
  repetition loop on that layout (``--stream-chunks`` chunks when
  streamed). ``sa --chunk-steps`` is the number of masked MCMC steps
  between two host reads (default 256; the chain does not depend on it).
- ``stream``: the out-of-core streamed rollout (``streamed_rollout``) on a
  seeded power-law graph, with the reference's flags and defaults, chunks
  on ``--device`` (default ``cuda``). It prints the reference's JSON keys
  and with ``--out`` writes its npz keys (``conf``, ``m_end``). Refused
  (not ported yet): ``--shards`` ≥ 2 and ``--hub-threshold`` (A15b).
- ``run-supervised``: the restart loop of
  :mod:`graphdyn_torch.resilience.supervisor` around another command.

Durability, as in the JAX package (the same flags, environment variables,
exit codes and files): ``--checkpoint PREFIX`` (``--checkpoint-interval``,
``--max-save-retries``) on ``sa``, ``temper``, ``stream``, ``hpr`` and
``entropy``; before the command, ``--ckpt-mirror``, ``--ckpt-keep``,
``--stall-timeout`` and ``--deadline`` (``GRAPHDYN_CKPT_MIRROR``,
``GRAPHDYN_CKPT_KEEP``, ``GRAPHDYN_STALL_TIMEOUT``, ``GRAPHDYN_DEADLINE``;
the flag wins). Exit codes: 0 done; 75 a graceful preemption (SIGTERM,
SIGINT, a deadline or the stall watchdog) saved at the next boundary, safe
to requeue; 130 a hard abort (a second signal, or a wedged run); 86 a
supervised run quarantined after a crash loop; anything else a failure.

Telemetry, as in the JAX package: ``--obs-ledger PATH`` (``GRAPHDYN_OBS``)
records the run's event ledger and ``--profile DIR`` (``GRAPHDYN_PROFILE``)
a ``torch.profiler`` trace whose ranges carry the ledger's span names; both
go before the command. A run that dies (an unhandled exception, a
preemption, a second signal) leaves its flight post-mortem,
``obs_postmortem.jsonl`` in the working directory, or an ``obs.crash`` event
in a live ledger. Neither changes a result.
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
        epilog="Exit codes: 0 success; 75 graceful preemption (SIGTERM/"
               "SIGINT, a --deadline expiry or the --stall-timeout watchdog; "
               "with --checkpoint the state was saved at the next boundary), "
               "safe to requeue; 130 hard abort (a second signal, or a wedged "
               "run); 86 a supervised run quarantined after a crash loop "
               "(run-supervised; do not requeue); anything else a failure.",
    )
    p.add_argument(
        "--ckpt-mirror", default=None, metavar="DIR",
        help="replicate every checkpoint save into a second directory "
             "(write-behind); a resume fails over to it when no primary copy "
             "verifies. Also GRAPHDYN_CKPT_MIRROR (the flag wins)")
    p.add_argument(
        "--ckpt-keep", type=int, default=None, metavar="K",
        help="retain the last K checkpoint versions (<ckpt>.v<N>.npz) beside "
             "the published snapshot (default 2; also GRAPHDYN_CKPT_KEEP, "
             "the flag wins)")
    p.add_argument(
        "--stall-timeout", type=float, default=None, metavar="SECS",
        help="liveness watchdog: no chunk/rep/lambda heartbeat for SECS "
             "requests a graceful shutdown (snapshot, exit 75); a run still "
             "wedged after the grace window is aborted (exit 130). Also "
             "GRAPHDYN_STALL_TIMEOUT (the flag wins)")
    p.add_argument(
        "--deadline", type=float, default=None, metavar="SECS",
        help="run time budget: after SECS take the SIGTERM path (snapshot at "
             "the next boundary, exit 75). Also GRAPHDYN_DEADLINE (the flag "
             "wins)")
    p.add_argument(
        "--obs-ledger", default=None, metavar="PATH",
        help="write the run's telemetry event ledger (append-only JSONL: "
             "run manifest, nested spans, counters, gauges; the JAX "
             "package's schema) to PATH; also GRAPHDYN_OBS (the flag wins). "
             "Render with `python -m graphdyn_torch.obs report PATH`")
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the run (CPU and, on a "
             "card, CUDA) into DIR as a chrome trace; while profiling, every "
             "obs span opens a record_function range named with its ledger "
             "name path; also GRAPHDYN_PROFILE (the flag wins)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sup = sub.add_parser(
        "run-supervised",
        help="run a command under the restart loop (python -m "
             "graphdyn_torch.resilience.supervisor): watchdog, per-episode "
             "deadline, bounded restarts, crash-loop quarantine (exit 86)")
    sup.add_argument(
        "command", nargs=argparse.REMAINDER,
        help="supervisor flags, then the command after '--': "
             "run-supervised --stall-timeout 300 -- sa --checkpoint ck/run")
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
        "--sharded", action="store_true",
        help="shard the packed word axis over the ranks of the job (torchrun "
             "--nproc-per-node N; zero per-step collectives; bit-identical "
             "to unsharded)",
    )
    cons.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; 'cpu' runs the plain "
             "PyTorch version)",
    )
    cons.add_argument("--out", default=None, help="json path for the curve")
    cons.add_argument(
        "--plot", default=None, metavar="PNG",
        help="render consensus fraction + first-passage vs m(0)",
    )

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
    _add_checkpoint_flags(hpr, "(driver + chain); SIGTERM then saves at the "
                          "next chunk boundary and exits 75")
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
    hpr.add_argument(
        "--device-init", action="store_true",
        help="with --batch-replicas: draw the initial chi, biases and chain "
             "seeds on the device from the port's Threefry init stream "
             "(nothing union-sized crosses the host link; statistically "
             "equivalent to the host draw, not bit-equal)",
    )
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
    _add_checkpoint_flags(ent, "(exact λ-granular resume; with --union, "
                          "one file <prefix>_deg<i> per degree); SIGTERM then "
                          "saves at the next λ and exits 75")
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
                     help="render the s(m_init) curves to PNG (needs "
                          "matplotlib)")
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


def _add_checkpoint_flags(ap: argparse.ArgumentParser, what: str) -> None:
    """``--checkpoint``, ``--checkpoint-interval`` and
    ``--max-save-retries``, the JAX package's."""
    ap.add_argument("--checkpoint", default=None, metavar="PREFIX",
                    help=f"path prefix for preemption-safe exact resume {what}")
    ap.add_argument("--checkpoint-interval", type=float, default=30.0,
                    metavar="SECS", help="seconds between periodic snapshots")
    ap.add_argument(
        "--max-save-retries", type=int, default=None, metavar="N",
        help="retry a failed checkpoint save up to N times (exponential "
             "backoff) before skipping that snapshot with a warning; the run "
             "goes on either way (default: 2)")


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
    _add_checkpoint_flags(sa, "(driver + chain); SIGTERM then saves at the "
                          "next chunk boundary and exits 75")
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
    sa.add_argument(
        "--sharded", action="store_true",
        help="run the mesh solver over the ranks of the job (torchrun "
             "--nproc-per-node N): replicas over the replica axis, nodes "
             "over the node axis; bit-identical chains to the unsharded "
             "solver under the same draws",
    )
    sa.add_argument(
        "--n-replicas", type=int, default=32,
        help="replica count for --sharded; with --ladder-max-frac the per-"
             "replica a0 spans [a0-frac, ladder-max-frac] linearly",
    )
    sa.add_argument(
        "--chunk-steps", type=int, default=None, metavar="K",
        help="masked MCMC steps per chunk between two host reads (default "
             "256); splitting the loop cannot change the chain",
    )
    sa.add_argument(
        "--shards", type=int, default=None, metavar="P",
        help="with --sharded: partition the graph's NODE axis into P parts "
             "(edge-cut partitioner) and run the halo exchange over a node "
             "axis of P ranks; P=1 keeps one node shard",
    )
    sa.add_argument(
        "--ladder-max-frac", type=float, default=None,
        help="with --sharded: a0 = linspace(a0-frac, this, n-replicas) * n "
             "(a temperature ladder on the replica axis)",
    )
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
                     help="not ported yet (ROADMAP A15b): refused")
    _add_checkpoint_flags(tmp, "(swap boundaries); SIGTERM then saves at "
                          "the next boundary and exits 75")
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
                      help="P >= 2 is not ported yet (ROADMAP A15b): refused")
    strm.add_argument("--hub-threshold", type=int, default=None, metavar="D",
                      help="not ported yet (ROADMAP A15b): refused")
    strm.add_argument("--churn-rate", type=float, default=0.0, metavar="R",
                      help="live edge churn: Poisson(R/2) adds and drops "
                           "per step (seeded_churn)")
    strm.add_argument("--churn-seed", type=int, default=0)
    _add_checkpoint_flags(strm, "; applied churn is journaled (stream.churn) "
                          "so a resumed run replays it from the journal "
                          "alone; SIGTERM then saves at the next step and "
                          "exits 75")
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
    if args.device_init and args.checkpoint:
        raise SystemExit(
            "--device-init is incompatible with --checkpoint (snapshots pull "
            "the union state back over the host link every interval)")
    if args.batch_replicas:
        g = random_regular_graph(args.n, args.d, seed=args.seed)
        res = hpr_solve_batch(
            g, cfg, n_replicas=args.batch_replicas, seed=args.seed,
            checkpoint_path=args.checkpoint,
            checkpoint_interval_s=args.checkpoint_interval,
            device_init=args.device_init, kernel=args.kernel, device=dev,
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
        checkpoint_interval_s=args.checkpoint_interval,
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
        # fail fast, before the (possibly hours-long) sweep, if the plot
        # cannot be written at the end
        _require_matplotlib()
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
                checkpoint_path=(f"{args.checkpoint}_deg{di}"
                                 if args.checkpoint else None),
                checkpoint_interval_s=args.checkpoint_interval,
                verbose=args.verbose, kernel=args.kernel, device=dev,
            ))
        if args.out:
            save_results_npz(
                args.out, deg=np.asarray(args.deg),
                **{f"{k}_deg{di}": getattr(per_deg[di], k)
                   for di in range(len(args.deg))
                   for k in ("lambdas", "ent", "m_init", "ent1", "sweeps")},
            )
        if args.plot:
            from types import SimpleNamespace

            from graphdyn_torch.plotting import masked_mean, plot_entropy_curve

            ax = None
            for di, deg in enumerate(args.deg):
                r = per_deg[di]
                ok = np.isfinite(r.m_init) & np.isfinite(r.ent1)
                # the member mean over jointly finite members
                mean = SimpleNamespace(m_init=masked_mean(r.m_init, ok, axis=1),
                                       ent1=masked_mean(r.ent1, ok, axis=1))
                ax = plot_entropy_curve(mean, ax=ax, label=f"deg={deg:g}")
            ax.figure.tight_layout()
            ax.figure.savefig(args.plot)
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
        verbose=args.verbose, save_path=args.out,
        checkpoint_path=args.checkpoint,
        checkpoint_interval_s=args.checkpoint_interval,
        prefetch=args.prefetch, group_size=args.group_size,
        kernel=args.kernel, device=dev,
    )
    if args.plot:
        from graphdyn_torch.plotting import plot_entropy_grid

        plot_entropy_grid(out, save_path=args.plot)
    print(json.dumps({
        "solver": "entropy",
        "deg": out.deg.tolist(),
        "ent1_first_lambda": out.ent1[:, :, 0].tolist(),
        "counts": out.counts.tolist(),
        "out": args.out,
        "plot": args.plot,
    }))
    return 0


def _require_matplotlib() -> None:
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("--plot requires matplotlib, which is not installed")


def _refuse(reason: str, item: str):
    raise SystemExit(f"{reason} is not ported to graphdyn_torch yet "
                     f"(ROADMAP.md {item})")


def _writer() -> bool:
    """True on the rank that prints and writes (rank 0, or the only
    process)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _process_group(dev):
    """The job's process group for a sharded command (``torchrun``'s
    environment; a no-op for a single process) and whether this call made
    it, so the command tears down only its own."""
    import torch.distributed as dist

    from graphdyn_torch.parallel.mesh import init_distributed

    made = not dist.is_initialized()
    init_distributed(device=dev)
    return made and dist.is_initialized()


def _sa_sharded_main(args, dev):
    """``sa --sharded``: the mesh solver over the job's ranks
    (``graphdyn/cli.py:890-975``)."""
    import numpy as np
    import torch.distributed as dist

    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.parallel.mesh import make_mesh, rank_device
    from graphdyn_torch.parallel.sa_sharded import sa_sharded
    from graphdyn_torch.utils.io import save_results_npz

    if args.layout == "streamed":
        _refuse("sa --sharded --layout streamed (the sharded out-of-core "
                "chain)", "A15b")
    dev = rank_device(args.device)
    made = _process_group(dev)
    try:
        n_dev = dist.get_world_size() if dist.is_initialized() else 1
        node_mode = "gather"
        if args.shards is not None:
            if args.rollout_mode == "lightcone":
                raise SystemExit(
                    "--shards partitions the node axis; --rollout-mode "
                    "lightcone keeps whole replicas per device, so there is "
                    "no node axis to shard")
            if args.shards < 1:
                raise SystemExit("--shards must be >= 1")
            if args.shards > n_dev:
                raise SystemExit(
                    f"--shards {args.shards} > {n_dev} ranks in the job")
            node_shards = args.shards
            if node_shards >= 2:
                node_mode = "halo"
        elif args.rollout_mode == "lightcone":
            node_shards = 1
        else:
            node_shards = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
        if n_dev % node_shards:
            raise SystemExit(f"--shards {node_shards} does not divide the "
                             f"job's {n_dev} ranks")
        mesh = make_mesh((max(n_dev // node_shards, 1), node_shards),
                         ("replica", "node"), device=dev)
        g = random_regular_graph(args.n, args.d, seed=args.seed)
        a0 = None
        if args.ladder_max_frac is not None:
            a0 = np.linspace(args.a0_frac, args.ladder_max_frac,
                             args.n_replicas) * args.n
        res = sa_sharded(
            g, _sa_config(args), mesh=mesh, n_replicas=args.n_replicas,
            a0=a0, seed=args.seed, max_steps=args.max_steps,
            checkpoint_path=args.checkpoint,
            checkpoint_interval_s=args.checkpoint_interval,
            rollout_mode=args.rollout_mode, node_mode=node_mode,
            chunk_steps=args.chunk_steps, device=dev,
        )
        if _writer():
            if args.out:
                save_results_npz(
                    args.out, mag_reached=res.mag_reached,
                    num_steps=res.num_steps, conf=res.s,
                    m_final=res.m_final,
                )
            print(json.dumps({
                "solver": "sa_sharded",
                "mesh": {"replica": max(n_dev // node_shards, 1),
                         "node": node_shards},
                "node_mode": node_mode,
                "mag_reached": res.mag_reached.tolist(),
                "num_steps": res.num_steps.tolist(),
                "m_final": res.m_final.tolist(),
                "out": args.out,
            }))
        return res
    finally:
        if made:
            dist.destroy_process_group()


def _sa_main(args, dev):
    """The ``sa`` command; returns the ``SAEnsembleResult``."""
    from graphdyn_torch.models.sa import CHUNK_STEPS, sa_ensemble

    if args.shards is not None and not args.sharded:
        # a silently ignored sharding request would run the serial driver
        # while the operator believes the job sharded
        raise SystemExit(
            "--shards partitions the node axis of the MESH solver; pass "
            "--sharded as well (the per-repetition driver has no node axis "
            "to shard)")
    if args.sharded and args.layout not in ("auto", "padded", "streamed"):
        raise SystemExit(
            f"--layout {args.layout} selects a per-repetition driver "
            "layout; the mesh solver shards the padded node axis (drop "
            "--sharded, or --layout auto/padded)")
    if args.sharded:
        return _sa_sharded_main(args, dev)
    out = sa_ensemble(
        args.n, args.d, _sa_config(args), n_stat=args.n_stat, seed=args.seed,
        max_steps=args.max_steps, save_path=args.out,
        checkpoint_path=args.checkpoint,
        checkpoint_interval_s=args.checkpoint_interval,
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
        _refuse("--lane-shards (the lane-sharded ladder)",
                "A15b: the ensemble meshes")
    g = random_regular_graph(args.n, args.d, seed=args.seed)
    res = temper_search(
        g, _sa_config(args),
        betas=ladder_betas(args.lanes, args.beta_min, args.beta_max),
        seed=args.seed, max_steps=args.max_steps,
        swap_interval=args.swap_interval, swap_moves=not args.no_swaps,
        m_target=args.m_target, stop_on_first=args.stop_on_first,
        checkpoint_path=args.checkpoint,
        checkpoint_interval_s=args.checkpoint_interval, device=dev,
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
                "A15b: the sharded out-of-core stream")
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
        prefetch_depth=args.prefetch_depth, churn=churn,
        checkpoint_path=args.checkpoint,
        checkpoint_interval_s=args.checkpoint_interval, seed=args.seed,
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
    """Parse the flags and run the command under the graceful-shutdown
    protocol: a SIGTERM/SIGINT (or the watchdog, or the deadline) saves at
    the next chunk/rep/λ boundary when ``--checkpoint`` is set and exits
    75; a second signal exits 130. ``run-supervised`` hands over to the
    supervisor before anything else."""
    import os
    import sys

    from graphdyn_torch.resilience import (
        EX_ABORT,
        EX_TEMPFAIL,
        ShutdownRequested,
        graceful_shutdown,
        set_save_retry,
    )
    from graphdyn_torch.resilience.store import _env_keep, configure_store
    from graphdyn_torch.resilience.supervisor import (
        env_float,
        supervision,
    )
    from graphdyn_torch.resilience.supervisor import main as supervisor_main

    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "run-supervised":
        # the supervisor parents runs and is never inside one; its own
        # leading flags do not fit argparse's REMAINDER, so the raw argv goes
        cmd = argv[1:]
        return supervisor_main(cmd[1:] if cmd[:1] == ["--"] else cmd)
    args = build_parser().parse_args(argv)
    if args.cmd == "run-supervised":
        # top-level flags before the subcommand: the watchdog's go to the
        # supervisor, the store's back onto the child's command line
        cmd = list(args.command)
        cmd = cmd[1:] if cmd[:1] == ["--"] else cmd
        sup: list = []
        for flag, val in (("--stall-timeout", args.stall_timeout),
                          ("--deadline", args.deadline)):
            if val is not None:
                sup += [flag, str(val)]
        child: list = []
        for flag, val in (("--ckpt-mirror", args.ckpt_mirror),
                          ("--ckpt-keep", args.ckpt_keep)):
            if val is not None:
                child += [flag, str(val)]
        return supervisor_main(sup + ["--"] + child + cmd)
    if getattr(args, "max_save_retries", None) is not None:
        set_save_retry(args.max_save_retries)
    # set both store knobs on every run, so one in-process call cannot leak
    # its mirror into the next (flag wins over the environment)
    configure_store(
        mirror=args.ckpt_mirror or os.environ.get("GRAPHDYN_CKPT_MIRROR")
        or None,
        keep=args.ckpt_keep if args.ckpt_keep is not None else _env_keep())
    stall = (args.stall_timeout if args.stall_timeout is not None
             else env_float("GRAPHDYN_STALL_TIMEOUT"))
    deadline = (args.deadline if args.deadline is not None
                else env_float("GRAPHDYN_DEADLINE"))
    from graphdyn_torch import obs
    from graphdyn_torch.obs import flight, trace

    try:
        with graceful_shutdown(), obs.recording(args.obs_ledger) as rec, \
                trace.profiling(args.profile), supervision(stall, deadline):
            if rec.enabled:
                rec.manifest(**obs.run_manifest_fields(
                    cmd=args.cmd, argv=list(argv),
                    config={k: v for k, v in sorted(vars(args).items())}))
            # the dump sites sit inside the recording scope: a live ledger
            # takes the obs.crash event, else obs_postmortem.jsonl is written
            try:
                with rec.span("run", cmd=args.cmd):
                    return _run(args)
            except ShutdownRequested as e:
                flight.dump("preempt", exc=e, site=e.where)
                raise
            except KeyboardInterrupt as e:
                flight.dump("abort", exc=e)
                raise
            except Exception as e:
                flight.dump("exception", exc=e)
                raise
    except ShutdownRequested as e:
        print(f"graphdyn_torch: {e} — exiting {EX_TEMPFAIL} (requeue me)",
              file=sys.stderr)
        return EX_TEMPFAIL
    except KeyboardInterrupt:
        print(f"graphdyn_torch: second signal — hard abort, no snapshot "
              f"written; exiting {EX_ABORT}", file=sys.stderr)
        return EX_ABORT


def _run(args) -> int:
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
    if args.plot:
        _require_matplotlib()
    mesh = None
    made = False
    if args.sharded:
        import torch.distributed as dist

        from graphdyn_torch.parallel.mesh import make_mesh, rank_device

        dev = rank_device(args.device)
        made = _process_group(dev)
        mesh = make_mesh(None, ("replica",), device=dev)
    try:
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
            mesh=mesh,
        )
        writer = _writer()
    finally:
        if made:
            dist.destroy_process_group()
    if not writer:
        return 0
    doc = consensus_doc(
        g, n_iso, rows, c=args.c, seed=args.seed, rule=args.rule,
        tie=args.tie, near_eps=args.near_eps, solver="consensus",
        kind=("random_regular" if args.graph == "rrg" else "erdos_renyi"),
        d=args.d, device=dev,
    )
    if args.out:
        from graphdyn_torch.utils.io import write_json_atomic

        write_json_atomic(args.out, doc, indent=1)
    if args.plot:
        from graphdyn_torch.plotting import plot_consensus_curve

        plot_consensus_curve(
            rows,
            title=(f"RRG d={args.d}" if args.graph == "rrg"
                   else f"ER c={args.c:g}")
            + f", N={g.n}, R={args.replicas}, {args.rule}",
            save_path=args.plot)
    print(json.dumps(doc))
    return 0
