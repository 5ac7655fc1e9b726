"""``python -m graphdyn_torch.serve ROOT``: the standalone service process.

The thin wrapper: argparse, the graceful-shutdown scope (SIGTERM/SIGINT land
at chunk boundaries) and :func:`graphdyn_torch.serve.run_service`. The
full-featured entry point (telemetry, profiles) is ``python -m
graphdyn_torch serve run``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from graphdyn_torch.resilience.shutdown import graceful_shutdown
    from graphdyn_torch.serve.lifecycle import run_service

    p = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.serve",
        description="serve a durable job spool (exit 0 drained/idle, "
                    "75 preempted with the in-flight job requeued)")
    p.add_argument("root", help="spool directory (created if missing)")
    p.add_argument("--job-timeout", type=float, default=None, metavar="S",
                   help="default per-job deadline: overstaying jobs are "
                        "evicted and requeued with an escalated slice")
    p.add_argument("--max-jobs", type=int, default=None, metavar="N",
                   help="exit 0 after settling N jobs")
    p.add_argument("--idle-exit", type=float, default=None, metavar="S",
                   help="exit 0 after S seconds with an empty queue "
                        "(default: serve forever)")
    p.add_argument("--no-warm", action="store_true",
                   help="skip the boot-time warm-up of hot shape classes")
    p.add_argument("--device", default="cuda",
                   help="device to serve on (default cuda; 'cpu' runs the "
                        "plain versions on the CPU)")
    p.add_argument("--n-devices", type=int, default=None, metavar="P",
                   help="on the CPU: the gloo processes a sharded job may "
                        "span (default 1; on the card every card counts)")
    args = p.parse_args(argv)
    with graceful_shutdown():
        return run_service(
            args.root, job_timeout_s=args.job_timeout,
            max_jobs=args.max_jobs, idle_exit_s=args.idle_exit,
            warm=not args.no_warm, device=args.device,
            n_devices=args.n_devices)


if __name__ == "__main__":
    sys.exit(main())
