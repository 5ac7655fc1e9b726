"""CLI: ``python -m graphdyn_torch.obs <report|check|memcheck|trend> ...``,
the JAX package's ``python -m graphdyn.obs`` for the port.

- ``report LEDGER`` — render a JSONL event ledger as a span-tree/counter
  summary (``--format=text|json``).
- ``check`` — the roofline obscheck: the headline programs on the card (the
  H100's roof and bands), or with ``--device cpu`` the host proxy, against
  the byte-model bands (:mod:`graphdyn_torch.obs.roofline`); each row
  names its device and anchor. Exit code = out-of-band programs.
- ``memcheck`` — the device-memory bands
  (:mod:`graphdyn_torch.obs.memband`): each program's measured peak on the
  card against its byte model; with ``--device cpu`` every row is an
  explicit null + reason and the gate passes structurally. Exit code =
  out-of-band rows.

``check`` and ``memcheck`` run on the card (``--device cuda``, the default)
and fail on a host without one, or, for ``check``, on a card with no
committed profile.
- ``trend ROW.json`` — the cross-round rate gate
  (:mod:`graphdyn_torch.obs.trend`): diff a bench row against the latest
  comparable committed round; ``--bless`` commits the row's rates to
  ``OBS_TREND.json`` instead. Exit code = unblessed drift findings.

Output contract, the JAX package's: with ``--format=json`` stdout carries
exactly one JSON document; every diagnostic goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys


def _diag(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.obs",
        description="graphdyn_torch runtime-telemetry tools "
                    "(exit code = number of findings)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser("report", help="render a JSONL event ledger")
    rep.add_argument("ledger", help="path to the obs ledger (JSONL)")
    rep.add_argument("--format", choices=("text", "json"), default="text")

    chk = sub.add_parser(
        "check", help="roofline obscheck (the card's bands, or the host "
                      "proxy's with --device cpu)")
    chk.add_argument("--format", choices=("text", "json"), default="text")
    chk.add_argument("--device", choices=("cuda", "cpu"), default="cuda")

    mem = sub.add_parser(
        "memcheck", help="device-memory bands (byte models vs measured "
                         "peak; null+reason with --device cpu)")
    mem.add_argument("--format", choices=("text", "json"), default="text")
    mem.add_argument("--device", choices=("cuda", "cpu"), default="cuda")

    trd = sub.add_parser("trend", help="cross-round bench rate gate")
    trd.add_argument("row", help="bench row JSON file (one object)")
    trd.add_argument("--format", choices=("text", "json"), default="text")
    trd.add_argument("--bless", action="store_true",
                     help="commit this row's rates to OBS_TREND.json as "
                          "the deliberate baseline instead of diffing")
    trd.add_argument("--ledger", default=None,
                     help="trend-ledger path (default: repo-root "
                          "OBS_TREND.json)")
    args = ap.parse_args(argv)

    if args.cmd == "report":
        from graphdyn_torch.obs.report import load_summary, render_text

        doc = load_summary(args.ledger, diag=_diag)
        if args.format == "json":
            print(json.dumps(doc, indent=2, default=str))
        else:
            render_text(doc)
        return 0

    if args.cmd == "check":
        from graphdyn_torch.obs.roofline import run_obscheck

        rows = run_obscheck(diag=_diag, device=args.device)
        bad = [r for r in rows if not r.ok]
        if args.format == "json":
            print(json.dumps([r._asdict() | {"ok": r.ok} for r in rows],
                             indent=2))
        else:
            for r in rows:
                print(f"{r.program}: frac={r.frac:.3f} "
                      f"band=[{r.lo:g},{r.hi:g}] "
                      f"{'ok' if r.ok else 'OUT OF BAND'} "
                      f"({r.anchor}, {r.device})")
        if bad:
            _diag(f"obscheck: {len(bad)} program(s) out of band")
        else:
            _diag(f"obscheck: {len(rows)} program(s) within band")
        return min(len(bad), 125)

    if args.cmd == "memcheck":
        from graphdyn_torch.obs.memband import run_memcheck

        rows = run_memcheck(diag=_diag, device=args.device)
        bad = [r for r in rows if not r.ok]
        if args.format == "json":
            print(json.dumps([r._asdict() | {"ok": r.ok} for r in rows],
                             indent=2))
        else:
            for r in rows:
                if r.measured is None:
                    print(f"{r.program}: model={r.model:g}B measured=null "
                          f"({r.reason}) structural-pass")
                else:
                    print(f"{r.program}: frac={r.frac:.3f} "
                          f"band=[{r.lo:g},{r.hi:g}] "
                          f"{'ok' if r.ok else 'OUT OF BAND'}")
        if bad:
            _diag(f"memcheck: {len(bad)} row(s) out of band")
        else:
            _diag(f"memcheck: {len(rows)} row(s) ok")
        return min(len(bad), 125)

    # trend
    from graphdyn_torch.obs.trend import (
        check_trend, load_trend_ledger, write_trend_ledger,
    )

    with open(args.row) as fh:
        row = json.load(fh)
    if args.bless:
        path = write_trend_ledger(row, args.ledger)
        _diag(f"obs trend: blessed rates for backend={row.get('backend')} "
              f"metric={row.get('metric')} into {path}")
        if args.format == "json":
            print(json.dumps({"blessed": True, "ledger": path}))
        return 0
    ledger = load_trend_ledger(args.ledger) if args.ledger else None
    findings, status = check_trend(row, ledger=ledger, diag=_diag)
    if args.format == "json":
        print(json.dumps({
            "status": status,
            "findings": [f._asdict() for f in findings],
        }, indent=2))
    else:
        for f in findings:
            print(f"{f.row}: {f.code} {f.message}")
        print(f"trend: {status}")
    return min(len(findings), 125) if status == "drift" else 0


if __name__ == "__main__":
    sys.exit(main())
