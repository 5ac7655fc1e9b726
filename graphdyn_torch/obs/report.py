"""Ledger rendering: ``python -m graphdyn_torch.obs report LEDGER``, as the
JAX package's ``graphdyn/obs/report.py`` renders it.

Aggregates a JSONL event ledger (:mod:`graphdyn_torch.obs.recorder`, or the
JAX package's: one schema) into a span-tree / counter / gauge summary. Spans aggregate by their *name path*
(the chain of enclosing span names, e.g. ``run > pipeline.sa.chunk``), so a
span name reused under different parents reports separately; counters sum
``inc`` per name; gauges keep count/last/min/max/mean per name.

Output contract: ``--format=json`` prints exactly ONE JSON document
on stdout; every diagnostic (torn-line notices etc.) goes to stderr.
"""

from __future__ import annotations

import sys

from graphdyn_torch.obs.recorder import read_ledger


def summarize(events: list[dict]) -> dict:
    """The aggregate document: ``{"manifest", "spans", "counters",
    "gauges", "events"}`` (spans keyed by name path, parent-first)."""
    manifest = None
    by_id: dict[int, dict] = {}
    spans: dict[tuple, dict] = {}
    counters: dict[str, dict] = {}
    gauges: dict[str, dict] = {}

    span_events = [e for e in events if e.get("ev") == "span"]
    for e in span_events:
        if e.get("id") is not None:
            by_id[e["id"]] = e

    def path_of(e: dict) -> tuple:
        parts = [e.get("name", "?")]
        seen = set()
        parent = e.get("parent")
        while parent is not None and parent not in seen:
            seen.add(parent)
            pe = by_id.get(parent)
            if pe is None:
                break
            parts.append(pe.get("name", "?"))
            parent = pe.get("parent")
        return tuple(reversed(parts))

    for e in events:
        kind = e.get("ev")
        if kind == "manifest" and manifest is None:
            manifest = e.get("run", {})
        elif kind == "span":
            key = path_of(e)
            row = spans.setdefault(key, {
                "count": 0, "wall_s": 0.0, "cpu_s": 0.0, "max_wall_s": 0.0,
            })
            row["count"] += 1
            row["wall_s"] += float(e.get("wall_s", 0.0))
            row["cpu_s"] += float(e.get("cpu_s", 0.0))
            row["max_wall_s"] = max(row["max_wall_s"],
                                    float(e.get("wall_s", 0.0)))
        elif kind == "counter":
            row = counters.setdefault(e.get("name", "?"), {"total": 0,
                                                           "events": 0})
            row["total"] += int(e.get("inc", 1))
            row["events"] += 1
        elif kind == "gauge":
            v = e.get("value")
            row = gauges.setdefault(e.get("name", "?"), {
                "count": 0, "last": None, "min": None, "max": None,
                "sum": 0.0,
            })
            row["count"] += 1
            row["last"] = v
            if isinstance(v, (int, float)):
                row["min"] = v if row["min"] is None else min(row["min"], v)
                row["max"] = v if row["max"] is None else max(row["max"], v)
                row["sum"] += v
    for row in gauges.values():
        row["mean"] = (row["sum"] / row["count"]
                       if row["count"] and row["max"] is not None else None)
        del row["sum"]
    return {
        "manifest": manifest,
        "spans": {" > ".join(k): v
                  for k, v in sorted(spans.items())},
        "counters": counters,
        "gauges": gauges,
        "events": len(events),
    }


def render_text(doc: dict, out=sys.stdout) -> None:
    man = doc.get("manifest") or {}
    if man:
        ident = ", ".join(
            f"{k}={man[k]}" for k in
            ("cmd", "backend", "torch", "jax", "device_name",
             "power_limit", "git_sha") if man.get(k) is not None
        )
        print(f"manifest: {ident or man}", file=out)
    if doc["spans"]:
        print(f"spans ({doc['events']} events):", file=out)
        for path, row in doc["spans"].items():
            depth = path.count(" > ")
            name = path.rsplit(" > ", 1)[-1]
            print(
                f"  {'  ' * depth}{name:<32} n={row['count']:<6} "
                f"wall={row['wall_s']:.3f}s cpu={row['cpu_s']:.3f}s "
                f"max={row['max_wall_s']:.3f}s",
                file=out,
            )
    if doc["counters"]:
        print("counters:", file=out)
        for name, row in sorted(doc["counters"].items()):
            print(f"  {name:<34} total={row['total']} "
                  f"(events={row['events']})", file=out)
    if doc["gauges"]:
        print("gauges:", file=out)
        for name, row in sorted(doc["gauges"].items()):
            stats = (f"last={row['last']!r}" if row["max"] is None else
                     f"last={row['last']:.4g} min={row['min']:.4g} "
                     f"max={row['max']:.4g} mean={row['mean']:.4g}")
            print(f"  {name:<34} n={row['count']} {stats}", file=out)


def load_summary(path: str, diag=None) -> dict:
    """``summarize`` over a ledger file; torn-final-line notices go through
    ``diag`` (stderr in the CLI), never stdout."""
    events, torn = read_ledger(path)
    if torn and diag:
        diag(f"obs report: {path} ends in a torn line (process died "
             "mid-write) — ignored, the prefix is the ledger")
    doc = summarize(events)
    doc["torn_lines"] = torn
    return doc
