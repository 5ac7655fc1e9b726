"""Cross-round bench **rate** trend gating, the port of the JAX package's
``graphdyn/obs/trend.py`` (pure dict logic; the port has no bench row
producer yet).

The new round's measured rows diff against the latest **comparable** committed
``BENCH_r*.json`` (same backend, same metric — a smoke row never compares
against a full-shape row, and a TPU or CPU round never against a ``gpu``
row: the committed TPU rounds are no baseline for the port), with per-row
tolerance bands. A silent runtime regression fails the gate with a pointed
message naming the row, the ratio, and the band.

Update path, mirroring the fingerprint ledger's: round artifacts are
immutable history, so a **deliberate** rate change (new kernel default,
changed shapes) is blessed by committing the new row's rates to
``OBS_TREND.json`` (``python -m graphdyn_torch.obs trend ROW.json --bless``) in
the reviewed PR; a drifted row matching the blessed ledger within band
passes (``trend_drift_blessed``), and the round-over-round baseline
refreshes when the next round persists its row.

Bands are intentionally loose (default: fail below ¼× or above 20× the
previous round) — container-load noise is real; the decade-scale absolute
anchor is :mod:`graphdyn_torch.obs.roofline`.
"""

from __future__ import annotations

import glob
import json
import os
from typing import NamedTuple

#: rate rows diffed round-over-round: name -> (lo_frac, hi_frac) of the
#: previous round's value. Rows absent from either round (or null — an
#: explicit backend skip) are not comparable and produce no finding.
TREND_ROWS: dict[str, tuple[float, float]] = {
    "value": (0.25, 20.0),
    "packed_rate_natural_order": (0.25, 20.0),
    "packed_rate_bfs_order": (0.25, 20.0),
    "packed_rate_wide": (0.25, 20.0),
    "packed_rate_pallas": (0.25, 20.0),
    "int8_rate": (0.25, 20.0),
    "ensemble_rate": (0.25, 20.0),
    "ensemble_rate_serial": (0.25, 20.0),
    "entropy_cell_rate": (0.25, 20.0),
    "powerlaw_rate": (0.25, 20.0),
    "torch_cpu_rate": (0.25, 20.0),
}

LEDGER_NAME = "OBS_TREND.json"


class TrendFinding(NamedTuple):
    row: str
    code: str           # OBS201 regression | OBS202 implausible jump
    message: str


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _rate(row: dict, name: str):
    v = row.get(name)
    return v if isinstance(v, (int, float)) and v > 0 else None


def comparable(prev_row: dict, new_row: dict) -> bool:
    """Rows compare only within one (backend, metric) class: the metric
    string carries the workload shape (``..._n100000`` smoke vs
    ``..._n1000000`` full), and rates are backend-specific."""
    return bool(
        prev_row and new_row
        and prev_row.get("backend") == new_row.get("backend")
        and prev_row.get("metric") == new_row.get("metric")
    )


def diff_bench_rates(prev_row: dict, new_row: dict) -> list[TrendFinding]:
    """Per-row tolerance diff between two comparable bench rows. An error
    round (``value`` 0/absent — the wedged-relay artifacts r01/r03/r04) is
    not a baseline; incomparable rows return no findings."""
    if not comparable(prev_row, new_row) or not _rate(prev_row, "value"):
        return []
    findings = []
    for name, (lo, hi) in sorted(TREND_ROWS.items()):
        prev, new = _rate(prev_row, name), _rate(new_row, name)
        if prev is None or new is None:
            continue
        ratio = new / prev
        if ratio < lo:
            findings.append(TrendFinding(
                name, "OBS201",
                f"rate regressed {1 / ratio:.2f}x vs the previous round "
                f"({prev:.3e} -> {new:.3e}; band floor {lo:g}x). If "
                f"deliberate, bless the new rates: python -m "
                f"graphdyn_torch.obs trend <row.json> --bless",
            ))
        elif ratio > hi:
            findings.append(TrendFinding(
                name, "OBS202",
                f"rate jumped {ratio:.2f}x vs the previous round "
                f"({prev:.3e} -> {new:.3e}; band ceiling {hi:g}x) — "
                f"implausible for an unchanged measurement; check the "
                f"timing fence / workload shape. If deliberate, bless "
                f"with --bless",
            ))
    return findings


def latest_comparable_round(new_row: dict, root: str | None = None,
                            pattern: str = "BENCH_r*.json"):
    """``(path, row)`` of the most recent committed round comparable to
    ``new_row`` (same backend + metric, non-error), or ``(None, None)``.
    A ``gpu`` row finds none among the TPU rounds (``BENCH_r*.json``)."""
    root = root or _repo_root()
    best = (None, None)
    for p in sorted(glob.glob(os.path.join(root, pattern))):
        try:
            with open(p) as fh:
                row = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        # round artifacts wrap the bench row under "parsed" (the capture
        # driver records cmd/rc/tail alongside); a bare row is accepted too
        if isinstance(row, dict) and isinstance(row.get("parsed"), dict):
            row = row["parsed"]
        if comparable(row, new_row) and _rate(row, "value"):
            best = (p, row)
    return best


def load_trend_ledger(path: str | None = None) -> dict | None:
    path = path or os.path.join(_repo_root(), LEDGER_NAME)
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def write_trend_ledger(row: dict, path: str | None = None) -> str:
    """Bless ``row``'s rates: commit them as the deliberate baseline. The
    ledger stores one entry per (backend, metric) class, so blessing a CPU
    smoke row never touches the chip row's baseline."""
    path = path or os.path.join(_repo_root(), LEDGER_NAME)
    ledger = load_trend_ledger(path) or {"classes": {}}
    key = f"{row.get('backend')}|{row.get('metric')}"
    ledger["classes"][key] = {
        "backend": row.get("backend"),
        "metric": row.get("metric"),
        "rates": {name: row[name] for name in TREND_ROWS
                  if _rate(row, name) is not None},
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ledger, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def trend_drift_blessed(new_row: dict, ledger: dict | None = None) -> bool:
    """Whether a row that drifted from the previous round matches the
    committed blessed baseline within band — i.e. the change was deliberate
    and reviewed."""
    ledger = ledger if ledger is not None else load_trend_ledger()
    if not ledger or not new_row:
        return False
    entry = ledger.get("classes", {}).get(
        f"{new_row.get('backend')}|{new_row.get('metric')}"
    )
    if not entry:
        return False
    synthetic_prev = {"backend": new_row.get("backend"),
                      "metric": new_row.get("metric"), **entry["rates"]}
    return not diff_bench_rates(synthetic_prev, new_row)


def check_trend(new_row: dict, root: str | None = None,
                ledger: dict | None = None, diag=None):
    """The full gate: find the latest comparable round, diff, consult the
    blessing ledger. Returns ``(findings, status)`` where ``status`` is one
    of ``no_baseline`` / ``stable`` / ``blessed`` / ``drift`` — callers
    (benchcheck) fail only on ``drift`` but must assert the gate RAN."""
    path, prev = latest_comparable_round(new_row, root)
    if prev is None:
        if diag:
            diag(
                "trend gate: no comparable committed round "
                f"(backend={new_row.get('backend')}, "
                f"metric={new_row.get('metric')}) — baseline starts when "
                "such a round persists"
            )
        return [], "no_baseline"
    findings = diff_bench_rates(prev, new_row)
    if not findings:
        if diag:
            diag(f"trend gate: rates stable vs {os.path.basename(path)}")
        return [], "stable"
    if trend_drift_blessed(new_row, ledger):
        if diag:
            diag(
                f"trend gate: rate drift vs {os.path.basename(path)} is "
                f"LEDGER-BLESSED (row matches the committed {LEDGER_NAME})"
            )
        return findings, "blessed"
    if diag:
        for f in findings:
            diag(f"trend gate: RATE DRIFT vs {os.path.basename(path)}: "
                 f"{f.row}: {f.code} {f.message}")
    return findings, "drift"
