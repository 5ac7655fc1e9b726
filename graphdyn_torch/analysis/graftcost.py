"""graftcost — resident-peak models measured on the card, with a committed
ledger, and the port's hand byte models held to them (the port of
``graphdyn/analysis/graftcost.py``: the same affine fits, rule codes
GB101–GB104, ledger workflow, CLI shape and exit code).

The JAX package derives its cost models from compiled HLO. The port has no
compiled program to read, so its derived model is the one a shared card
cares about: the **resident peak** of a served job. For each job kind the
service runs — the fused job on K4′ (``fused_anneal``), the bucketed job
on KB (``bucketed_rollout``) and the streamed job (``streamed_rollout``)
— a job at each of 2–3 calibration sizes is served through the real
worker (:func:`graphdyn_torch.serve.lifecycle.run_service`, one job, a
fresh table cache), :attr:`CostEntrySpec.repeats` times. A serve's value
is the peak of the bytes its tensors request (the caching allocator's
``requested_bytes`` peak above its level before the job: the allocator's
own block reuse, which moved ``max_memory_allocated`` by up to 1 MB between
serves of one job, does not enter it). The entry's sample is the median of
its serves (a fused or bucketed job's serves are equal to the byte; a
streamed job's prefetch thread now and then stages one chunk more, which
moved one serve in about thirty by 4–17% on an H100), with every serve's
value kept (``repeats``) and the allocator's largest peak beside it
(``allocated_bytes``), which the admission prices are held above. The JAX
module's
affine model ``q(n) = a + b·n`` is least-squares fitted to the samples,
and the fits, samples and hand-model ratios go to the committed
``graphdyn_torch/analysis/cost_ledger.json``, stamped with the card's name
and power limit.

The hand models (:data:`HAND_MODELS`) are the byte formulas the port
stakes decisions on: the serve admission price of each job kind
(:func:`graphdyn_torch.serve.admission.admit`, which refuses what would not
fit) and the :mod:`graphdyn_torch.obs.memband` models whose measured peak
``memcheck`` holds inside :data:`~graphdyn_torch.obs.memband.MEM_BANDS`
(the bucketed state, the streamed chunks; the fused job's model is its
admission price). Each is a pure function of the job's spec, so tier-1
recomputes it on the CPU at the ledger's calibration shapes.

Rules (exit code = number of findings):

====== ====================================================================
GB101  a measured sample left the range of its ledger sample's serves,
       widened by :data:`SAMPLE_BAND` — the job's footprint changed
       without a blessing
GB102  a hand model's ratio to the derived peak moved from its blessed
       ratio beyond its tolerance; an admission price is BELOW the derived
       peak, the measured sample or the allocator's peak at a calibration
       shape (admission would admit a job that takes more than it paid for: the port's counterpart of the JAX package's
       GB102 gate on its admission prices); or a memband model's measured
       peak / model left its ``MEM_BANDS`` band
GB103  a job kind without a cost row (or no cost ledger at all)
GB104  a measured scaling exponent departs from the declared one by more
       than :data:`EXPONENT_TOL`, or the affine fit's relative residual
       exceeds the entry's tolerance
====== ====================================================================

CLI::

    python -m graphdyn_torch.analysis.graftcost [--format=text|json]
        [--device cpu|cuda] [--update-ledger] [--ledger PATH]
        [--entries a,b,...]

On the CPU (the default) it checks the committed ledger's fits, coverage
and hand models (no measurement); ``--device cuda`` measures on the card,
diffs the samples (GB101) and, with ``--update-ledger``, writes them.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Callable, NamedTuple

RULES = {
    "GB101": "measured resident peak drifted from the ledger beyond the band",
    "GB102": "hand model disagrees with the derived peak beyond tolerance, or an admission price is below it",
    "GB103": "job kind has no cost row",
    "GB104": "measured scaling exponent departs from the declared one",
}

LEDGER_NAME = "cost_ledger.json"

#: |measured − declared| exponent tolerance (GB104), the JAX package's
EXPONENT_TOL = 0.35
#: GB101's widening of a ledger sample's range: a re-measured sample (the
#: median of its serves) must lie within ``[min(repeats)·(1 − band),
#: max(repeats)·(1 + band)]`` of the ledger's serves. The range itself is
#: the spread the card showed; the band is what a footprint may move
#: without a blessing
SAMPLE_BAND = 0.05

#: the quantities fitted per entry
FIT_QUANTITIES = ("peak_bytes",)


class Finding(NamedTuple):
    entry: str
    code: str
    message: str


def default_ledger_path() -> Path:
    """The committed ledger, beside this module."""
    return Path(__file__).resolve().parent / LEDGER_NAME


# ---------------------------------------------------------------------------
# calibration specs + fits
# ---------------------------------------------------------------------------


class CostEntrySpec(NamedTuple):
    """Calibration plan for one job kind: the sizes the affine model is
    fitted at, a held-out size (predicted, never fitted), the declared
    scaling exponent per quantity (GB104), ``spec(n)``, the served job's
    spec at size ``n`` (without the edge and hub counts a power-law job
    declares: they come from its built graph), the fit's residual
    tolerance, and the serves of each sample (the sample is their
    median)."""

    points: tuple[int, ...]
    holdout: int
    declared: dict[str, float]
    spec: Callable[[int], dict]
    residual_tol: float = 0.12
    repeats: int = 3


def _fused_spec(n: int) -> dict:
    # config 1's settings (BASELINE.md:29) at size n: the serve shape the
    # admission price has been held to since the job service landed
    return {"n": n, "d": 3, "replicas": 32, "graph_seed": 0, "seed": 0,
            "max_sweeps": 256, "chunk_sweeps": 256}


def _bucketed_spec(n: int) -> dict:
    # the power-law bench family (bench.py:620-697) at size n, R = 1024
    return {"solver": "bucketed", "n": n, "d": 2, "gamma": 2.2,
            "graph_seed": 0, "seed": 0, "replicas": 1024, "max_sweeps": 2}


def _streamed_spec(n: int) -> dict:
    # the stream family (bench.py:stream_rate_row) at size n, R = 1024
    return {"solver": "streamed", "n": n, "d": 2, "gamma": 2.2,
            "graph_seed": 0, "seed": 0, "replicas": 1024, "max_sweeps": 1}


#: the streamed job's budget: this fraction of its resident model, so it
#: streams in several chunks (the serve group's pinned-budget shape)
STREAM_BUDGET_FRAC = 0.25

COST_ENTRIES: dict[str, CostEntrySpec] = {
    "fused_anneal": CostEntrySpec((5_000, 10_000, 20_000), 15_000,
                                  {"peak_bytes": 1.0}, _fused_spec),
    "bucketed_rollout": CostEntrySpec((8_192, 16_384, 32_768), 24_576,
                                      {"peak_bytes": 1.0}, _bucketed_spec,
                                      residual_tol=0.25),
    # five serves a streamed sample: its prefetch thread's staging varies,
    # and the median of five ignores a serve that staged one chunk more
    "streamed_rollout": CostEntrySpec((8_192, 16_384, 32_768), 24_576,
                                      {"peak_bytes": 1.0}, _streamed_spec,
                                      residual_tol=0.25, repeats=5),
}


def _fit_affine(xs, ys) -> tuple[float, float, float]:
    """Least-squares ``y = a + b·x`` over the calibration points →
    (intercept, slope, max relative residual)."""
    k = len(xs)
    sx, sy = sum(xs), sum(ys)
    sxx = sum(x * x for x in xs)
    sxy = sum(x * y for x, y in zip(xs, ys))
    den = k * sxx - sx * sx
    slope = (k * sxy - sx * sy) / den if den else 0.0
    intercept = (sy - slope * sx) / k
    residual = max(
        abs(intercept + slope * x - y) / max(abs(y), 1.0)
        for x, y in zip(xs, ys)
    )
    return intercept, slope, residual


def _scaling_exponent(xs, ys) -> float | None:
    """Measured log-log exponent between the first and last calibration
    point, or None when the quantity is zero at either end."""
    if ys[0] <= 0 or ys[-1] <= 0:
        return None
    return math.log(ys[-1] / ys[0]) / math.log(xs[-1] / xs[0])


def fit_models(spec: CostEntrySpec, samples: dict[str, dict]) -> dict:
    """Affine models for every :data:`FIT_QUANTITIES` member, from the
    entry's calibration samples."""
    xs = [float(n) for n in spec.points]
    models = {}
    for q in FIT_QUANTITIES:
        ys = [float(samples[str(n)][q]) for n in spec.points]
        intercept, slope, residual = _fit_affine(xs, ys)
        models[q] = {
            "intercept": intercept,
            "slope": slope,
            "residual": residual,
            "exponent": _scaling_exponent(xs, ys),
            "declared_exponent": spec.declared.get(q),
        }
    return models


def predict(model: dict, n: float) -> float:
    """Evaluate one fitted model at size ``n``."""
    return float(model["intercept"] + model["slope"] * n)


# ---------------------------------------------------------------------------
# hand models (GB102)
# ---------------------------------------------------------------------------


class HandModel(NamedTuple):
    """One hand-written byte model: where it lives, the job kind it prices,
    a formula note, and ``hand(job) -> bytes`` from the served job's spec
    (with its built graph's ``edges``/``dmax`` and, for a streamed job, the
    pinned ``budget``). ``admission``: an admission price, which must never
    be below the derived peak; ``band``: the ``MEM_BANDS`` key whose
    (lo, hi) must hold the measured peak / model."""

    name: str
    module: str
    entry: str
    formula: str
    hand: Callable[[dict], float]
    admission: bool = False
    band: str | None = None
    tolerance: float = 0.05


def _W(job: dict) -> int:
    return -(-int(job["replicas"]) // 32)


def _admission_price(job: dict) -> float:
    """What :func:`~graphdyn_torch.serve.admission.admit` prices the job at
    under the job's pinned budget (a large one when none is pinned)."""
    import os

    from graphdyn_torch.serve import admission

    spec = {k: v for k, v in job.items() if k != "budget"}
    prev = os.environ.get(admission.BUDGET_ENV)
    os.environ[admission.BUDGET_ENV] = str(job.get("budget", 1 << 40))
    try:
        dec = admission.admit(spec, device="cpu")
    finally:
        if prev is None:
            del os.environ[admission.BUDGET_ENV]
        else:
            os.environ[admission.BUDGET_ENV] = prev
    if not dec.admitted:
        raise ValueError(f"calibration job refused: {dec.reason}")
    return float(dec.model_bytes)


def _bucketed_band(job: dict) -> float:
    from graphdyn_torch.obs import memband

    n = int(job["n"])
    return float(memband.bucketed_state_bytes(
        n, _W(job), memband.bucketed_table_entries_bound(n,
                                                         int(job["edges"]))))


def _streamed_band(job: dict) -> float:
    from graphdyn_torch.obs import memband

    n, W, e = int(job["n"]), _W(job), int(job["edges"])
    return float(memband.streamed_state_bytes(
        n, W, e, memband.streamed_chunk_count(n, W, e, int(job["budget"]))))


HAND_MODELS: tuple[HandModel, ...] = (
    HandModel("serve_fused_price", "serve/admission.py", "fused_anneal",
              "admit(): obs.memband.fused_model_bytes at chi <= d^2 + 1",
              _admission_price, admission=True),
    HandModel("serve_bucketed_price", "serve/admission.py",
              "bucketed_rollout",
              "admit(): obs.memband.bucketed_job_bytes: the words, their "
              "bucketed permutation, two ping-pong states, the int64 "
              "permutations, the tables at the declared edges' bound and "
              "KB's workspace bound", _admission_price, admission=True),
    HandModel("memband_bucketed", "obs/memband.py", "bucketed_rollout",
              "4nW + 4 table_entries + 4n", _bucketed_band,
              band="bucketed_state"),
    HandModel("serve_streamed_price", "serve/admission.py",
              "streamed_rollout",
              "admit(): obs.memband.streamed_state_bytes at the smallest "
              "chunk count that fits the budget", _admission_price,
              admission=True),
    HandModel("memband_streamed", "obs/memband.py", "streamed_rollout",
              "2 streamed_chunk_bytes(C, C + e_c, 1, W) + 4e_c - 4C",
              _streamed_band, band="streamed_chunk"),
)


def _held_bytes(sample: dict) -> int:
    """What the card held for a sample at its peak: the largest of its
    serves' requested peaks and the allocator's (whose blocks round the
    requests up)."""
    return max([int(sample["peak_bytes"]), int(sample.get(
        "allocated_bytes", 0))] + [int(x) for x in sample.get("repeats", [])])


def hand_model_rows(entries: dict) -> dict:
    """Per hand model, at each calibration point of its entry: the hand
    bytes, the ratio to the derived peak and the margin ``hand/held − 1``
    over what the card held (:func:`_held_bytes`)."""
    out = {}
    for hm in HAND_MODELS:
        row = entries.get(hm.entry)
        if not row or "models" not in row:
            continue
        model = row["models"]["peak_bytes"]
        ratios, margins, hands = {}, {}, {}
        for n in COST_ENTRIES[hm.entry].points:
            job = row["samples"][str(n)]["job"]
            h = hm.hand(job)
            p = predict(model, n)
            hands[str(n)] = h
            ratios[str(n)] = (h / p) if p > 0 else None
            margins[str(n)] = h / _held_bytes(row["samples"][str(n)]) - 1.0
        out[hm.name] = {"entry": hm.entry, "module": hm.module,
                        "formula": hm.formula, "tolerance": hm.tolerance,
                        "admission": hm.admission, "band": hm.band,
                        "hand_bytes": hands, "ratios": ratios,
                        "margins": margins}
    return out


def check_hand_models(ledger: dict, *, diag=None) -> list[Finding]:
    """GB102: every hand model, recomputed now from the ledger's jobs, must
    reproduce its blessed ratio to the derived peak within its tolerance,
    and no admission price may fall below the derived peak (nor below what
    the card held, :func:`_held_bytes`) at a calibration shape, and no
    memband model's
    measured peak / model may leave its ``MEM_BANDS`` band."""
    from graphdyn_torch.obs.memband import MEM_BANDS

    findings = []
    blessed_all = ledger.get("hand_models", {})
    entries = ledger.get("entries", {})
    for hm in HAND_MODELS:
        row = entries.get(hm.entry)
        if not row or "models" not in row:
            if diag:
                diag(f"graftcost: {hm.name}: no cost row for {hm.entry} — "
                     f"GB103 covers the gap")
            continue
        blessed = blessed_all.get(hm.name)
        if blessed is None:
            findings.append(Finding(
                hm.entry, "GB102",
                f"hand model {hm.name!r} ({hm.module}) is registered but "
                f"not blessed in {LEDGER_NAME} — run --update-ledger"))
            continue
        tol = float(blessed.get("tolerance", hm.tolerance))
        model = row["models"]["peak_bytes"]
        for n in COST_ENTRIES[hm.entry].points:
            sample = row["samples"][str(n)]
            h = hm.hand(sample["job"])
            p = predict(model, n)
            want = blessed["ratios"].get(str(n))
            if p > 0 and want is not None:
                got = h / p
                if abs(got - want) / max(abs(want), 1e-9) > tol:
                    findings.append(Finding(
                        hm.entry, "GB102",
                        f"hand model {hm.name!r} ({hm.module}) drifted from "
                        f"the derived peak at n={n}: hand {h:.6g} B / "
                        f"derived {p:.6g} B = {got:.4f}, blessed {want:.4f} "
                        f"(tol ±{tol:.0%})"))
            if hm.band is not None:
                lo, hi = MEM_BANDS[hm.band]
                frac = sample["peak_bytes"] / h
                if not lo <= frac <= hi:
                    findings.append(Finding(
                        hm.entry, "GB102",
                        f"{hm.name!r}: measured peak / model = {frac:.3f} "
                        f"at n={n}, outside the {hm.band!r} band "
                        f"[{lo}, {hi}]"))
            if hm.admission and (h < p or h < _held_bytes(sample)):
                findings.append(Finding(
                    hm.entry, "GB102",
                    f"admission price {hm.name!r} is BELOW what the job "
                    f"takes at n={n}: price {h:.6g} B, derived peak "
                    f"{p:.6g} B, held {_held_bytes(sample)} B — "
                    f"admission would admit a job that can run the shared "
                    f"card out of memory"))
    return findings


def check_exponents(entry: str, spec: CostEntrySpec,
                    row: dict) -> list[Finding]:
    """GB104 on one ledger row's fitted models."""
    findings = []
    for q, model in row.get("models", {}).items():
        exp, want = model.get("exponent"), spec.declared.get(q)
        if exp is not None and want is not None \
                and abs(exp - want) > EXPONENT_TOL:
            findings.append(Finding(
                entry, "GB104",
                f"{q}: measured scaling exponent {exp:.3f} departs from the "
                f"declared {want} by more than ±{EXPONENT_TOL}"))
        if model.get("residual", 0.0) > spec.residual_tol:
            findings.append(Finding(
                entry, "GB104",
                f"{q}: affine fit residual {model['residual']:.3f} exceeds "
                f"{spec.residual_tol} — q(n) = a + b·n no longer describes "
                f"the job"))
    return findings


def check_coverage(ledger: dict | None) -> list[Finding]:
    """GB103: every job kind has a cost row."""
    if ledger is None:
        return [Finding(name, "GB103",
                        f"no cost ledger ({LEDGER_NAME}) — measure on the "
                        f"card with --device cuda --update-ledger")
                for name in sorted(COST_ENTRIES)]
    return [Finding(name, "GB103", f"job kind {name!r} has no cost row")
            for name in sorted(COST_ENTRIES)
            if "models" not in ledger.get("entries", {}).get(name, {})]


def check_ledger(ledger: dict | None, *, diag=None) -> list[Finding]:
    """The checks that need no card: coverage, the fits' exponents and
    residuals, and the hand models recomputed at the ledger's shapes."""
    findings = check_coverage(ledger)
    if ledger is None:
        return findings
    for name, spec in COST_ENTRIES.items():
        row = ledger.get("entries", {}).get(name)
        if row and "models" in row:
            refit = fit_models(spec, row["samples"])
            if refit != row["models"]:
                findings.append(Finding(
                    name, "GB104",
                    "the ledger's fit does not reproduce from its samples "
                    "— re-run --update-ledger"))
            findings += check_exponents(name, spec, row)
    return findings + check_hand_models(ledger, diag=diag)


def sample_range(sample: dict) -> tuple[float, float]:
    """GB101's range of one ledger sample: its serves' least and largest
    peaks (its peak alone when it records no serves), widened by
    :data:`SAMPLE_BAND`."""
    reps = sample.get("repeats") or [sample["peak_bytes"]]
    return min(reps) * (1 - SAMPLE_BAND), max(reps) * (1 + SAMPLE_BAND)


def diff_samples(ledger: dict | None, live: dict) -> list[Finding]:
    """GB101: every live sample (the median of its serves) against its
    ledger sample's range (:func:`sample_range`)."""
    findings = []
    entries = (ledger or {}).get("entries", {})
    for name, samples in sorted(live.items()):
        row = entries.get(name)
        if row is None:
            continue
        for n, s in samples.items():
            want = row["samples"].get(n)
            if want is None:
                continue
            lo, hi = sample_range(want)
            if not lo <= s["peak_bytes"] <= hi:
                findings.append(Finding(
                    name, "GB101",
                    f"n={n}: resident peak {s['peak_bytes']} B (serves "
                    f"{s.get('repeats')}) outside the ledger's range "
                    f"[{lo:.0f}, {hi:.0f}] B (its serves "
                    f"{want.get('repeats') or [want['peak_bytes']]} B, "
                    f"±{SAMPLE_BAND:.0%})"))
    return findings


# ---------------------------------------------------------------------------
# measurement on the card
# ---------------------------------------------------------------------------


_HOST_TABLES: dict = {}


def _host_tables(spec: dict) -> tuple:
    """``(graph, tables)`` the serve cache would build for ``spec``, built
    once per graph identity here: they are host arrays, and the job's peak
    counts what reaches the card from them, not their build."""
    from graphdyn_torch.serve.bucketing import BucketCache, graph_key
    from graphdyn_torch.serve.spool import SPEC_DEFAULTS

    full = {**SPEC_DEFAULTS, **spec}
    key = graph_key(full)
    if key not in _HOST_TABLES:
        _HOST_TABLES[key] = BucketCache()._build(full)
    return key, _HOST_TABLES[key]


def calibration_job(entry: str, n: int) -> dict:
    """The served job's spec at size ``n``, with the edge and hub counts of
    its built graph and a streamed job's pinned budget."""
    from graphdyn_torch.obs import memband

    job = COST_ENTRIES[entry].spec(n)
    if entry != "fused_anneal":
        g = _host_tables(job)[1][0]
        job.update(edges=int(g.num_edges), dmax=int(g.dmax))
    if entry == "streamed_rollout":
        full = memband.streamed_state_bytes(n, _W(job), job["edges"], 1)
        job["budget"] = int(STREAM_BUDGET_FRAC * full)
    return job


def _serve_once(spec: dict, cache, device) -> tuple[int, int]:
    """One serve of ``spec`` through the real worker on a spool of its own
    (no device layout cached from an earlier serve): the peaks above the
    levels before it of the bytes requested and of the allocator's
    blocks."""
    import gc
    import os
    import tempfile

    import torch

    from graphdyn_torch.ops import bucketed
    from graphdyn_torch.serve.lifecycle import run_service
    from graphdyn_torch.serve.spool import Spool

    req = "requested_bytes.all.current"
    with tempfile.TemporaryDirectory() as tmp:
        sp = Spool(os.path.join(tmp, "spool"))
        jid = sp.submit(spec, "graftcost")
        # the job's own tables count in its peak: none left from before
        with bucketed._layouts_lock:
            bucketed._DEVICE_LAYOUTS.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_req = torch.cuda.memory_stats()[req]
        base = torch.cuda.memory_allocated()
        rc = run_service(sp.root, max_jobs=1, warm=False, device=device,
                         cache=cache)
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        peaks = (int(stats["requested_bytes.all.peak"] - base_req),
                 int(torch.cuda.max_memory_allocated() - base))
        rec = {r["id"]: r for r in sp.jobs()}[jid]
    if rc != 0 or rec["state"] != "done":
        raise RuntimeError(f"calibration job {spec} ended {rec['state']!r} "
                           f"(rc {rc}): {rec.get('reason')}")
    return peaks


def measure_peak(job: dict, device="cuda", repeats: int = 1) -> dict:
    """Serve ``job`` ``repeats`` times through the real worker (a table
    cache holding only its host tables) and return its sample: the median
    requested-bytes peak (``peak_bytes``, a serve's own value), every
    serve's (``repeats``) and the allocator's largest
    (``allocated_bytes``)."""
    import os
    import statistics

    from graphdyn_torch.serve import admission
    from graphdyn_torch.serve.bucketing import BucketCache

    spec = {k: v for k, v in job.items() if k != "budget"}
    cache = BucketCache()
    key, pair = _host_tables(spec)
    cache._graphs[key] = pair
    prev = os.environ.get(admission.BUDGET_ENV)
    if "budget" in job:
        os.environ[admission.BUDGET_ENV] = str(job["budget"])
    try:
        peaks = [_serve_once(spec, cache, device) for _ in range(repeats)]
    finally:
        if prev is None:
            os.environ.pop(admission.BUDGET_ENV, None)
        else:
            os.environ[admission.BUDGET_ENV] = prev
    reqs = [p[0] for p in peaks]
    return {"peak_bytes": statistics.median_low(reqs), "repeats": reqs,
            "allocated_bytes": max(p[1] for p in peaks), "job": job}


def collect_samples(entries=None, *, device="cuda", diag=None) -> dict:
    out = {}
    for name in entries or sorted(COST_ENTRIES):
        samples = {}
        for n in COST_ENTRIES[name].points:
            if diag:
                diag(f"graftcost: {name} at n={n}")
            samples[str(n)] = measure_peak(calibration_job(name, n), device,
                                           COST_ENTRIES[name].repeats)
        out[name] = samples
    return out


def card_stamp() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    import subprocess

    try:
        txt = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return {"name": None, "power_limit": None}
    name, _, limit = txt.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def build_ledger(live: dict) -> dict:
    import torch

    entries = {name: {"feature": "n",
                      "points": list(COST_ENTRIES[name].points),
                      "holdout": COST_ENTRIES[name].holdout,
                      "samples": samples,
                      "models": fit_models(COST_ENTRIES[name], samples)}
               for name, samples in live.items()}
    return {"version": 1, "device": card_stamp(),
            "torch": torch.__version__.split("+")[0],
            "entries": entries, "hand_models": hand_model_rows(entries)}


def load_ledger(path: Path | str | None = None) -> dict | None:
    p = Path(path) if path else default_ledger_path()
    if not p.exists():
        return None
    with open(p) as fh:
        return json.load(fh)


def write_ledger(doc: dict, path: Path | str | None = None) -> Path:
    from graphdyn_torch.utils.io import write_json_atomic

    p = Path(path) if path else default_ledger_path()
    write_json_atomic(str(p), doc, indent=2, sort_keys=True)
    return p


def _diag(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.analysis.graftcost",
        description="graftcost: resident-peak models of the served jobs and "
                    "the hand byte models held to them (exit code = number "
                    "of findings)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--ledger", default=None)
    ap.add_argument("--entries", default=None)
    ap.add_argument("--device", default="cpu",
                    help="cpu: check the committed ledger; cuda: measure")
    ap.add_argument("--update-ledger", action="store_true")
    args = ap.parse_args(argv)

    ledger = load_ledger(args.ledger)
    live = None
    findings: list[Finding] = []
    if args.device.startswith("cuda"):
        entries = args.entries.split(",") if args.entries else None
        live = collect_samples(entries, device=args.device, diag=_diag)
        if args.update_ledger:
            ledger = build_ledger(live)
            _diag(f"graftcost: wrote {write_ledger(ledger, args.ledger)}")
        else:
            findings += diff_samples(ledger, live)
    elif args.update_ledger:
        ap.error("--update-ledger measures on the card: pass --device cuda")
    findings += check_ledger(ledger, diag=_diag)
    if args.format == "json":
        print(json.dumps({"findings": [f._asdict() for f in findings],
                          "samples": live,
                          "hand_models": (ledger or {}).get("hand_models")},
                         indent=2))
    else:
        for f in findings:
            print(f"{f.entry}: {f.code} {f.message}")
    if findings:
        _diag(f"graftcost: {len(findings)} finding(s)")
    return min(len(findings), 125)


if __name__ == "__main__":
    sys.exit(main())
