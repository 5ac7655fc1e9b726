"""Static byte-model admission: refuse an oversized job, never OOM (the port
of ``graphdyn/serve/admission.py``).

The serve worker is shared: one tenant's monster shape must not exhaust the
card every other tenant is using. Admission therefore happens BEFORE a job
reaches the device, from the byte models alone:

- :func:`graphdyn_torch.obs.memband.fused_model_bytes`, the JAX package's
  fused resident-set formula (``graphdyn/ops/pallas_anneal.py:225``,
  ``fused_vmem_bytes``), evaluated at a conservative static chromatic bound
  (``χ ≤ d² + 1``: a distance-2 greedy coloring of a degree-``d`` graph
  never needs more), prices ``solver='fused'`` jobs. No declaration of a
  fused job (``edges``, ``degree_cv``) discounts it: the fused tables are
  padded-``dmax``/χ-bound whatever the node labeling;
- :func:`graphdyn_torch.obs.memband.bucketed_job_bytes` prices
  ``solver='bucketed'`` jobs from their declared ``edges``: what the port's
  KB rollout holds at its peak (the job's words, their bucketed
  permutation, two ping-pong states, the permutations, the tables at the
  edge bound and KB's count workspace at its bound); the worker
  re-validates the declaration against the built graph's table before any
  device work (:class:`DeclaredShapeMismatch`);
- :func:`graphdyn_torch.obs.memband.streamed_state_bytes` prices
  ``solver='streamed'`` jobs per chunk at the smallest chunk count that fits
  the budget, per shard when the job declares ``shards``;
- the device budget (:func:`device_budget_bytes`):
  ``GRAPHDYN_SERVE_HBM_BUDGET`` when set, else on the card its own memory
  (``torch.cuda.mem_get_info``), else on the CPU the conservative
  :data:`DEFAULT_HBM_BUDGET`.

A refusal carries the model's numbers in its reason string (modeled bytes
vs budget), so "why was my job refused" is answerable from the job record
alone. Decisions, reasons and prices equal the JAX package's under the same
budget, with two differences:

- the JAX package labels a fused job whose formula exceeds its 10 MiB VMEM
  budget ``'xla'`` and runs it on its XLA twin. The port has no such twin
  and no such budget (K4′ works from global memory,
  :mod:`graphdyn_torch.ops.fused`), so it admits that job with
  ``kernel='auto'`` and runs it on K4′; the served result is the same
  chain;
- the JAX package prices a bucketed job at one resident copy of its words
  and tables (``bucketed_state_bytes``). The port's rollout holds about
  four copies of the words at its peak, and the card measured it at three
  times that price (``graphdyn_torch.analysis.graftcost``), so the port
  prices what it holds. Its price is higher, and so a bucketed job may be
  refused here under a budget the JAX package would admit it in.

The ``serve.admit`` fault site injects a **reject storm** (every decision
refuses, with an "injected" reason).
"""

from __future__ import annotations

import os
from typing import NamedTuple

from graphdyn_torch.resilience.faults import InjectedFault, maybe_fail

#: the budget on the CPU when ``GRAPHDYN_SERVE_HBM_BUDGET`` is not set:
#: deliberately conservative for a shared host
DEFAULT_HBM_BUDGET = 1 << 30

#: the environment variable that pins the budget (bytes) on any device
BUDGET_ENV = "GRAPHDYN_SERVE_HBM_BUDGET"


class AdmissionDecision(NamedTuple):
    admitted: bool
    kernel: str         # 'auto' (fused) | 'bucketed' | 'streamed' | ''
    reason: str | None  # refusal reason (None when admitted)
    model_bytes: int    # resident-set model of the engine that will run
    budget_bytes: int   # the device budget the model was held against


class DeclaredShapeMismatch(Exception):
    """A job's built graph needs more than its declaration admitted (edges,
    dmax, shards): the job was under-priced. Raised by the worker's
    pre-dispatch validation; the job is refused with this message, never
    dispatched."""


def chi_bound(d: int) -> int:
    """Static upper bound on the distance-2 chromatic number of a
    degree-``d`` graph (greedy: Δ(G²) + 1 ≤ d² + 1)."""
    return d * d + 1


def _device(device):
    """``device`` as a ``torch.device`` with its card's index (the current
    card's when none is given); None: the current card, else the CPU."""
    import torch

    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_budget_bytes(device=None) -> int:
    """The budget admitted jobs must fit: ``GRAPHDYN_SERVE_HBM_BUDGET`` when
    it holds a positive number, else the card's total memory on a CUDA
    ``device`` (default: the current card when there is one), else
    :data:`DEFAULT_HBM_BUDGET`. A failed read on the card raises: it is not
    turned into a budget."""
    env = os.environ.get(BUDGET_ENV, "").strip()
    if env:
        try:
            v = int(float(env))
            if v > 0:
                return v
        except ValueError:
            pass
    dev = _device(device)
    if dev.type == "cuda":
        import torch

        _, total = torch.cuda.mem_get_info(dev)
        return int(total)
    return DEFAULT_HBM_BUDGET


def device_count(device=None, n_devices: int | None = None) -> int:
    """The devices a sharded job may span: every card of the host on CUDA,
    ``n_devices`` (default 1) on the CPU, where each shard is a gloo
    process."""
    dev = _device(device)
    if dev.type == "cuda":
        import torch

        return torch.cuda.device_count()
    return 1 if n_devices is None else int(n_devices)


def admit(spec: dict, *, key: str = "", device=None,
          n_devices: int | None = None) -> AdmissionDecision:
    """One admission decision from the byte models: no build, no device
    allocation, and no exception escapes but a failed budget read on the
    card (a malformed spec is a refusal with a reason, not a worker crash).
    ``device`` / ``n_devices``: the worker's (:func:`device_budget_bytes`,
    :func:`device_count`)."""
    from graphdyn_torch.obs.memband import fused_model_bytes
    from graphdyn_torch.ops.packed import WORD

    budget = device_budget_bytes(device)
    try:
        maybe_fail("serve.admit", key=key)
    except InjectedFault as e:
        # the injected reject storm: admission stays up but refuses
        return AdmissionDecision(False, "", f"injected reject storm: {e}",
                                 0, budget)
    try:
        n, d, R = int(spec["n"]), int(spec["d"]), int(spec["replicas"])
        if n < 2 or d < 1 or d >= n or R < 1:
            return AdmissionDecision(
                False, "", f"malformed shape: n={n} d={d} replicas={R}",
                0, budget)
        solver = str(spec.get("solver", "fused"))
        if solver not in ("fused", "bucketed", "streamed"):
            return AdmissionDecision(
                False, "", f"unknown solver {spec.get('solver')!r} "
                "(this service runs the fused annealer, the bucketed "
                "rollout, and the streamed rollout)", 0, budget)
        W = -(-R // WORD)
        if solver == "streamed":
            return _admit_streamed(spec, n, R, W, budget, device, n_devices)
        if solver == "bucketed":
            return _admit_bucketed(spec, n, R, W, budget)
        model = fused_model_bytes(n, W, chi_bound(d), d)
    except (KeyError, TypeError, ValueError) as e:
        return AdmissionDecision(False, "", f"malformed spec: {e}", 0,
                                 budget)
    if model > budget:
        return AdmissionDecision(
            False, "",
            f"modeled resident set {model} B exceeds the device budget "
            f"{budget} B (n={n}, replicas={R}: refuse at admission, "
            "never OOM the shared worker)",
            model, budget)
    return AdmissionDecision(True, "auto", None, model, budget)


def _declared_edges(spec: dict, n: int, what: str, model: str,
                    budget: int):
    """The declared edge count, or the refusal for a missing or malformed
    one."""
    n_edges = spec.get("edges")
    if n_edges is None:
        return None, AdmissionDecision(
            False, "",
            f"{what} solver requires a declared edge count ('edges'): the "
            f"{model} byte model has no other static input", 0, budget)
    n_edges = int(n_edges)
    if n_edges < 0 or n_edges > n * (n - 1) // 2:
        return None, AdmissionDecision(
            False, "", f"malformed shape: edges={n_edges} (simple graph on "
            f"n={n} nodes)", 0, budget)
    return n_edges, None


def _admit_streamed(spec, n, R, W, budget, device, n_devices):
    """The out-of-core engine: two chunks resident at once, so the model
    prices the per-chunk working set at the smallest chunk count that fits
    (per shard: each of S shards owns ~n/S nodes and ~edges/S adjacency).
    The single-node floor stays global: a chunk must hold its widest row on
    one device."""
    from graphdyn_torch.obs.memband import (
        streamed_chunk_count,
        streamed_min_bytes,
        streamed_state_bytes,
    )

    n_edges, refusal = _declared_edges(spec, n, "streamed", "per-chunk",
                                       budget)
    if refusal is not None:
        return refusal
    dmax = int(spec.get("dmax", min(n - 1, n_edges)))
    if not 0 <= dmax <= n - 1:
        return AdmissionDecision(
            False, "", f"malformed shape: dmax={dmax} (simple graph on "
            f"n={n} nodes)", 0, budget)
    floor = 2 * streamed_min_bytes(dmax, W)
    if floor > budget:
        return AdmissionDecision(
            False, "",
            f"modeled streamed floor {floor} B (a single-node chunk holding "
            f"the declared dmax={dmax} hub, double-buffered) exceeds the "
            f"device budget {budget} B — no chunking can stream this shape",
            floor, budget)
    shards = spec.get("shards", 1)
    try:
        shards = int(shards)
    except (TypeError, ValueError):
        return AdmissionDecision(
            False, "", f"malformed shards declaration "
            f"{spec.get('shards')!r} (want an int >= 1)", 0, budget)
    if shards < 1:
        return AdmissionDecision(
            False, "", f"malformed shards declaration shards={shards} "
            "(want an int >= 1)", 0, budget)
    if shards > 1:
        n_dev = device_count(device, n_devices)
        if shards > n_dev:
            return AdmissionDecision(
                False, "", devices_reason(shards, n_dev), 0, budget)
    n_p = -(-n // shards)
    e_p = -(-n_edges // shards)
    chunks = streamed_chunk_count(n_p, W, e_p, budget)
    if chunks is None:
        worst = streamed_state_bytes(n_p, W, e_p, max(n_p, 1))
        return AdmissionDecision(
            False, "",
            f"modeled per-shard streamed resident set {worst} B at one-node "
            f"chunks still exceeds the device budget {budget} B (n={n}, "
            f"edges={n_edges}, replicas={R}, shards={shards})",
            worst, budget)
    model = streamed_state_bytes(n_p, W, e_p, chunks)
    return AdmissionDecision(True, "streamed", None, model, budget)


def _admit_bucketed(spec, n, R, W, budget):
    """The edge-proportional engine: the declared edges price what the
    rollout holds (the worker re-validates them against the built
    table)."""
    from graphdyn_torch.obs.memband import bucketed_job_bytes

    n_edges, refusal = _declared_edges(spec, n, "bucketed",
                                       "edge-proportional", budget)
    if refusal is not None:
        return refusal
    model = bucketed_job_bytes(n, W, n_edges)
    if model > budget:
        return AdmissionDecision(
            False, "",
            f"modeled bucketed resident set {model} B exceeds the device "
            f"budget {budget} B (n={n}, edges={n_edges}, replicas={R}: "
            "refuse at admission, never OOM the shared worker)",
            model, budget)
    return AdmissionDecision(True, "bucketed", None, model, budget)


def devices_reason(shards: int, n_dev: int) -> str:
    """The refusal of a job declaring more shards than the worker has
    devices (admission and the worker's re-validation say the same)."""
    return (f"declared shards={shards} but this worker has {n_dev} devices "
            "— the sharded streamed engine needs one device per shard")
