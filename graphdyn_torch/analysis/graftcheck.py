"""graftcheck — dispatch fingerprints of the port's entry points against a
committed ledger (the port of ``graphdyn/analysis/graftcheck.py``: the same
entry names, rule codes GC001–GC004 and GC100–GC106, CLI shape and exit
code).

XLA HLO has no PyTorch counterpart, so the port fingerprints what each
headline entry point *dispatches*: one chunk at a small canonical shape
runs under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
that sees every ATen op, and the fingerprint keeps

- ``op_categories``: counts of ATen op categories — elementwise, gather
  (index/index_select/gather), scatter (index_put/scatter/index_copy),
  reduce, matmul, layout (views, cat, clone, ...), ``copy_h2d``,
  ``copy_d2h``, ``host_sync`` (``_local_scalar_dense``, ``item``,
  ``nonzero``: a read the host waits on), ``alloc`` (empty/zeros/full),
  other;
- ``op_total``: the number of dispatched ops;
- ``f64_ops``: ops that produce float64 from inputs of at most 32 bits
  (an entry whose float64 is by design, such as the SA chains' accept
  probability ``exp(-ΔH)`` rounded from float64, names why in its spec;
  its count is then held to the ledger's);
- ``largest_host_const_bytes``: the largest host array copied to the
  card (or lifted into a tensor) during the chunk;
- ``state_in_place``: whether the chunk's state tensor keeps its
  ``data_ptr`` (the in-place contract, the counterpart of donation);
- ``launches``: the hand-kernel launches, read from the ``*_cuda.LAUNCHES``
  counters (a ctypes launch is invisible to a dispatch mode; on the CPU
  the plain versions run and every count is 0).

Rules on a live fingerprint (no ledger needed):

- **GC001** the entry declares the in-place state contract and the chunk
  returned a state at a new address;
- **GC002** a float64 op in a chunk whose inputs are at most 32-bit;
- **GC003** a host constant above 1 MiB copied to the card on every call;
- **GC004** the recompile guard, counted as the port's counterparts of a
  compile: kernel library builds (the ``kernel.build`` counter) and
  CUDA-graph captures per entry point across a run
  (:class:`RecompileWatch`, :func:`check_recompiles`).

Ledger bands (``graphdyn_torch/analysis/fingerprints.json``, one row per
platform, ``cpu`` checked by tier-1 and ``cuda`` by ``chip_smoke.py``):

====================  =====================================================
field                 band
====================  =====================================================
op_categories         a category present live but absent from the ledger
                      fails (GC101); a count drift beyond max(4, 50% of the
                      ledger's) fails (GC102)
op_total              drift beyond max(2, 25% of the ledger's) fails
                      (GC103, the counterpart of the fusion count)
state_in_place        the ledger's True must stay True (GC104)
largest_host_const    live > max(4× ledger, 1 MiB) fails (GC105)
launches              any change fails (GC106, the counterpart of the
                      while-loop count: one launch per step or chunk is the
                      kernels' contract)
====================  =====================================================

A dispatch mode sees no op inside a CUDA-graph replay: an entry whose
driver replays a captured chunk is fingerprinted on the chunk function
itself (what the capture records). The process-group entries
(``sharded_rollout``, ``halo_rollout``, ``streamed_halo``) need a group of
ranks; a single process records them as ``{"unsupported": reason}``, as
the JAX package records an entry its devices cannot build.

CLI (exit code = number of findings)::

    python -m graphdyn_torch.analysis.graftcheck [--format=text|json]
        [--update-ledger] [--ledger PATH] [--entries a,b,...]
        [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, NamedTuple

RULES = {
    "GC001": "in-place state contract declared but the chunk moved the state",
    "GC002": "float64 op in a chunk whose inputs are at most 32-bit",
    "GC003": "large host constant copied to the card on every call",
    "GC004": "kernel-build / CUDA-graph-capture budget exceeded (recompile guard)",
    "GC100": "entry point missing from the fingerprint ledger",
    "GC101": "new ATen op category vs the ledger",
    "GC102": "ATen op-category count drift beyond the tolerance band",
    "GC103": "dispatched-op total jump beyond the tolerance band",
    "GC104": "in-place state lost vs the ledger",
    "GC105": "host-constant size blowup vs the ledger",
    "GC106": "hand-kernel launch count change vs the ledger",
}

#: live-rule threshold: host constants above this are GC003 findings
LARGE_CONSTANT_BYTES = 1 << 20

LEDGER_NAME = "fingerprints.json"

#: the port's hand-kernel launch counters: module -> counter names
LAUNCH_COUNTERS = {
    "packed_cuda": ("LAUNCHES", "SHARD_LAUNCHES"),
    "fused_cuda": ("LAUNCHES",),
    "bucketed_cuda": ("LAUNCHES",),
    "bdcm_sweep": ("LAUNCHES",),
    "bdcm_cuda": ("LAUNCHES",),
    "gather_cuda": ("LAUNCHES",),
}


def default_ledger_path() -> Path:
    """The committed ledger, beside this module."""
    return Path(__file__).resolve().parent / LEDGER_NAME


class Finding(NamedTuple):
    entry: str
    code: str
    message: str


class UnsupportedEntry(RuntimeError):
    """An entry point this process cannot run (a process-group entry in a
    one-process run): recorded as ``{"unsupported": reason}`` and skipped
    with a notice by every consumer, never read as drift."""


# ---------------------------------------------------------------------------
# op categories
# ---------------------------------------------------------------------------

_GATHER = {"index", "index_select", "gather", "take", "embedding",
           "masked_select"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "index_copy",
            "index_copy_", "index_add", "index_add_", "scatter_reduce",
            "scatter_reduce_", "masked_scatter", "masked_scatter_",
            "index_fill", "index_fill_"}
_REDUCE = {"sum", "amax", "amin", "max", "min", "any", "all", "mean", "prod",
           "cumsum", "cumprod", "argmax", "argmin", "count_nonzero",
           "logsumexp", "norm", "linalg_vector_norm", "bincount", "sort",
           "topk", "unique", "_unique2", "aminmax", "var", "std"}
_MATMUL = {"mm", "bmm", "matmul", "addmm", "baddbmm", "dot", "einsum",
           "mv", "addmv", "linear"}
_ALLOC = {"empty", "empty_like", "empty_strided", "zeros", "zeros_like",
          "ones", "ones_like", "full", "full_like", "new_empty",
          "new_empty_strided", "new_zeros", "new_ones", "new_full", "arange",
          "scalar_tensor", "randperm"}
_LAYOUT = {"view", "_unsafe_view", "reshape", "permute", "transpose", "t",
           "expand", "squeeze", "unsqueeze", "slice", "select", "cat",
           "stack", "clone", "contiguous", "split", "split_with_sizes",
           "unbind", "narrow", "flip", "roll", "repeat", "alias",
           "as_strided", "detach", "lift_fresh", "_reshape_alias",
           "diagonal", "unfold", "chunk", "tile", "movedim", "flatten",
           "view_as", "expand_as", "fill_", "zero_", "fill", "_to_copy",
           "copy_", "to", "lift_fresh_copy", "index_put_view"}
_SYNC = {"_local_scalar_dense", "item", "nonzero", "is_nonzero",
         "equal", "allclose", "_assert_async"}


def _category(name: str) -> str:
    base = name.rstrip("_") if name not in _SCATTER else name
    if name in _SYNC:
        return "host_sync"
    if name in _GATHER or base in _GATHER:
        return "gather"
    if name in _SCATTER:
        return "scatter"
    if name in _REDUCE or base in _REDUCE:
        return "reduce"
    if name in _MATMUL:
        return "matmul"
    if name in _ALLOC:
        return "alloc"
    if name in _LAYOUT or base in _LAYOUT:
        return "layout"
    return "elementwise"


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _launch_counts() -> dict[str, int]:
    import importlib

    out = {}
    for mod, names in LAUNCH_COUNTERS.items():
        m = importlib.import_module(f"graphdyn_torch.ops.{mod}")
        for n in names:
            out[f"{mod}.{n}"] = int(getattr(m, n))
    return out


class _Recorder:
    """Counts what a chunk dispatches (a TorchDispatchMode, built lazily so
    importing this module imports no torch internals)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self
        self.cats: dict[str, int] = {}
        self.total = 0
        self.f64 = 0
        self.const = 0
        self.names: dict[str, int] = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                rec._note(func, args, kwargs or {}, out)
                return out

        self.mode = Mode()

    def _note(self, func, args, kwargs, out) -> None:
        import torch

        name = func.overloadpacket.__name__
        cat = _category(name)
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        if name in ("_to_copy", "copy_") and ins:
            src = ins[1] if name == "copy_" and len(ins) > 1 else ins[0]
            dst = outs[0] if outs else None
            if dst is not None and src.device.type != dst.device.type:
                cat = ("copy_h2d" if src.device.type == "cpu"
                       else "copy_d2h")
                if cat == "copy_h2d":
                    self.const = max(self.const,
                                     # graftlint: disable-next-line=GD016  the size of a copy this chunk actually made (a measurement, not a model)
                                     src.numel() * src.element_size())
        if name == "lift_fresh" and outs:
            self.const = max(self.const,
                             # graftlint: disable-next-line=GD016  the size of a tensor this chunk actually lifted (a measurement)
                             outs[0].numel() * outs[0].element_size())
        if any(t.dtype == torch.float64 for t in outs) and not any(
                t.dtype == torch.float64 for t in ins):
            self.f64 += 1
        self.cats[cat] = self.cats.get(cat, 0) + 1
        self.names[name] = self.names.get(name, 0) + 1
        self.total += 1


class Chunk(NamedTuple):
    """One canonical chunk: ``run()`` executes it and returns its output,
    ``state`` is the state tensor it advances (None when the entry has no
    in-place contract) and ``state_of(out)`` the state after the chunk."""

    run: Callable
    state: object = None
    state_of: Callable | None = None


def fingerprint_chunk(chunk: Chunk) -> dict:
    """Run one chunk under the dispatch recorder and return its
    fingerprint."""
    import torch

    rec = _Recorder()
    before = _launch_counts()
    ptr = chunk.state.data_ptr() if chunk.state is not None else None
    with rec.mode:
        out = chunk.run()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    after = _launch_counts()
    fp = {
        "op_categories": dict(sorted(rec.cats.items())),
        "op_total": rec.total,
        "f64_ops": rec.f64,
        "largest_host_const_bytes": rec.const,
        "launches": {k: after[k] - before[k] for k in sorted(after)
                     if after[k] != before[k]},
        "opcode_counts": dict(sorted(rec.names.items())),
    }
    if ptr is not None:
        fp["state_in_place"] = bool(
            chunk.state_of(out).data_ptr() == ptr)
    return fp


# ---------------------------------------------------------------------------
# the entry points (the JAX package's names and canonical shapes)
# ---------------------------------------------------------------------------


class EntrySpec(NamedTuple):
    """One fingerprinted entry point: a builder ``build(device) -> Chunk``,
    whether it declares the in-place state contract (GC001), a note on the
    canonical shape, and why its float64 ops are by design (None: GC002
    applies)."""

    build: Callable[..., Chunk]
    in_place: bool
    canon: str
    f64_reason: str | None = None


def _canon_rrg(n: int, d: int, seed: int):
    from graphdyn_torch.graphs import random_regular_graph

    return random_regular_graph(n, d, seed=seed)


def _build_packed_rollout(device, steps: int = 4, n: int = 256,
                          R: int = 128) -> Chunk:
    import numpy as np
    import torch

    from graphdyn_torch.ops.packed import pack_spins, packed_rollout

    g = _canon_rrg(n, 3, 0)
    rng = np.random.default_rng(0)
    s = (2 * rng.integers(0, 2, size=(R, g.n)) - 1).astype(np.int8)
    nbr = torch.as_tensor(g.nbr, dtype=torch.int32, device=device)
    deg = torch.as_tensor(g.deg, dtype=torch.int32, device=device)
    sp = pack_spins(torch.as_tensor(s)).to(device)
    return Chunk(lambda: packed_rollout(nbr, deg, sp, steps))


def _build_bdcm_sweep(device, n: int = 64) -> Chunk:
    from graphdyn_torch.ops.bdcm import BDCMData, make_sweep

    data = BDCMData(_canon_rrg(n, 3, 1), p=1, c=1)
    sweep = make_sweep(data, damp=0.9, device=device)
    chi = data.init_messages(0).to(device)
    return Chunk(lambda: sweep(chi, 0.5))


def _entropy_config():
    from graphdyn_torch.config import DynamicsConfig, EntropyConfig

    return EntropyConfig(dynamics=DynamicsConfig(p=1, c=1), max_sweeps=50,
                         eps=1e-4)


def _build_entropy_cell_chunk(device, G: int = 2, n: int = 48) -> Chunk:
    import torch

    from graphdyn_torch.ops.bdcm import BDCMData
    from graphdyn_torch.pipeline.entropy_group import EntropyCellExec

    cells = [(BDCMData(_canon_rrg(n, 3, k), p=1, c=1), n, 0)
             for k in range(G)]
    ex = EntropyCellExec(cells, _entropy_config(), group_size=G,
                         device=device)
    chi = ex.stack_chi([c[0].init_messages(k) for k, c in enumerate(cells)])
    a_t = ex.factors([0.0] * G)
    active = torch.ones(G, dtype=torch.bool, device=device)
    delta = torch.full((G,), float("inf"), dtype=torch.float32,
                       device=device)
    t = torch.zeros(G, dtype=torch.int32, device=device)
    return Chunk(lambda: ex.fixed_point_chunk(chi, a_t, active, delta, t))


def _hpr_config():
    from graphdyn_torch.config import DynamicsConfig, HPRConfig

    return HPRConfig(dynamics=DynamicsConfig(p=1, c=1), max_sweeps=20)


def _build_hpr_group_loop(device, G: int = 2, n: int = 24) -> Chunk:
    from graphdyn_torch.pipeline.hpr_group import HPRGroupExec, _build_rep

    config = _hpr_config()
    items = [_build_rep(n, 3, config, k, "pairing") for k in range(G)]
    ex = HPRGroupExec(items, config, group_size=G, device=device)
    state = ex.init_state([it[2] for it in items], [it[3] for it in items],
                          [it[4] for it in items], list(range(G)))
    return Chunk(lambda: ex.advance(state, 5))


def _build_sa_group_loop(device, G: int = 2, n: int = 32) -> Chunk:
    import torch

    from graphdyn_torch.config import DynamicsConfig, SAConfig
    from graphdyn_torch.models.sa import prepare_sa_inputs
    from graphdyn_torch.pipeline.sa_group import (
        _assemble_group,
        _sa_group_loop,
    )

    config = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
    graphs = [_canon_rrg(n, 3, k) for k in range(G)]
    preps = [prepare_sa_inputs(g, config, n_replicas=1, seed=k,
                               max_steps=50)
             for k, g in enumerate(graphs)]
    _, idx, state, consts, static = _assemble_group(
        graphs, preps, list(range(G)), config, dtype=torch.float32,
        group_size=G, device=torch.device(device))
    return Chunk(lambda: _sa_group_loop(idx, state, consts, chunk_steps=10,
                                        **static))


def _build_bucketed_rollout(device, n: int = 256, W: int = 4,
                            steps: int = 4) -> Chunk:
    import numpy as np
    import torch

    from graphdyn_torch.graphs import degree_buckets, powerlaw_graph
    from graphdyn_torch.ops.bucketed import bucketed_rollout

    g = powerlaw_graph(n, gamma=2.5, dmin=2, seed=0)
    b = degree_buckets(g)
    rng = np.random.default_rng(0)
    sp = torch.as_tensor(rng.integers(-2**31, 2**31, size=(n, W),
                                      dtype=np.int64).astype(np.int32),
                         device=device)
    return Chunk(lambda: bucketed_rollout(b, sp, steps))


def _build_streamed_chunk(device, n: int = 256, W: int = 4,
                          n_chunks: int = 3) -> Chunk:
    import numpy as np
    import torch

    from graphdyn_torch.graphs import powerlaw_graph
    from graphdyn_torch.ops.streamed import _ChunkStepper, build_stream_plan

    g = powerlaw_graph(n, gamma=2.5, dmin=2, dmax=64, seed=0)
    plan = build_stream_plan(g, W=W, n_chunks=n_chunks)
    rng = np.random.default_rng(0)
    sp = torch.as_tensor(rng.integers(-2**31, 2**31, size=(n, W),
                                      dtype=np.int64).astype(np.int32))
    stepper = _ChunkStepper(torch.device(device), "majority", "stay")
    k = len(plan.chunks) - 1

    def run():
        return stepper.step(stepper.build(sp, k, plan.chunks[k]))
    return Chunk(run)


def _temper_config():
    from graphdyn_torch.config import DynamicsConfig, SAConfig

    return SAConfig(dynamics=DynamicsConfig(p=1, c=1))


def _build_temper_chunk(device, K: int = 4, n: int = 48) -> Chunk:
    import torch

    from graphdyn_torch.search.tempering import (
        _assemble_ladder,
        _temper_chunk,
        ladder_betas,
    )

    g = _canon_rrg(n, 3, 0)
    idx, state, consts, streams, static, _ = _assemble_ladder(
        g, _temper_config(), ladder_betas(K), 0, 200, "float32",
        torch.device(device))
    target = g.n
    return Chunk(lambda: _temper_chunk(
        idx, state, consts, 0, streams["proposals"], streams["uniforms"],
        max_steps=static["max_steps"], swap_interval=16,
        target_sum=target, injected=streams["injected"],
        stream_len=streams["stream_len"],
        **{k: static[k] for k in ("rollout_steps", "R_coef", "C_coef")}))


def _build_fused_chunk(device, R: int = 32, n: int = 48) -> Chunk:
    import torch

    from graphdyn_torch.ops.fused import fused_chunk
    from graphdyn_torch.search.fused import _assemble_fused

    state, tables_dev, static, tables, *_ = _assemble_fused(
        _canon_rrg(n, 3, 0), _temper_config(), n_replicas=R, seed=0,
        m_target=0.9, betas=None, tables=None, device=torch.device(device))
    return Chunk(lambda: fused_chunk(state, 0, tables_dev,
                                     chunk_steps=4 * tables.chi, **static),
                 state=state.sp_ext, state_of=lambda st: st.sp_ext)


def _needs_group(name: str, P: int):
    def build(device) -> Chunk:
        raise UnsupportedEntry(
            f"{name} needs a process group of {P} ranks (one rank per "
            f"shard); this is a one-process run")
    return build


#: the SA chains' one float64 op a step (``models/sa._accept_prob``)
_ACCEPT_F64 = ("exp(-dH) in float64 then rounded: the float32 accept "
               "probability correctly rounded, one op per chain step")

ENTRIES: dict[str, EntrySpec] = {
    "packed_rollout": EntrySpec(
        _build_packed_rollout, in_place=False,
        canon="RRG n=256 d=3, R=128 packed (W=4), steps=4"),
    "bdcm_sweep": EntrySpec(
        _build_bdcm_sweep, in_place=False,
        canon="RRG n=64 d=3, p=c=1, damp=0.9, one sweep at lambda=0.5"),
    "entropy_cell_chunk": EntrySpec(
        _build_entropy_cell_chunk, in_place=False,
        canon="G=2 cells, RRG n=48 d=3, p=c=1, one fixed-point chunk"),
    "hpr_group_loop": EntrySpec(
        _build_hpr_group_loop, in_place=False,
        canon="G=2 reps, RRG n=24 d=3, p=c=1, t_end=5"),
    "sa_group_loop": EntrySpec(
        _build_sa_group_loop, in_place=False,
        canon="G=2 reps, RRG n=32 d=3, p=c=1, max_steps=50, chunk_steps=10",
        f64_reason=_ACCEPT_F64),
    "sharded_rollout": EntrySpec(
        _needs_group("sharded_rollout", 2), in_place=False,
        canon="(replica, node) mesh, RRG n=64 d=3, R=8, steps=2"),
    "bucketed_rollout": EntrySpec(
        _build_bucketed_rollout, in_place=False,
        canon="power-law n=256 gamma=2.5 dmin=2 seed=0, degree-bucketed "
              "layout, W=4, steps=4"),
    "streamed_rollout": EntrySpec(
        _build_streamed_chunk, in_place=False,
        canon="power-law n=256 gamma=2.5 dmin=2 dmax=64 seed=0, stream "
              "plan K=3, last (hub) chunk's staging and step, W=4"),
    "halo_rollout": EntrySpec(
        _needs_group("halo_rollout", 2), in_place=False,
        canon="2-rank node mesh, RRG n=128 d=3, P=2 partition, W=4, "
              "steps=2"),
    "streamed_halo": EntrySpec(
        _needs_group("streamed_halo", 2), in_place=False,
        canon="2-rank node mesh, power-law n=200 gamma=2.3 dmin=2 seed=0, "
              "P=2 hub-split partition (threshold 12), W=4"),
    "tempering_ladder": EntrySpec(
        _build_temper_chunk, in_place=False,
        canon="K=4 drive ladder, RRG n=48 d=3, p=c=1, max_steps=200, "
              "swap_interval=16", f64_reason=_ACCEPT_F64),
    # the kernel updates the state in place (the reference's donation):
    # on the card the chunk's state keeps its address (GC001); the plain
    # version returns new tensors, so the CPU row records False
    "fused_anneal": EntrySpec(
        _build_fused_chunk, in_place=True,
        canon="R=32 packed replicas (W=1), RRG n=48 d=3, p=c=1, "
              "m_target=0.9, 4 sweeps"),
}

#: fingerprint fields gated by the ledger diff (the rest is informational)
_GATED_FIELDS = ("op_categories", "op_total", "f64_ops",
                 "largest_host_const_bytes", "launches", "state_in_place")


def collect_fingerprints(entries=None, *, device="cpu", diag=None
                         ) -> dict[str, dict]:
    """Fingerprints of ``entries`` (default: all) on ``device``; a one-off
    warm-up chunk runs first, so the fingerprint is a steady chunk's (no
    first-call build or lazy table copy)."""
    import torch

    from graphdyn_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    out = {}
    for name in entries or sorted(ENTRIES):
        if diag:
            diag(f"graftcheck: {name} on {dev} ({ENTRIES[name].canon})")
        try:
            chunk = ENTRIES[name].build(dev)
        except UnsupportedEntry as e:
            out[name] = {"unsupported": str(e)}
            continue
        chunk.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[name] = fingerprint_chunk(ENTRIES[name].build(dev))
    return out


# ---------------------------------------------------------------------------
# live rules
# ---------------------------------------------------------------------------


def audit_fingerprint(name: str, fp: dict, *, in_place: bool,
                      device: str = "cpu",
                      f64_reason: str | None = None) -> list[Finding]:
    """The ledger-free rules on one live fingerprint (GC001 applies on the
    card, where the kernels keep the contract; GC002 unless the entry's
    float64 is by design)."""
    findings = []
    if in_place and device == "cuda" and fp.get("state_in_place") is False:
        findings.append(Finding(
            name, "GC001",
            "declares the in-place state contract but the chunk returned "
            "its state at a new address — the state is double-buffered on "
            "the card"))
    if fp.get("f64_ops", 0) and f64_reason is None:
        findings.append(Finding(
            name, "GC002",
            f"{fp['f64_ops']} op(s) produce float64 from inputs of at most "
            f"32 bits — an implicit promotion doubles the chain's bytes"))
    if fp.get("largest_host_const_bytes", 0) > LARGE_CONSTANT_BYTES:
        findings.append(Finding(
            name, "GC003",
            f"a {fp['largest_host_const_bytes']} B host array is copied to "
            f"the card on every chunk (> {LARGE_CONSTANT_BYTES} B) — keep "
            f"the table on the card across calls"))
    return findings


class RecompileWatch:
    """Counts the port's counterparts of compiles across a run: kernel
    library builds (the ``kernel.build`` counter, whoever records it) and
    CUDA-graph captures, each under the entry point active when it
    happened (:meth:`entry`)::

        with RecompileWatch() as watch:
            with watch.entry("sa_group_loop"):
                run_driver(...)
        findings = check_recompiles(watch, {"sa_group_loop": 1})
    """

    def __init__(self):
        self.events: list[tuple[str, str]] = []     # (entry, what)
        self._entry = "<run>"
        self._saved = None

    def __enter__(self):
        import torch

        from graphdyn_torch import obs

        watch = self
        counter = obs.counter
        capture = torch.cuda.CUDAGraph.capture_begin

        def counted(name, inc=1, **attrs):
            if name == "kernel.build":
                watch.events.append((watch._entry,
                                     f"build {attrs.get('lib')}"))
            return counter(name, inc, **attrs)

        def captured(graph, *args, **kwargs):
            watch.events.append((watch._entry, "capture"))
            return capture(graph, *args, **kwargs)

        obs.counter = counted
        torch.cuda.CUDAGraph.capture_begin = captured
        self._saved = (counter, capture)
        return self

    def __exit__(self, *exc):
        import torch

        from graphdyn_torch import obs

        obs.counter, torch.cuda.CUDAGraph.capture_begin = self._saved
        return False

    def entry(self, name: str):
        import contextlib

        @contextlib.contextmanager
        def scope():
            prev, self._entry = self._entry, name
            try:
                yield
            finally:
                self._entry = prev
        return scope()

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for name, _ in self.events:
            out[name] = out.get(name, 0) + 1
        return dict(sorted(out.items()))


def check_recompiles(watch: RecompileWatch,
                     budgets: dict[str, int]) -> list[Finding]:
    """GC004: each entry's builds plus captures must not exceed its budget
    (a driver that captures its chunk once and builds each library once)."""
    counts = watch.counts()
    return [
        Finding(name, "GC004",
                f"{counts.get(name, 0)} kernel builds / CUDA-graph captures "
                f"(budget {budget}) — the entry rebuilds or recaptures "
                f"across the run: "
                + ", ".join(w for n, w in watch.events if n == name)[:300])
        for name, budget in budgets.items() if counts.get(name, 0) > budget
    ]


# ---------------------------------------------------------------------------
# ledger
# ---------------------------------------------------------------------------


def load_ledger(path: Path | str | None = None) -> dict | None:
    p = Path(path) if path else default_ledger_path()
    if not p.exists():
        return None
    with open(p) as fh:
        return json.load(fh)


def write_ledger(fingerprints: dict, platform: str,
                 path: Path | str | None = None) -> Path:
    """Write ``platform``'s rows (``cpu`` or ``cuda``) of the ledger
    atomically, keeping the other platform's."""
    import torch

    from graphdyn_torch.utils.io import write_json_atomic

    p = Path(path) if path else default_ledger_path()
    doc = load_ledger(p) or {"version": 1, "rows": {}}
    doc["canon"] = {name: ENTRIES[name].canon for name in sorted(ENTRIES)}
    doc["rows"][platform] = {
        "torch": torch.__version__.split("+")[0],
        "entries": {k: {f: v[f] for f in _GATED_FIELDS if f in v}
                    if "unsupported" not in v else v
                    for k, v in fingerprints.items()},
    }
    write_json_atomic(str(p), doc, indent=2, sort_keys=True)
    return p


def diff_fingerprints(entry: str, ledger_fp: dict,
                      live_fp: dict) -> list[Finding]:
    """Per-field band diff of one live fingerprint against its ledger row
    (the band table in the module docstring)."""
    findings = []
    lcat = ledger_fp.get("op_categories", {})
    vcat = live_fp.get("op_categories", {})
    for cat, cnt in sorted(vcat.items()):
        if cnt and cat not in lcat:
            findings.append(Finding(
                entry, "GC101",
                f"new ATen op category {cat!r} ({cnt} op(s)) absent from "
                f"the ledger — the chunk gained a new kind of operation "
                f"(a host sync, a copy, a scatter). If intentional, re-run "
                f"with --update-ledger"))
    for cat in sorted(lcat):
        want, got = lcat[cat], vcat.get(cat, 0)
        band = max(4, int(0.5 * want))
        if abs(got - want) > band:
            findings.append(Finding(
                entry, "GC102",
                f"op category {cat!r}: {want} -> {got} ops (band ±{band})"))
    want_t, got_t = ledger_fp.get("op_total", 0), live_fp.get("op_total", 0)
    band_t = max(2, int(0.25 * want_t))
    if abs(got_t - want_t) > band_t:
        findings.append(Finding(
            entry, "GC103",
            f"dispatched ops {want_t} -> {got_t} (band ±{band_t})"))
    if ledger_fp.get("state_in_place") and not live_fp.get("state_in_place"):
        findings.append(Finding(
            entry, "GC104",
            "in-place state LOST: the ledger's chunk kept its state's "
            "address, the live one moves it"))
    if ledger_fp.get("f64_ops", 0) != live_fp.get("f64_ops", 0):
        findings.append(Finding(
            entry, "GC002",
            f"float64 ops {ledger_fp.get('f64_ops', 0)} -> "
            f"{live_fp.get('f64_ops', 0)} against the ledger's count"))
    want_c = ledger_fp.get("largest_host_const_bytes", 0)
    got_c = live_fp.get("largest_host_const_bytes", 0)
    if got_c > max(4 * want_c, LARGE_CONSTANT_BYTES):
        findings.append(Finding(
            entry, "GC105",
            f"largest host constant copied per chunk {want_c} B -> "
            f"{got_c} B"))
    if ledger_fp.get("launches", {}) != live_fp.get("launches", {}):
        findings.append(Finding(
            entry, "GC106",
            f"hand-kernel launches {ledger_fp.get('launches', {})} -> "
            f"{live_fp.get('launches', {})} — one launch per step or chunk "
            f"is the kernels' contract. If intentional, re-run with "
            f"--update-ledger"))
    return findings


def check_ledger(live: dict[str, dict], ledger: dict | None,
                 platform: str, *, diag=None) -> list[Finding]:
    """Diff live fingerprints against the ledger's ``platform`` rows. A
    missing ledger, platform or entry is a finding."""
    if ledger is None or platform not in ledger.get("rows", {}):
        return [Finding(name, "GC100",
                        f"no {platform} rows in the ledger ({LEDGER_NAME}) — "
                        f"run `python -m graphdyn_torch.analysis.graftcheck "
                        f"--update-ledger --device {platform}` and commit it")
                for name in sorted(live)]
    entries = ledger["rows"][platform]["entries"]
    findings = []
    for name in sorted(live):
        if "unsupported" in live[name]:
            if diag:
                diag(f"graftcheck: skipping {name} — "
                     f"{live[name]['unsupported']}")
            continue
        if name not in entries or "unsupported" in entries[name]:
            findings.append(Finding(
                name, "GC100",
                "entry point not in the fingerprint ledger — run "
                "--update-ledger and commit the new row"))
            continue
        findings.extend(diff_fingerprints(name, entries[name], live[name]))
    return findings


def _diag(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.analysis.graftcheck",
        description="graftcheck: dispatch fingerprints of the port's entry "
                    "points against the committed ledger (exit code = "
                    "number of findings)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--ledger", default=None,
                    help=f"ledger path (default: {LEDGER_NAME} beside this "
                         f"module)")
    ap.add_argument("--entries", default=None,
                    help="comma-separated subset (default: all)")
    ap.add_argument("--device", default="cpu",
                    help="cpu (the tier-1 rows) or cuda (the card's rows)")
    ap.add_argument("--update-ledger", action="store_true",
                    help="rewrite this device's ledger rows from the live "
                         "fingerprints")
    args = ap.parse_args(argv)

    entries = args.entries.split(",") if args.entries else None
    platform = "cuda" if args.device.startswith("cuda") else "cpu"
    live = collect_fingerprints(entries, device=args.device, diag=_diag)
    findings = []
    for name, fp in live.items():
        if "unsupported" not in fp:
            spec = ENTRIES[name]
            findings += audit_fingerprint(name, fp, in_place=spec.in_place,
                                          device=platform,
                                          f64_reason=spec.f64_reason)
    if args.update_ledger:
        path = write_ledger(live, platform, args.ledger)
        _diag(f"graftcheck: wrote {len(live)} {platform} row(s) to {path}")
    else:
        findings += check_ledger(live, load_ledger(args.ledger), platform,
                                 diag=_diag)
    if args.format == "json":
        print(json.dumps({"findings": [f._asdict() for f in findings],
                          "fingerprints": live}, indent=2))
    else:
        for f in findings:
            print(f"{f.entry}: {f.code} {f.message}")
    if findings:
        _diag(f"graftcheck: {len(findings)} finding(s)")
    return min(len(findings), 125)


if __name__ == "__main__":
    sys.exit(main())
