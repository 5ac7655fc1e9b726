#!/usr/bin/env python3
"""Smoke test of graphdyn_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Builds the six CUDA kernels from ``graphdyn_torch/csrc/`` with nvcc
(sm_90a, the six compilers started together) and holds each against its
plain PyTorch version: the packed step (node order, 16-byte vectors, any
degree since the power-law slice), the fused annealer (one pass and one
grid barrier per class step), the row gather and the bucketed step KB (one
launch per synchronous step over every degree bucket, warps per hub row)
bit for bit, the BDCM sweep (one launch per sweep, also on an 80-class
tree, past the 64 classes it once took) and the per-class BDCM update
within their stated tolerances. Then it drives the port's main paths
through the entry points a user calls, each with the launch counts set to 0
just before it and read just after (every BDCM sweep on the card is one
launch of the sweep kernel; the per-class kernel is off the main paths and
must count 0 there):

- the packed rollout at the headline shape (d=3 RRG, n=10⁶, R=16384) and the
  config-3 consensus sweep (ER n=10⁵, c=6, R=512), checked against the JAX
  package's recorded sweep of the same graph (``er_consensus_r05.json``);
- the fused SA annealer (``fused_anneal``) at config 1 (d=3 RRG, n=10⁴,
  R=32), runs (a) and (b) of ``fused_config1_ref.json``, held to that record
  of the JAX package's runs under the near-tie rule, and the ``fused`` CLI
  once at its defaults;
- HPr at the reference shape (RRG d=4, n=10⁴, TT=10⁴): the ``hpr`` CLI at
  its defaults, ``hpr_ensemble(n_rep=4, group_size=4)`` and ``hpr_solve`` in
  float64, after the CUDA path is held to the JAX package's record
  ``hpr_ref.json``; the kernel chain against the plain chain on RRG(200, 4)
  under the near-tie rule; and config 2 (union of 256 copies of a d=3 RRG,
  n=10⁵, 20 sweeps) through ``hpr_solve_batch`` and the CLI;
- the BDCM kernels past T = 4 and past a block's shared memory: the ``hpr``
  CLI at T = 5 (``--p 4 --c 1`` on RRG d=4, n=10⁴, 50 sweeps) in float32
  and float64; ``make_sweep`` at T = 6 (p=5, c=1) on RRG(10³, 3); and
  ``entropy_sweep`` at T = 4 on ER(2000, 6/1999), whose hub classes take
  the global-lattice path (4 λ, one 16-sweep chunk per λ, the first λ held
  against the plain ladder on the card); the first sweeps of each held
  against the plain sweep, each timed beside its bound; a T = 7 plan
  refused;
- the row-gather probe (``python -m graphdyn_torch.scripts.gather_probe`` at
  its defaults, every line matching ``index_select``), then the port's own
  gather widths (W = 1, 16, 32, 512) timed beside ``index_select``;
- the entropy λ-ladders: ``entropy_sweep`` in float64 on the golden
  instance (the ten notebook triples within 5e-3, ``entropy_ref.json``
  within 1e-9), the record's reduced config-4 union in float64 and float32
  (and two runs equal bit for bit), ``entropy_grid`` grouped == serial bit
  for bit, config 4 at full width through ``entropy_ensemble_union`` (64 ER
  instances, n=1000, c=1.5, 32 λ, max_sweeps 400, float32), the congruent
  ensemble on 64 RRG(1000, 3), and the ``entropy`` CLI at its defaults
  but for its λ ladder, cut to λ ≤ 3;
- the SA searches, plain PyTorch on the card (no TPU kernel lies on their
  path): injected-stream chains on the card equal to the same chains on the
  CPU (RRG n=300 d=4 and a ragged ER graph, full and light-cone), counter-
  stream chains that reach consensus rolled out to all +1, the chromatic
  chain and the tempering ladder card == CPU; then the ``sa`` CLI at its
  defaults (n=10⁴, d=4, p=3, grouped G=5) and with ``--rollout-mode
  lightcone`` (serial), which must agree bit for bit, with steps/s, host
  reads and the device's busy share over one chunk; the ``chromatic`` CLI
  and the ``temper`` CLI at their defaults. The step budgets of ``sa`` and
  ``temper`` are cut to 2.5·10³ and 5·10³ (a chain at those defaults takes
  ~10⁸ steps);
- the power-law path (``bench.py``'s ``powerlaw_rate_row`` and
  ``stream_rate_row`` shapes): KB against its plain version on
  ``powerlaw_graph(600, 2.3, 2, 7)`` and on the bench graph
  (``powerlaw_graph(10⁵, 2.2, 2, 0)``, hub 19,617) for all four (rule,
  tie); the packed step's 8- and 32-plane instantiations against plain;
  ``bucketed_rollout`` at the bench shape (R = 1024, 3 × 20 steps,
  one KB launch per step) with its time, bound and spin-updates/s beside
  the equal-edge d=8 RRG through the packed step (bare and through
  ``packed_rollout``), and the packed step on the padded power-law table
  equal to KB; the ``stream`` CLI at n = 65,536 with ``bench.py``'s device
  budget at prefetch depth 0 and 2, equal to the resident rollout, a
  churned run at n = 4096 card == CPU, and ``streamed_rollout`` on one
  plan at both depths in turns (ms per step, ``hiding_frac``);
  ``simulated_annealing`` and ``fused_anneal`` with ``layout='auto'`` on
  power-law graphs equal to their padded runs on the relabeled graphs, and
  ``sa --layout bucketed``; then the packed step at the headline shape in
  the as-built and the BFS labelling, in turns (ROADMAP B4);
- K4′ past dmax 63 (C4): the kernel against its plain version on
  power-law graphs relabeled bucket-major with hubs of 163 and 1011 (the
  8- and 16-plane instantiations), timed per class step, and
  ``fused_anneal(layout='bucketed')`` through it, counted;
- durability, each command preempted and resumed and held to its
  uninterrupted run above bit for bit, with the store's ms per snapshot:
  the ``sa`` CLI (killed by ``GRAPHDYN_FAULT_PLAN``, then a real SIGTERM
  that must exit 75, then resumed), ``hpr`` in float32 and float64 (K3′
  launches over both legs = the sweeps), the ``entropy`` CLI (and a
  ``sweep.nan`` injection that must take the degrade path), the ``stream``
  CLI with churn (KB launches = chunks × steps over both legs), ``temper``,
  ``fused --deadline`` (exit 75), ``run-supervised -- sa`` through a crash
  (and a crash loop, exit 86), and an injected ``pallas.lower`` failure,
  which must end the run;
- node-axis sharding (the ``parallel`` group): K1/K2′'s launch on the halo
  shard layout against its plain twin, bit for bit, for the four (rule,
  tie) on every shard of the headline RRG's and config 3's partitions (pad
  rows included), timed beside its bound; ``packed_rollout(partition=)``
  for 20 steps at the headline and config 3 on two ranks spawned on the one
  card over gloo (P = 2, exchanges staged through pinned host buffers) and
  on a one-rank NCCL group (P = 1), each equal to the unsharded K1/K2′
  rollout, with the step's and the exchange's ms, the bytes per step, the
  edge cut and the partitioner's host seconds; ``consensus --sharded`` at
  the headline width at P = 1 and P = 2 equal to unsharded; config 5's
  single-card width through ``sa_sharded(rollout_mode='lightcone')`` (d=5
  RRG, n=10⁶, 1024 replicas on a 16-point ladder, 2 chunks), µs per step
  and peak memory; ``sa_sharded`` in gather and halo modes at P = 2 equal
  to the one-process chain, and a P = 2 run preempted and resumed at P = 1
  equal to it; memcheck's halo row; ``hpr --device-init`` at config 2
  (set-up seconds beside the host init's, K3′ launches = sweeps, card ==
  CPU on a small shape, in the ``bdcm`` group);
- the chaos soak's bounded matrix on the card (``soak``: 11 scenarios,
  seed 0 and more seeds while the run has time).

It also times the fused kernel at config 5's single-chip width (d=5 RRG,
n=10⁶, R=1024), with its peak device memory; the packed step and its bare
gather beside ``index_select`` at the headline and config 3; the per-class
BDCM kernel per launch; and the BDCM sweep kernel per sweep at config 4, the
congruent ensemble, the golden instance, the HPr reference shape and config
2, each beside the per-class route (PyTorch gathers, the per-class kernel
and ``index_copy_`` per class, composed here) and the plain sweep; and the
row gather against ``index_select`` in turns, 9 repeats each, at the
probe's widths, the headline step's gather and the port's 16- and 32-word
rows (median and range).

Prints, in order: phase reports, the card's name and power limit (from
nvidia-smi), one JSON line listing the kernels with their measured times, and
as the last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
exit code is not 0 and the last line is not printed. There is no CPU mode:
without a CUDA device the script exits non-zero at once. Imports neither
``jax`` nor the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from graphdyn_torch import cli, graphs
from graphdyn_torch.config import (
    DynamicsConfig,
    EntropyConfig,
    HPRConfig,
    SAConfig,
)
from graphdyn_torch.graphs import (
    build_edge_tables,
    erdos_renyi_graph,
    random_regular_graph,
)
from graphdyn_torch.models import entropy as entropy_models
from graphdyn_torch.models import sa as sa_models
from graphdyn_torch.models import entropy_reference as eref
from graphdyn_torch.models.entropy import (
    entropy_ensemble,
    entropy_ensemble_union,
    entropy_grid,
    entropy_sweep,
    lambda_ladder,
)
from graphdyn_torch.models.hpr import (
    _BatchState,
    _draw_union_chi,
    hpr_ensemble,
    hpr_solve,
    hpr_solve_batch,
    make_hpr_batch_chunk,
)
from graphdyn_torch.models.hpr_reference import (
    hold_to_ref_record,
    near_tie_replay,
    port_fields,
    port_ref_record,
    ref_init,
    walk_to_divergence,
)
from graphdyn_torch.models.sa import simulated_annealing
from graphdyn_torch import obs
from graphdyn_torch.obs import flight as obs_flight
from graphdyn_torch.obs import report as obs_report
from graphdyn_torch.obs import trace as obs_trace
from graphdyn_torch.obs.recorder import read_ledger as obs_read_ledger
from graphdyn_torch.obs.roofline import (
    class_step_bound,
    contract_bound,
    HBM_BYTES_PER_S,
    kb_bound,
    step_bound,
    sweep_bound,
)
from graphdyn_torch.models.consensus import (
    consensus_curve,
    consensus_point,
    er_consensus_ensemble,
)
from graphdyn_torch.ops import (
    bdcm_cuda,
    bdcm_sweep,
    bucketed,
    bucketed_cuda,
    cuda_build,
    fused_cuda,
    gather_cuda,
    packed_cuda,
    streamed,
)
from graphdyn_torch.ops.bdcm import (
    CHUNK_SWEEPS,
    BDCMData,
    EnsembleBDCM,
    NodeBias,
    SweepTables,
    _sweep_core,
    dp_contract,
    dp_contract_grouped,
    make_ensemble_sweep,
    make_fixed_point,
    make_sweep,
    tilt_vector,
    tilted_factors,
)
from graphdyn_torch.ops.dynamics import end_state, run_dynamics
from graphdyn_torch.ops.gather import row_gather, row_gather_plain
from graphdyn_torch.ops.lightcone import build_lightcone_tables
from graphdyn_torch.ops.chromatic import build_chromatic_tables
from graphdyn_torch.ops.fused import (
    FusedState,
    build_fused_tables,
    fused_chunk,
)
from graphdyn_torch.ops.packed import (
    draw_packed_biased,
    packed_consensus_scan,
    _stepper,
    packed_end_state,
    packed_rollout,
    packed_rollout_plain,
)
from graphdyn_torch.plotting import masked_mean
from graphdyn_torch.pipeline import hpr_group, sa_group
from graphdyn_torch.pipeline.entropy_group import EntropyCellExec
from graphdyn_torch.pipeline.hpr_group import (
    HPRGroupExec,
    host_init,
    hpr_uniforms,
)
from graphdyn_torch.resilience import faults, supervisor
from graphdyn_torch.resilience import store as tstore
from graphdyn_torch.resilience.retry import RetryPolicy
from graphdyn_torch.resilience.shutdown import EX_TEMPFAIL, clear_shutdown
from graphdyn_torch.scripts import gather_probe
from graphdyn_torch.search.chromatic import chromatic_anneal
from graphdyn_torch.search.fused import _assemble_fused, fused_anneal
from graphdyn_torch.search.reference import (
    hold_to_record,
    result_record,
    run_record,
)
from graphdyn_torch.search.tempering import temper_search

HERE = os.path.dirname(os.path.abspath(__file__))


HEADLINE_N, HEADLINE_D, HEADLINE_R = 10**6, 3, 16384
CONFIG3_N, CONFIG3_C, CONFIG3_R = 100_000, 6.0, 512
CONFIG3_M0 = [0.0, 0.01, 0.02, 0.03, 0.05, 0.07, 0.1, 0.15, 0.2, 0.3]
CONFIG3_MAX_STEPS, CONFIG3_CHUNK = 2000, 10
RULE_TIES = [("majority", "stay"), ("majority", "change"),
             ("minority", "stay"), ("minority", "change")]
CONFIG1 = dict(n=10_000, d=3, replicas=32, seed=0)
CONFIG1_RUNS = {"a": dict(m_target=0.9, max_sweeps=5000, chunk_sweeps=256),
                "b": dict(m_target=1.0, max_sweeps=200, chunk_sweeps=256)}
SCALE_N, SCALE_D, SCALE_R = 10**6, 5, 1024
# the BDCM class update (K3): the (d, T) pairs held against the plain
# version (the register path up to M = 32, the block path above it, up to
# the reference regime's corner (8, 4) and a high-degree class (40, 2); T =
# 5 and 6 on the block path (K = 32, 64); the global-lattice path past a
# block's shared memory: (13, 4) in both dtypes, (10, 4) in f64, (7, 5),
# (5, 6), (170, 2)), and the tolerance of one launch (rtol, atol): the
# kernel's sums run in another order than the plain version's, with fused
# multiply-adds
CONTRACT_PAIRS = [(1, 2), (2, 2), (3, 2), (4, 2), (5, 2), (8, 2), (40, 2),
                  (3, 1), (20, 1), (3, 3), (2, 4), (3, 4), (8, 4),
                  (1, 5), (3, 5), (2, 6), (10, 4), (13, 4), (7, 5), (5, 6),
                  (170, 2)]
# lattices above this size are checked at Ed ∈ {1, 129} only: the plain
# version's lattice costs Ed·K·M per shift-FMA; above CONTRACT_HUGE_M
# (the global-lattice pairs) at (G, Ed) ∈ {(1, 1), (2, 3)}
CONTRACT_BIG_M = 300
CONTRACT_HUGE_M = 10_000
CONTRACT_TOL = {torch.float32: (1e-5, 1e-7), torch.float64: (1e-12, 1e-15)}
# HPr: the reference shape (the hpr CLI's defaults, `HPR:224-237`) and config
# 2 (`BASELINE.md:30`), cut only in its sweep count; HPr at T = 5 (the CLI
# with --p 4 --c 1, its other defaults), cut to HPR_T5_SWEEPS sweeps
HPR_N, HPR_D = 10_000, 4
HPR_T5_SWEEPS = 50
# T = 6: one make_sweep run on RRG(10^3, 3) at p=5, c=1 (one class, d=2,
# M=729, K=64, the block path); the global path at T = 4: entropy_sweep on
# ER(2000, 6/1999) at p=3, c=1, 4 λ in [0, 3], its sweeps cut to one chunk
# of GLOBAL_MAX_SWEEPS per λ
T6_N, T6_SWEEPS = 1000, 3
GLOBAL_N, GLOBAL_C, GLOBAL_SEED, GLOBAL_MAX_SWEEPS = 2000, 6.0, 0, 16
CONFIG2_N, CONFIG2_D, CONFIG2_R, CONFIG2_SWEEPS = 100_000, 3, 256, 20
# the row gather (P): the widths held against index_select, and the port's
# own gathers as (label, n_src, W, n_idx): the rows and the gathers per step
# of each main path (config 1: n+1 rows of one word, 3 neighbours each;
# config 3: ER n=10^5, c=6; HPr config 2: 64-byte chi rows of the 256-copy
# union, two incoming messages per directed edge; the fused scale shape: d=5,
# n=10^6; the headline: d=3, n=10^6, 2 KB rows)
GATHER_PARITY_WIDTHS = (1, 3, 16, 32, 128, 512, 1024)
# the entropy λ-ladders: config 4 at full width (`BASELINE.md:32`,
# `benchmarks/config4_bdcm_entropy.py:22-55,133`: 64 ER(1000, 1.5/999)
# instances, seed k, 32 λ in linspace(0, 3.1, 32), max_sweeps 400, float32);
# the congruent ensemble at the same λ and config (64 RRG(1000, 3)); the
# grouped-vs-serial grid through the kernel
CONFIG4_N, CONFIG4_C, CONFIG4_G, CONFIG4_L = 1000, 1.5, 64, 32
CONFIG4_LMBD_MAX, CONFIG4_MAX_SWEEPS = 3.1, 400
GROUPED_GRID = dict(n=300, deg=(1.0, 1.5, 2.0), num_rep=3, lmbd_max=0.6)
# the sweep kernel past 64 edge classes: a caterpillar whose hubs have the
# degrees 2..81 (80 classes at T=2), a few sweeps through make_sweep
MANY_CLASS_DEGREES, MANY_CLASS_SWEEPS = tuple(range(2, 82)), 3
# the packed step: the widths of its one-word and uint4 threads held
# against the plain stepper
PARITY_WIDTHS = (1, 3, 5, 16, 33, 512)
GATHER_PORT_SHAPES = (
    ("config 1 (W=1)", 10_001, 1, 30_000),
    ("config 3 (W=16)", 99_785, 16, 600_000),
    ("HPr config 2 chi rows (W=16)", 76_800_000, 16, 153_600_000),
    ("fused scale (W=32)", 1_000_001, 32, 5_000_000),
    ("headline (W=512)", 1_000_001, 512, 3_000_000),
)


# the SA searches: the card-vs-CPU parity graphs and stream length; the
# main paths' step budgets, cut from the default 2n^3 (clamped to 2^31-2),
# since a chain at the sa CLI's defaults takes ~10^8 steps to consensus
# (physics_r04.json)
SA_PARITY_N, SA_PARITY_L = 300, 2000
SA_MAIN_STEPS, TEMPER_MAIN_STEPS = 2_500, 5_000
# repeats of each implementation in the interleaved gather timing
GATHER_REPS = 9
# the entropy CLI's λ ladder, cut from its default 12.0 (121 points) to
# keep the script's time since the power-law and durability phases joined
ENTROPY_CLI_LMBD_MAX = 3.0
# the power-law path: bench.py:powerlaw_rate_row's shape
# (powerlaw_graph(10^5, gamma=2.2, dmin=2, seed=0), R=1024, 20 steps x 3
# iterations) and stream_rate_row's (n=65,536, the same law, R=1024, 10
# steps); the SA layout run's step budget (cut from 2n^3); B4's repeats
POWERLAW_N, POWERLAW_R, POWERLAW_STEPS, POWERLAW_ITERS = 100_000, 1024, 20, 3
STREAM_N, STREAM_R, STREAM_STEPS = 65_536, 1024, 10
LAYOUT_SA_STEPS = 2000
B4_REPS = 9
# K4' past dmax 63 (C4): a power-law graph with a hub in the thousands
# (powerlaw_graph(4000, 2.0, 2, 1): dmax 1011, the 16-plane kernel)
HUBS_N, HUBS_SEED = 4000, 1
# the class steps held to the plain version at each hub graph (from class 0,
# the hub's): the plain hub step costs seconds at dmax 1011
HUBS_PARITY_STEPS = {"dmax163": 4, "dmax1011": 1}
# the sa leg's real SIGTERM, this long after the CLI's handler is installed
SIGTERM_DELAY_S = 0.5
# the entropy CLI's run is killed at this lambda boundary (of ~280)
ENTROPY_KILL_AT = 40
# ... and poisoned (sweep.nan) at this fixed point of a λ ≤ 0.5 run
ENTROPY_NAN_AT = 14
# telemetry (phases 48-52): the entropy CLI's ladder there, the turns of the
# recording-cost legs, and the cuts of the HPr runs (the reference stops at
# ~1640 sweeps; a profiled run of all of them writes a 250 MB trace) and of
# the sa chunk loop (5 chunks of 256 steps)
OBS_ENTROPY_LMBD_MAX = 0.5
OBS_REPEATS = 5
OBS_HPR_SWEEPS, OBS_HPR_CHUNK = 400, 80
OBS_SA_STEPS = 1280
# node-axis sharding (the parallel group): steps of each halo main path and
# of its timed split; the small SA shape of the sharded chains; the
# consensus leg at the headline width; config 5's light-cone run through
# the CLI (cut to CONFIG5_CHUNKS chunks); the spawned ranks' time limit
PAR_STEPS, PAR_TIMED_STEPS = 20, 5
PAR_SA_N, PAR_SA_R, PAR_SA_L = 2000, 8, 300
PAR_CONSENSUS_ARGV = ["consensus", "--graph", "rrg", "--n", str(10**6),
                      "--d", "3", "--replicas", "16384", "--m0", "0.1",
                      "--max-steps", "20", "--chunk", "10", "--device",
                      "cuda"]
CONFIG5_CHUNKS, CONFIG5_CHUNK = 2, 256
PAR_SPAWN_TIMEOUT_S = 600
# the soak group adds seeds past seed 0 while the run is inside this
SOAK_UNTIL_S = 900
# the chromatic phase's profiled chunk (its 64-sweep timing run is apart)
CHROMATIC_PROFILE_SWEEPS = 8


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A report line, after the seconds since the script started (so a
    run's log shows where its time goes)."""
    print(f"{time.perf_counter() - _T0:8.1f}s {msg}", flush=True)


def _cuda_ms(fn, reps: int, lead_ms: float = 0.0) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``reps`` calls. ``lead_ms`` of device sleep ahead of the
    start event lets the host queue the calls first, so work shorter than
    its host launch cost is timed back to back on the device rather than at
    the host's issue rate (the queue holds about a thousand launches)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if lead_ms:
        torch.cuda._sleep(int(lead_ms * 2e6))      # cycles, at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _random_words(n: int, W: int, seed: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n, W), dtype=torch.int64,
                         device="cuda", generator=gen).to(torch.int32)


def _tables(g):
    return (torch.as_tensor(g.nbr, dtype=torch.int32, device="cuda"),
            torch.as_tensor(g.deg, dtype=torch.int32, device="cuda"))


def _max_abs_err(a, b) -> float:
    if torch.equal(a, b):
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def ptxas_by_type(lib_path: str, ftype: str) -> dict:
    """Registers, spills and stack frame of a BDCM kernel's instantiations
    for one float type, from the compiler report kept beside the library
    (entries whose mangled name takes ``f`` or ``d`` as the first template
    argument)."""
    with open(f"{lib_path}.log") as f:
        blocks = f.read().split("Compiling entry function '")[1:]
    tag = "If" if ftype == "float" else "Id"
    regs, spills, stack = [], [], []
    for b in blocks:
        name = b.split("'", 1)[0]
        if tag not in name:
            continue
        regs += [int(r) for r in re.findall(r"Used (\d+) registers", b)]
        for fr, st, ld in re.findall(r"(\d+) bytes stack frame, (\d+) bytes "
                                     r"spill stores, (\d+) bytes spill loads", b):
            stack.append(int(fr))
            spills.append(int(st) + int(ld))
    if not regs:
        raise RuntimeError(f"no {ftype} instantiation in {lib_path}.log")
    return {"kernels": len(regs), "registers_min": min(regs),
            "registers_max": max(regs), "spill_bytes_max": max(spills or [0]),
            "stack_frame_max": max(stack or [0])}


def phase_build() -> dict:
    """Build the six kernel libraries, one nvcc each, started together;
    load them; print each one's ptxas summary (the BDCM kernels' float and
    double instantiations apart) and the fused kernel's co-resident grid at
    the two shapes it runs."""
    t0 = time.perf_counter()
    wrappers = {"packed_step": packed_cuda, "fused_chunk": fused_cuda,
                "dp_contract": bdcm_cuda, "bdcm_sweep": bdcm_sweep,
                "row_gather": gather_cuda, "bucketed_step": bucketed_cuda}
    with ThreadPoolExecutor(len(wrappers)) as pool:
        paths = dict(zip(wrappers, pool.map(lambda w: w.build(),
                                            wrappers.values())))
    for w in wrappers.values():
        w._library()
    dt = time.perf_counter() - t0
    out = {"build_s": dt}
    for name, path in paths.items():
        ptxas = cuda_build.ptxas_summary(path)
        out[name] = ptxas
        log(f"[1 build] {os.path.relpath(path, HERE)}: ptxas -v over "
            f"{ptxas['kernels']} instantiations: {ptxas['registers_min']}-"
            f"{ptxas['registers_max']} registers, at most "
            f"{ptxas['spill_bytes_max']} bytes of spill stores + loads")
    for name in ("dp_contract", "bdcm_sweep"):
        for ftype in ("float", "double"):
            ptxas = ptxas_by_type(paths[name], ftype)
            out[f"{name}_{ftype}"] = ptxas
            log(f"[1 build] {name} {ftype} instantiations: {ptxas}")
    for label, dmax, Rp in (("config 1", CONFIG1["d"], CONFIG1["replicas"]),
                            ("scale", SCALE_D, SCALE_R)):
        grid = fused_cuda.grid_info(dmax, Rp)
        lanes, row_threads = fused_cuda.lane_plan(Rp // 32)
        out[f"grid_{label.replace(' ', '')}"] = grid
        log(f"[1 build] fused_chunk co-resident grid at {label} (dmax={dmax}, "
            f"Rp={Rp}): {grid['blocks_per_sm']} blocks of 256 per SM x "
            f"{grid['sms']} SMs = {grid['max_blocks']} blocks; {lanes} "
            f"lanes per class word, {row_threads} threads per class row")
    log(f"[1 build] the six libraries built and loaded in {dt:.3f} s")
    return out


def phase_parity(g_h, g_e) -> float:
    """Kernel against plain, bit-exact, over the fast path, the general
    path, W in :data:`PARITY_WIDTHS` (one word per thread where W is not a
    multiple of 4, a uint4 where it is), 1/2/7 steps, a dmax-63 graph (six
    bit planes), states not 16-byte aligned (one word per thread at W = 16
    and 512), the ghost row, the consensus scan, and the main path's two
    shapes. Returns
    the max |kernel - plain| over the words (0 when every case is
    bit-identical)."""
    err = 0.0
    n_cases = 0
    t0 = time.perf_counter()

    def check(g, W, rule, tie, steps, seed, expect_fast):
        nonlocal err, n_cases
        nbr, deg = _tables(g)
        fast = packed_cuda.fast_path_degree(g.deg, rule) > 0
        if fast != expect_fast:
            raise AssertionError(f"fast-path gate {fast} != {expect_fast}")
        sp = _random_words(g.n, W, seed)
        k = packed_rollout(nbr, deg, sp, steps, rule, tie)
        p = packed_rollout_plain(nbr, deg, sp, steps, rule, tie)
        torch.cuda.synchronize()
        e = _max_abs_err(k, p)
        if e:
            raise AssertionError(
                f"kernel != plain: n={g.n} dmax={g.dmax} W={W} {rule}/{tie} "
                f"steps={steps} max_abs_err={e}")
        err = max(err, e)
        n_cases += 1

    small = {
        "rrg3": random_regular_graph(5000, 3, seed=1),
        "rrg5": random_regular_graph(5000, 5, seed=2),
        "rrg4": random_regular_graph(4000, 4, seed=3),
        "er_ragged": erdos_renyi_graph(5000, 3.0 / 5000, seed=4),  # isolates kept
    }
    # a ragged graph with one node of degree 63 (dmax 63: six bit planes)
    er = erdos_renyi_graph(3000, 3.0 / 3000, seed=6)
    hub = [(0, v) for v in range(1, 64)]
    rest = [(u, v) for u, v in er.edges.tolist() if u != 0 and v != 0
            and (u, v) not in hub]
    small["dmax63"] = graphs.graph_from_edges(
        3000, np.asarray(hub + rest, dtype=np.int64))
    if small["dmax63"].dmax != 63:
        raise AssertionError(f"dmax63 graph has dmax {small['dmax63'].dmax}")
    seed = 0
    for W in PARITY_WIDTHS:
        for steps in (1, 2, 7):
            for name in ("rrg3", "rrg5"):
                for rule in ("majority", "minority"):
                    seed += 1
                    check(small[name], W, rule, "stay", steps, seed, True)
            for name in ("rrg4", "er_ragged", "dmax63"):
                for rule, tie in RULE_TIES:
                    seed += 1
                    check(small[name], W, rule, tie, steps, seed, False)

    # states one word off 16-byte alignment: the one-word threads at widths
    # that are multiples of 4, one step against the plain stepper
    for name in ("rrg3", "dmax63"):
        g = small[name]
        nbr, deg = _tables(g)
        du = packed_cuda.fast_path_degree(g.deg, "majority")
        for W in (16, 512):
            seed += 1
            n1 = (g.n + 1) * W
            buf = torch.zeros(2 * n1 + 1, dtype=torch.int32, device="cuda")
            a = buf[1:n1 + 1].view(g.n + 1, W)
            b = buf[n1 + 1:].view(g.n + 1, W)
            a[:g.n] = _random_words(g.n, W, seed)
            if packed_cuda.aligned16(a) or packed_cuda.aligned16(b):
                raise AssertionError("the unaligned case is aligned")
            want = _stepper(nbr, deg, "majority", "stay", plain=True)(a.clone())
            packed_cuda.packed_step(nbr, deg, a, b, minority=False,
                                    change=False, d_uniform=du)
            torch.cuda.synchronize()
            if not torch.equal(b, want):
                raise AssertionError(f"unaligned one-word step != plain: "
                                     f"{name} W={W}")
            n_cases += 1

    # the ghost row stays zero under tie=change, step by step
    g = small["er_ragged"]
    nbr, deg = _tables(g)
    a = torch.cat([_random_words(g.n, 16, 99),
                   torch.zeros(1, 16, dtype=torch.int32, device="cuda")])
    b = torch.full_like(a, -1)
    for _ in range(5):
        packed_cuda.packed_step(nbr, deg, a, b, minority=False, change=True)
        torch.cuda.synchronize()
        if bool(b[g.n].ne(0).any()):
            raise AssertionError("ghost row not zero after a tie=change step")
        a, b = b, a

    # the consensus scan: the same state through the kernel and the plain
    # version on the CPU
    g_s, _, nbr_s, deg_s = er_consensus_ensemble(2000, c=6.0, seed=5,
                                                 device="cuda")
    sp = draw_packed_biased(7, g_s.n, 2, 0.05, device="cuda")
    out_k = packed_consensus_scan(nbr_s, deg_s, sp, R=64, max_steps=100,
                                  chunk=10)
    out_p = packed_consensus_scan(nbr_s.cpu(), deg_s.cpu(), sp.cpu(), R=64,
                                  max_steps=100, chunk=10)
    for key, val in out_k.items():
        same = (val == out_p[key]) if key == "steps_run" else \
            torch.equal(val.cpu(), out_p[key])
        if not same:
            raise AssertionError(f"consensus scan output {key!r}: kernel != plain")

    # the main path's shapes: headline (fast path) and config 3 (general)
    check(g_h, HEADLINE_R // 32, "majority", "stay", 2, 11, True)
    check(g_e, CONFIG3_R // 32, "majority", "stay", 10, 12, False)
    torch.cuda.empty_cache()
    log(f"[2 parity] {n_cases} rollout cases + ghost row + consensus scan: "
        f"kernel == plain bit for bit (max_abs_err {err}) in "
        f"{time.perf_counter() - t0:.3f} s")
    return err


def phase_timing(g, nbr, deg, sp, reps: int, plain_reps: int) -> dict:
    """At one shape (outside the main-path count window): the kernel's time
    per launch (CUDA events around ``reps`` steps of the rollout's own
    stepper, queued back to back), the bare gather of the step's own
    neighbour rows (every real slot of every row) by the row-gather kernel
    and by ``index_select`` in the same call, the plain version's time per step (a
    few hundred small PyTorch ops per step at dmax 19, more than the queue
    holds over many steps, so host gaps may remain in it), the host's wall
    time per step of ``packed_rollout`` (Python, checks and launch
    included), and the bound."""
    W = sp.shape[1]
    ext = torch.cat([sp, torch.zeros(1, W, dtype=torch.int32, device="cuda")])
    for plain in (False, True):
        step = _stepper(nbr, deg, "majority", "stay", plain=plain)
        state = [ext]

        def advance():
            state[0] = step(state[0])

        for _ in range(3):
            advance()
        t = _cuda_ms(advance, plain_reps if plain else reps, lead_ms=100)
        if plain:
            plain_ms = t
        else:
            ms, fast = t, step.d_uniform > 0
        del step, state
    slots = torch.arange(g.dmax, device="cuda")[None, :] < deg[:, None]
    idx = nbr[slots].contiguous()                  # the step's real slots
    lib, ker = gather_probe.measure(ext, idx, depth=None)
    if not ker["matches_torch"]:
        raise AssertionError("row_gather differs on the step's own rows")
    del ext, idx, slots
    packed_rollout(nbr, deg, sp, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed_rollout(nbr, deg, sp, reps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "host_ms_per_step": host_ms,
            "plan": packed_cuda.launch_plan(W),
            "gather_ms": ker["ms"], "index_select_ms": lib["ms"],
            "gather_bound_ms": ker["bound_ms"],
            **step_bound(g, W, fast=fast)}


def phase_headline_main_path(g, nbr, deg, sp) -> dict:
    """The headline rollout through ``packed_rollout``: 3 warm-up steps,
    then 20 timed steps; the 20-step result is held against the plain
    version."""
    packed_rollout(nbr, deg, sp, 3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = packed_rollout(nbr, deg, sp, 20)
    end.record()
    torch.cuda.synchronize()
    rollout_ms = start.elapsed_time(end) / 20
    if out.shape != sp.shape or out.dtype != torch.int32:
        raise AssertionError(f"rollout output {out.shape} {out.dtype}")
    ref = packed_rollout_plain(nbr, deg, sp, 20)
    if not torch.equal(out, ref):
        raise AssertionError("headline 20-step rollout differs from plain")
    del out, ref
    torch.cuda.empty_cache()
    return {"rollout_ms_per_step": rollout_ms}


def _reference_rows() -> dict:
    """The JAX package's recorded config-3 sweep of graph seed 0."""
    with open(os.path.join(HERE, "er_consensus_r05.json")) as f:
        doc = json.load(f)
    (seed0,) = [ps for ps in doc["per_seed"] if ps["graph_seed"] == 0]
    return seed0


def phase_consensus_sweep(g, n_iso, nbr, deg) -> dict:
    ref = _reference_rows()
    if g.n != ref["n"] or n_iso != ref["isolates_removed"]:
        raise AssertionError(f"config-3 graph n={g.n}/{n_iso} != reference "
                             f"{ref['n']}/{ref['isolates_removed']}")
    t0 = time.perf_counter()
    rows = consensus_curve(g, CONFIG3_R, CONFIG3_M0, CONFIG3_MAX_STEPS,
                           chunk=CONFIG3_CHUNK, nbr_dev=nbr, deg_dev=deg,
                           graph_seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for row, r_ref in zip(rows, ref["rows"]):
        log(f"    m0={row['m0']}: consensus_fraction={row['consensus_fraction']} "
            f"(JAX reference {r_ref['consensus_fraction']}), "
            f"mean_steps={row['mean_steps_to_consensus']}, "
            f"mean|m_final|={row['mean_abs_m_final']}")
        if r_ref["m0"] != row["m0"]:
            raise AssertionError("reference grid mismatch")
        # the initial draws differ (torch.Generator vs jax.random), so the
        # fractions agree within binomial noise: 5 sigma of R draws, with
        # p kept one replica away from 0 and 1
        p = min(max(r_ref["consensus_fraction"], 1 / CONFIG3_R),
                1 - 1 / CONFIG3_R)
        tol = 5 * math.sqrt(p * (1 - p) / CONFIG3_R)
        if abs(row["consensus_fraction"] - r_ref["consensus_fraction"]) > tol:
            raise AssertionError(
                f"m0={row['m0']}: consensus fraction {row['consensus_fraction']}"
                f" vs reference {r_ref['consensus_fraction']} (tol {tol:.4f})")
        if not (0.0 <= row["mean_abs_m_final"] <= 1.0):
            raise AssertionError(f"mean_abs_m_final out of range: {row}")
    log(f"[4 consensus] config 3 (ER n={g.n}, c={CONFIG3_C}, R={CONFIG3_R}, "
        f"{len(rows)} m0 points, max_steps={CONFIG3_MAX_STEPS}, "
        f"chunk={CONFIG3_CHUNK}): sweep wall {wall} s; fractions agree with "
        f"the JAX reference sweep")
    return {"sweep_wall_s": wall}


def phase_headline_point(g, nbr, deg) -> dict:
    t0 = time.perf_counter()
    row = consensus_point(g, HEADLINE_R, 0.3, 200, chunk=10, seed=2,
                          nbr_dev=nbr, deg_dev=deg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (0.0 <= row["consensus_fraction"] <= 1.0
            and 0.0 <= row["mean_abs_m_final"] <= 1.0
            and row["replicas"] == HEADLINE_R):
        raise AssertionError(f"headline consensus_point row out of range: {row}")
    log(f"[4 consensus] headline consensus_point (RRG d=3 n=10^6, R=16384, "
        f"m0=0.3, max_steps=200): {json.dumps(row)} in {wall:.3f} s")
    return {"point_wall_s": wall}


def phase_int8_crosscheck() -> None:
    """int8 run_dynamics on the card against packed_end_state on the card."""
    g = random_regular_graph(10**4, 3, seed=3)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    s = (2 * torch.randint(0, 2, (32, g.n), generator=gen, device="cuda")
         - 1).to(torch.int8)
    a = run_dynamics(g, s, 10, device="cuda")
    b = packed_end_state(g, s, 10, device="cuda")
    if not torch.equal(a, b):
        raise AssertionError("int8 run_dynamics != packed_end_state on the card")
    log("[5 path] int8 run_dynamics == unpacked packed_end_state "
        "(n=10^4, d=3, R=32, 10 steps), bit for bit")


# ---------------------------------------------------------------------------
# the fused annealer (K4)
# ---------------------------------------------------------------------------


def _sa_config(rule="majority", tie="stay") -> SAConfig:
    return SAConfig(dynamics=DynamicsConfig(p=1, c=1, rule=rule, tie=tie))


def _clone(st: FusedState) -> FusedState:
    return FusedState(*(t.clone() for t in st))


def _state_err(a: FusedState, b: FusedState) -> float:
    """max |a − b| over every field (0.0 when all are bit-identical)."""
    err = 0.0
    for x, y in zip(a, b):
        if torch.equal(x, y):
            continue
        if x.dtype == torch.float32:
            err = max(err, float((x.double() - y.double()).abs().max()))
        else:
            err = max(err, _max_abs_err(x.to(torch.int64), y.to(torch.int64)))
        err = max(err, 1.0)
    return err


def phase_breakdown(st0: FusedState, td, static, seed: int, steps: int) -> dict:
    """One traced launch of ``steps`` class steps from ``st0``: the mean
    microseconds per class step of the pass (ball end states and accepts of
    the class words, from the start of the step until the last block takes
    its ticket), the bookkeeping (the last block, per replica) and the grid
    barrier, from the kernel's global-timer stamps."""
    trace = torch.zeros((steps, 4), dtype=torch.int64, device="cuda")
    fused_cuda.fused_chunk_cuda(_clone(st0), seed, td, chunk_steps=steps,
                                trace=trace, **static)
    torch.cuda.synchronize()
    t = trace.cpu().double()
    d = (t[:, 1:] - t[:, :-1]) / 1e3
    return {"pass_us": float(d[:, 0].mean()),
            "bookkeeping_us": float(d[:, 1].mean()),
            "barrier_us": float(d[:, 2].mean()),
            "step_us": float((t[:, 3] - t[:, 0]).mean() / 1e3)}


def phase_fused_parity() -> float:
    """The fused kernel against its plain version on the card, bit for bit
    in every FusedState field: RRG d=3 (two rules; odd degree, no ties),
    RRG d=4 and ragged ER (the four (rule, tie) pairs), W in {1, 2, 3, 32,
    33} (the lane plan's 16 lanes per word, 8, and 1 with a class row in
    one warp or two), chunk_steps in {1, χ, χ+1, 3χ+1}, stop_on_first on
    and off, a betas ladder;
    the ghost row after every chunk; one chunk against the same steps split
    over two chunks; and one case at W=128, past the kernel's shared-memory
    staging of the per-replica vectors. Returns the max |kernel − plain|
    (0.0 when every case is bit-identical)."""
    t0 = time.perf_counter()
    small = {
        "rrg3": random_regular_graph(5000, 3, seed=1),
        "rrg4": random_regular_graph(4000, 4, seed=3),
        "er_ragged": erdos_renyi_graph(5000, 3.0 / 5000, seed=4),
    }
    pairs = {"rrg3": [("majority", "stay"), ("minority", "stay")],
             "rrg4": RULE_TIES, "er_ragged": RULE_TIES}
    # (W, chunk_steps as (multiple of chi, offset), stop_on_first, ladder,
    #  m_target)
    shapes = [(1, (0, 1), False, False, 1.0), (2, (1, 0), True, False, 0.3),
              (32, (3, 1), False, True, 0.4), (3, (1, 1), False, True, 1.0),
              (33, (1, 0), True, False, 0.5)]
    err, n_cases, stops = 0.0, 0, 0
    for name, g in small.items():
        for rule, tie in pairs[name]:
            cfg = _sa_config(rule, tie)
            tables = build_fused_tables(g, cfg, seed=0)
            for W, (mult, off), stop, ladder, m_target in shapes:
                R = 32 * W - 3                      # pad replicas present
                betas = [1.0 + 7.0 * r / max(R - 1, 1) for r in range(R)] \
                    if ladder else None
                st, td, static, _, _, _, _ = _assemble_fused(
                    g, cfg, n_replicas=R, seed=n_cases, m_target=m_target,
                    betas=betas, tables=tables, device=torch.device("cuda"))
                steps = mult * tables.chi + off
                kw = dict(chunk_steps=steps, stop_on_first=stop, **static)
                k = fused_chunk(_clone(st), n_cases, td, kernel="cuda", **kw)
                p = fused_chunk(_clone(st), n_cases, td, kernel="plain", **kw)
                torch.cuda.synchronize()
                e = _state_err(k, p)
                if e or bool(k.sp_ext[g.n].ne(0).any()):
                    raise AssertionError(
                        f"fused kernel != plain (or ghost row set): {name} "
                        f"{rule}/{tie} W={W} chunk_steps={steps} stop={stop} "
                        f"ladder={ladder}: max_abs_err={e}")
                stops += int(stop and int(k.steps) < steps)
                # the same steps split over two chunks
                if steps > 1:
                    s2 = fused_chunk(_clone(st), n_cases, td, kernel="cuda",
                                     **dict(kw, chunk_steps=steps // 2))
                    if not bool(s2.sp_ext[g.n].eq(0).all()):
                        raise AssertionError("ghost row set after a chunk")
                    s2 = fused_chunk(s2, n_cases, td, kernel="cuda",
                                     **dict(kw, chunk_steps=steps - steps // 2))
                    torch.cuda.synchronize()
                    if _state_err(s2, k):
                        raise AssertionError(
                            f"fused chunk of {steps} steps != two chunks: "
                            f"{name} {rule}/{tie} W={W}")
                err = max(err, e)
                n_cases += 1
    # W = 128: past the shared-memory staging of the per-replica vectors
    g, (rule, tie) = small["rrg4"], ("majority", "change")
    st, td, static, _, _, _, _ = _assemble_fused(
        g, _sa_config(rule, tie), n_replicas=32 * 128 - 5, seed=99,
        m_target=1.0, betas=None, tables=None, device=torch.device("cuda"))
    kw = dict(chunk_steps=9, stop_on_first=False, **static)
    e = _state_err(fused_chunk(_clone(st), 99, td, kernel="cuda", **kw),
                   fused_chunk(_clone(st), 99, td, kernel="plain", **kw))
    if e:
        raise AssertionError(f"fused kernel != plain at W=128: {e}")
    n_cases += 1
    torch.cuda.empty_cache()
    log(f"[7 fused parity] {n_cases} chunk cases ({stops} stopped on the first "
        f"passage) + split chunks + ghost row: kernel == plain bit for bit in "
        f"every FusedState field (max_abs_err {err}) in "
        f"{time.perf_counter() - t0:.3f} s")
    return err


def _load_config1_record() -> dict:
    with open(os.path.join(HERE, "fused_config1_ref.json")) as f:
        doc = json.load(f)
    if doc["config"]["n"] != CONFIG1["n"] or \
            doc["config"]["replicas"] != CONFIG1["replicas"]:
        raise AssertionError(f"config-1 record is for {doc['config']}")
    return doc["runs"]


def phase_config1_main_path() -> dict:
    """The fused main path: fused_anneal on the card at config 1, runs (a)
    and (b), with both launch counts set to 0 just before and read just
    after; wall clock per run."""
    g = random_regular_graph(CONFIG1["n"], CONFIG1["d"], seed=CONFIG1["seed"])
    cfg = _sa_config()
    results, walls = {}, {}
    packed_cuda.LAUNCHES = 0
    fused_cuda.LAUNCHES = 0
    for run, kw in CONFIG1_RUNS.items():
        t0 = time.perf_counter()
        res = fused_anneal(g, cfg, n_replicas=CONFIG1["replicas"],
                           seed=CONFIG1["seed"], device="cuda", **kw)
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t0
        results[run] = res
    launches = {"fused_chunk": fused_cuda.LAUNCHES,
                "packed_step": packed_cuda.LAUNCHES}
    if min(launches.values()) <= 0:
        raise AssertionError(f"config-1 runs did not go through both kernels: "
                             f"launches {launches}")
    for run, res in results.items():
        if res.kernel_used != "cuda" or res.s.shape != (CONFIG1["replicas"],
                                                        CONFIG1["n"]):
            raise AssertionError(f"config-1 run {run}: {res.kernel_used}, "
                                 f"{res.s.shape}")
        log(f"[8 config 1] fused_anneal run ({run}) {CONFIG1_RUNS[run]}: "
            f"{res.device_steps} class steps (chi={res.chi}), accepted "
            f"{res.accepted}, reached {int((res.steps_to_target >= 0).sum())}"
            f"/{CONFIG1['replicas']}, wall {walls[run]} s")
    log(f"[8 config 1] launches on the fused main path: {launches}")
    return {"results": results, "walls": walls, "launches": launches,
            "graph": g}


def phase_config1_check(main: dict) -> dict:
    """Each config-1 result against the JAX package's record under the
    near-tie rule (graphdyn_torch.search.reference); the divergent step, if
    any, is located by stepping the kernel one class step per launch."""
    ref = _load_config1_record()
    g, cfg = main["graph"], _sa_config()
    tables = build_fused_tables(g, cfg, seed=CONFIG1["seed"])
    verdicts = {}
    for run, res in main["results"].items():
        kw = CONFIG1_RUNS[run]
        st0, td, static, _, _, _, _ = _assemble_fused(
            g, cfg, n_replicas=CONFIG1["replicas"], seed=CONFIG1["seed"],
            m_target=kw["m_target"], betas=None, tables=tables,
            device=torch.device("cuda"))

        def step(st, td=td, static=static):
            return fused_chunk(_clone(st), CONFIG1["seed"], td, kernel="cuda",
                               chunk_steps=1, **static)

        v = hold_to_record(result_record(res), ref[run], step, st0,
                           CONFIG1["seed"], td, **static)
        verdicts[run] = v
        log(f"[8 config 1] run ({run}) against fused_config1_ref.json: "
            f"passed {v['how']}" + ("" if v["how"] == "bit-exact" else
                                    f" at class step {v['step']}: inverted "
                                    f"{v['inverted']}"))
    return verdicts


def phase_config1_timing(g) -> dict:
    """Run (b)'s 1600 class steps as one chunk: the kernel's ms per class
    step by CUDA events (3 repeats from the same state; each repeat's final
    state must be the record's), and the plain version's ms per class step
    over χ steps."""
    cfg = _sa_config()
    kw = CONFIG1_RUNS["b"]
    tables = build_fused_tables(g, cfg, seed=CONFIG1["seed"])
    st0, td, static, _, _, _, _ = _assemble_fused(
        g, cfg, n_replicas=CONFIG1["replicas"], seed=CONFIG1["seed"],
        m_target=kw["m_target"], betas=None, tables=tables,
        device=torch.device("cuda"))
    steps = kw["max_sweeps"] * tables.chi
    ref = _load_config1_record()["b"]["final_state"]
    times = []
    for _ in range(3):
        st = _clone(st0)
        fused_cuda.fused_chunk_cuda(st, CONFIG1["seed"], td, chunk_steps=1,
                                    **static)
        st = _clone(st0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_cuda.fused_chunk_cuda(st, CONFIG1["seed"], td,
                                    chunk_steps=steps, **static)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / steps)
        if run_record(st, tables.chrom.class_sizes) != ref:
            raise AssertionError(
                f"config 1 run (b) timed as one chunk of {steps} class steps "
                f"does not end in fused_config1_ref.json's final state")
    ms = min(times)
    st = _clone(st0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fused_chunk(st, CONFIG1["seed"], td, kernel="plain",
                chunk_steps=tables.chi, **static)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end) / tables.chi
    bound = class_step_bound(tables.chrom, 1)
    phases = phase_breakdown(st0, td, static, CONFIG1["seed"], 2 * tables.chi)
    log(f"[8 config 1] kernel {ms} ms per class step (min of {times}, one "
        f"chunk of {steps} steps, grid {fused_cuda.LAST_GRID_BLOCKS} blocks, "
        f"each ending in the record's final state); plain {plain_ms} ms per "
        f"class step; bound {bound['bound_ms']} ms ({bound['bound_by']}: "
        f"{bound['bytes']:.0f} B, {bound['int_ops']:.0f} int ops, "
        f"{bound['f32_ops']:.0f} f32 ops); phases over 2 sweeps (us per "
        f"class step): {phases}")
    return {"ms": ms, "ms_repeats": times, "plain_ms": plain_ms,
            "phases_us": phases, **bound}


def phase_fused_cli(main: dict) -> None:
    """``python -m graphdyn_torch fused --device cuda`` at its defaults,
    which are config 1 run (a): its JSON equals the run's result."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch", "fused", "--device", "cuda"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"fused CLI failed: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    res = main["results"]["a"]
    want = {"solver": "fused", "kernel": "cuda", "chi": res.chi,
            "sweeps": res.sweeps, "device_steps": res.device_steps,
            "accepted": res.accepted, "m_end": res.m_end.tolist(),
            "steps_to_target": res.steps_to_target.tolist(),
            "sweeps_to_target": res.sweeps_to_target.tolist(), "out": None}
    if doc != want:
        raise AssertionError(f"fused CLI output {doc} != run (a) {want}")
    log(f"[8 config 1] python -m graphdyn_torch fused --device cuda: equal to "
        f"run (a) in every key, {time.perf_counter() - t0:.3f} s wall")


def phase_fused_scale() -> dict:
    """Config 5's single-chip width: d=5 RRG, n=10⁶, R=1024 (W=32),
    majority/stay. Host set-up seconds; the kernel's ms per class step over
    2 sweeps by CUDA events, the peak device memory while timed and the
    bytes the launch itself allocates (its accumulators: no end-state
    scratch); the plain version's over χ steps; kernel == plain over one
    chunk of χ steps."""
    timers = {}
    cfg = _sa_config()
    t0 = time.perf_counter()
    g = random_regular_graph(SCALE_N, SCALE_D, seed=0)
    timers["graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g2 = graphs.power_graph(g, 2)
    timers["power_graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    colors = graphs.greedy_coloring(g2, seed=0)
    timers["coloring"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = build_fused_tables(g, cfg, seed=0, coloring=(g2, colors))
    timers["tables"] = time.perf_counter() - t0
    del g2
    t0 = time.perf_counter()
    st0, td, static, _, _, W, _ = _assemble_fused(
        g, cfg, n_replicas=SCALE_R, seed=0, m_target=1.0, betas=None,
        tables=tables, device=torch.device("cuda"))
    torch.cuda.synchronize()
    timers["state_and_upload"] = time.perf_counter() - t0
    chi = tables.chi
    log(f"[9 scale] RRG d={SCALE_D} n={SCALE_N} R={SCALE_R}: chi={chi}, class "
        f"sizes {tables.chrom.class_sizes.tolist()}; host set-up seconds "
        f"{timers}")
    # kernel: warm-up launch, then 2 sweeps in one chunk, each from a clone
    # made before the peak is reset, so the peak above what is held is what
    # the launch itself allocates
    fused_cuda.fused_chunk_cuda(_clone(st0), 0, td, chunk_steps=1, **static)
    times, launch_bytes = [], 0
    for _ in range(2):
        st = _clone(st0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_cuda.fused_chunk_cuda(st, 0, td, chunk_steps=2 * chi, **static)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (2 * chi))
        launch_bytes = max(launch_bytes,
                           torch.cuda.max_memory_allocated() - held)
    peak = torch.cuda.max_memory_allocated()
    grid = fused_cuda.LAST_GRID_BLOCKS
    del st
    phases = phase_breakdown(st0, td, static, 0, 2 * chi)
    # kernel == plain over one chunk of chi steps (the plain run is timed)
    k = fused_chunk(_clone(st0), 0, td, kernel="cuda", chunk_steps=chi,
                    **static)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p = fused_chunk(_clone(st0), 0, td, kernel="plain", chunk_steps=chi,
                    **static)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end) / chi
    err = _state_err(k, p)
    if err:
        raise AssertionError(f"scale shape: kernel != plain over {chi} steps "
                             f"(max_abs_err {err})")
    bound = class_step_bound(tables.chrom, W)
    ms = min(times)
    log(f"[9 scale] kernel {ms} ms per class step (min of {times}, 2 sweeps "
        f"in one chunk, grid {grid} blocks); plain {plain_ms} ms per class "
        f"step over {chi} steps; kernel == plain over {chi} steps; bound "
        f"{bound['bound_ms']} ms ({bound['bound_by']}: {bound['bytes']:.0f} B "
        f"= {bound['bytes_ms']} ms, {bound['int_ops']:.0f} int ops = "
        f"{bound['int_ms']} ms, {bound['f32_ops']:.0f} f32 ops = "
        f"{bound['f32_ms']} ms); phases over 2 sweeps (us per class "
        f"step): {phases}; peak device memory {peak} B while timed, of "
        f"which the launch allocated {launch_bytes} B (a [2, n+1, W] "
        f"end-state scratch would add {8 * (SCALE_N + 1) * W} B)")
    del k, p, st0, td
    torch.cuda.empty_cache()
    return {"ms": ms, "ms_repeats": times, "plain_ms": plain_ms,
            "max_abs_err": err, "setup_s": timers, "chi": chi,
            "grid_blocks": grid, "phases_us": phases, "peak_bytes": peak,
            "launch_bytes": launch_bytes, **bound}


# ---------------------------------------------------------------------------
# the BDCM kernels (the per-class update K3, the sweep K3′) and the HPr path
# ---------------------------------------------------------------------------


def _contract_inputs(G, Ed, d, T, dtype, per_group, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    K, M = 2**T, (d + 1) ** T

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda", dtype=dtype)

    a = rand(G, K, K, M) if per_group else rand(K, K, M)
    ci = rand(G, Ed, d, K, K)
    if d > 40:
        # column sums Σ_k chi[s, k, x_i] near 1, so the product of d of them
        # stays inside float32 (U(0, 1) entries sum to ~K/2 a step: 2^170
        # at d = 170, T = 2, past float32's range, in the plain version too)
        ci *= 2.0 / K
    return ci, a, rand(G, Ed, K, K)


def _contract_err(k, p, dtype) -> tuple[float, float]:
    """(max abs, max rel) of kernel output ``k`` against plain ``p``;
    raises when any element is not finite or outside ``atol + rtol·|p|``
    (the tolerance of :data:`CONTRACT_TOL`)."""
    rtol, atol = CONTRACT_TOL[dtype]
    diff = (k - p).abs()
    if not bool(torch.isfinite(k).all()):
        raise AssertionError("dp_contract: kernel output not finite")
    bad = int((diff > atol + rtol * p.abs()).sum())
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / p.abs().clamp_min(torch.finfo(dtype).tiny)).max()) \
        if diff.numel() else 0.0
    if bad:
        raise AssertionError(f"dp_contract: {bad} elements outside rtol {rtol},"
                             f" atol {atol}: max abs {abs_err}, rel {rel_err}")
    return abs_err, rel_err


def phase_contract_parity() -> dict:
    """The BDCM kernel against its plain version on the card: the (d, T)
    of :data:`CONTRACT_PAIRS` (each printed with the gate's verdict and its
    launch plan; every pair must be admitted), f32 and f64, the shared and
    the per-group factor, G ∈ {1, 5}, Ed ∈ {1, 129, 10⁵} (10⁵ for lattices
    up to :data:`CONTRACT_BIG_M`), eps_clamp ∈ {0, 1e-12}; then the
    kernel's ms per launch at each pair's largest case (shared factor,
    CUDA events around 20 queued launches) beside its bound and the plain
    version's (one call). Returns the max abs and rel errors per dtype and
    the timings."""
    t0 = time.perf_counter()
    errs = {torch.float32: [0.0, 0.0], torch.float64: [0.0, 0.0]}
    timings = {}
    n_cases, seed = 0, 0
    for d, T in CONTRACT_PAIRS:
        for dtype in (torch.float32, torch.float64):
            plan = bdcm_cuda.launch_plan(d, T, dtype)
            admitted = bdcm_cuda.bdcm_kernel_supported(d, T, dtype)
            log(f"[11 contract parity] d={d} T={T} {str(dtype)[6:]}: "
                f"{'admitted' if admitted else 'refused'}, plan {plan}")
            if not admitted:
                raise AssertionError(f"the gate refuses d={d} T={T} {dtype}")
            cases = [(1, 1, 0.0), (5, 129, 1e-12)]
            if (d + 1) ** T <= CONTRACT_BIG_M:
                cases += [(1, 10**5, 1e-12), (5, 10**5, 0.0)]
            if (d + 1) ** T > CONTRACT_HUGE_M:
                cases = [(1, 1, 0.0), (2, 3, 1e-12)]
            for per_group in (False, True):
                for G, Ed, eps in cases:
                    seed += 1
                    ci, a, co = _contract_inputs(G, Ed, d, T, dtype,
                                                 per_group, seed)
                    kw = dict(d=d, T=T, damp=0.4, eps_clamp=eps)
                    k = dp_contract_grouped(ci, a, co, kernel="cuda", **kw)
                    p = dp_contract_grouped(ci, a, co, kernel="plain", **kw)
                    torch.cuda.synchronize()
                    e_abs, e_rel = _contract_err(k, p, dtype)
                    errs[dtype][0] = max(errs[dtype][0], e_abs)
                    errs[dtype][1] = max(errs[dtype][1], e_rel)
                    n_cases += 1
                    del ci, a, co, k, p
            G, Ed = cases[-1][:2]
            ci, a, co = _contract_inputs(G, Ed, d, T, dtype, False, seed)
            ms = _cuda_ms(lambda: dp_contract_grouped(
                ci, a, co, kernel="cuda", d=d, T=T, damp=0.4), 20, lead_ms=20)
            plain_ms = _cuda_ms(lambda: dp_contract_grouped(
                ci, a, co, kernel="plain", d=d, T=T, damp=0.4), 1, lead_ms=20)
            bound = contract_bound(G, Ed, d, T, dtype)
            timings[f"d={d} T={T} {str(dtype)[6:]}"] = {
                "path": plan["path"], "G": G, "Ed": Ed, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"]}
            log(f"[11 contract timing] d={d} T={T} {str(dtype)[6:]} "
                f"({plan['path']} path, G={G}, Ed={Ed}): kernel {ms} ms/launch,"
                f" plain {plain_ms} ms, bound {bound['bound_ms']} ms "
                f"({bound['bound_by']})")
            del ci, a, co
    torch.cuda.empty_cache()
    out = {str(dt)[6:]: {"max_abs_err": e[0], "max_rel_err": e[1]}
           for dt, e in errs.items()}
    log(f"[11 contract parity] {n_cases} cases within rtol/atol "
        f"{ {str(k)[6:]: v for k, v in CONTRACT_TOL.items()} }: {out} in "
        f"{time.perf_counter() - t0:.3f} s")
    return out, timings


def profile_breakdown(run, label: str, top: int = 10) -> dict:
    """Run ``run()`` once under ``torch.profiler`` (CPU and CUDA activity)
    and report the device time by kernel: the ``top`` kernels by self
    device time, their share of the device total, and the device's busy
    share of the wall time under the profiler (the profiler slows the host,
    so the idle share it shows is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def incl_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                  if e.key.startswith("aten::") and incl_us(e) > 0),
                 key=lambda e: -incl_us(e))[:top]

    rows = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
            if dev_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    out = {"device_us": total, "wall_us": wall_us,
           "busy_share": total / wall_us if wall_us else 0.0,
           "top": [{"kernel": k[:90], "us": us, "share": us / total if total
                    else 0.0, "count": c} for k, us, c in rows[:top]]}
    log(f"[profile] {label}: device {total:.0f} us of {wall_us:.0f} us wall "
        f"under the profiler (busy share {out['busy_share']:.3f}); top "
        f"kernels by device time:")
    for r in out["top"]:
        log(f"    {r['us']:12.1f} us {r['share']:6.3f} x{r['count']:<6d} "
            f"{r['kernel']}")
    out["ops"] = [{"op": e.key, "shapes": str(e.input_shapes)[:120],
                   "us": incl_us(e), "count": e.count} for e in ops]
    log(f"[profile] {label}: top PyTorch ops by device time (inclusive, by "
        f"input shape):")
    for r in out["ops"]:
        log(f"    {r['us']:12.1f} us x{r['count']:<6d} {r['op']} {r['shapes']}")
    return out


# the per-class kernel's count read at the end of every HPr and entropy
# main-path window (each must be 0)
_PER_CLASS_ON_MAIN_PATHS: list[int] = []


def _reset_bdcm_counts() -> None:
    bdcm_cuda.LAUNCHES = 0
    bdcm_sweep.LAUNCHES = 0


def _bdcm_counts(what: str, sweeps: int) -> int:
    """Read the counts after one run of an HPr or entropy main path: the
    sweep kernel launched exactly ``sweeps`` times, the sweeps the run's own
    result says it ran (:func:`_hpr_clock`, :func:`_ladder_sweeps`), and
    the per-class kernel not at all."""
    launches = bdcm_sweep.LAUNCHES
    _PER_CLASS_ON_MAIN_PATHS.append(bdcm_cuda.LAUNCHES)
    if launches <= 0 or launches != sweeps:
        raise AssertionError(f"{what}: bdcm_sweep launches {launches}, the "
                             f"run's sweeps {sweeps}")
    if bdcm_cuda.LAUNCHES:
        raise AssertionError(f"{what}: dp_contract launched "
                             f"{bdcm_cuda.LAUNCHES} times on the main path")
    return launches


def _ladder_sweeps(cells, group_size: int = 1) -> int:
    """The sweeps an entropy ladder runs, from its result's sweep counts
    per λ (``cells``: one sequence per cell, in the order the run takes
    them): a fixed point runs whole chunks of ``CHUNK_SWEEPS`` sweeps until
    it stops, so a cell's ladder takes the sum of its ⌈sweeps / CHUNK⌉
    chunks; a group of cells (``run_cell_ladder``, every lane swept in each
    chunk) runs until its slowest cell's ladder ends, and groups of
    ``group_size`` consecutive cells run one after another."""
    chunks = [sum(-(-int(t) // CHUNK_SWEEPS) for t in np.ravel(c))
              for c in cells]
    G = max(int(group_size), 1)
    return CHUNK_SWEEPS * sum(max(chunks[i:i + G])
                              for i in range(0, len(chunks), G))


def _grid_sweeps(res, group_size: int | None) -> int:
    """:func:`_ladder_sweeps` of an ``entropy_grid`` result: its cells in
    (degree, repetition) order, ``group_size`` None meaning the function's
    default (min(cells, 8)) and 0 the serial loop."""
    cells = [res.sweeps[di, rep] for di in range(res.sweeps.shape[0])
             for rep in range(res.sweeps.shape[1])]
    G = min(len(cells), 8) if group_size is None else group_size
    return _ladder_sweeps(cells, G)


@contextlib.contextmanager
def _grid_results():
    """Collect the ``(result, group_size)`` of every ``entropy_grid`` call
    made inside (the CLI's own call included), for their sweep counts."""
    got = []
    inner = entropy_models.entropy_grid

    def grid(*args, **kwargs):
        res = inner(*args, **kwargs)
        got.append((res, kwargs.get("group_size")))
        return res

    entropy_models.entropy_grid = grid
    try:
        yield got
    finally:
        entropy_models.entropy_grid = inner


def _hpr_clock(num_steps, TT: int, chunk: int = 200) -> int:
    """The sweeps an HPr group runs: whole chunks until its last chain
    stops (HPRGroupExec.run), at most TT + 2."""
    return min(-(-int(np.max(num_steps)) // chunk) * chunk, TT + 2)


def _class_tables(plan):
    return [(i.long().reshape(plan.G, -1), e.long().reshape(plan.G, -1, d))
            for i, e, d in zip(plan.idx, plan.in_edges, plan.class_ds)]


def per_class_sweep(chi, a_tilted, bias, valid, plan, tables, *, damp, eps_clamp):
    """The sweep as one launch per class would run it, composed here for
    timing only (the package has no switch for it): per class PyTorch's
    gathers of the
    inputs and of the bias (built per sweep from the node biases), the mask
    multiply, the per-class kernel ``dp_contract_cuda`` and
    ``index_copy_``."""
    G, rows, K = chi.shape[0], chi.shape[1], chi.shape[2]
    new = chi.reshape(G * rows, K, K).clone()
    if isinstance(bias, NodeBias):
        bias = _edge_bias(plan, bias.values)
    elif bias is not None:
        bias = bias.reshape(G * rows, K)
    for (d, a), (idx, ie) in zip(zip(plan.class_ds, a_tilted), tables):
        chi_in = new[ie]
        if bias is not None:
            chi_in *= bias[ie][..., None]
        if plan.masked:
            chi_in *= valid[:, None]
        upd = bdcm_cuda.dp_contract_cuda(chi_in, a, new[idx], d=d, T=plan.T,
                                         damp=damp, eps_clamp=eps_clamp)
        del chi_in
        new.index_copy_(0, idx.reshape(-1), upd.reshape(-1, K, K))
    return new.reshape(G, rows, K, K)


def phase_sweep(label: str, chi, a_tilted, bias, valid, plan, spec, *,
                reps: int, per_class_reps: int, plain_reps: int,
                lead_ms: float = 150.0) -> dict:
    """One shape of the BDCM sweep kernel (outside any count window): one
    sweep through the kernel against the plain route (``_sweep_core`` on
    the same CUDA tensors) within :data:`CONTRACT_TOL` on every row a class
    updates, the kernel's rows in no class equal to the input, the plain
    twin ``sweep_plain`` equal to the plain route on the updated rows, and
    the per-class route's difference from the kernel; then ms per sweep by
    CUDA events for the kernel, the per-class route and the plain route (the lead of
    device sleep covers the host's issue of the queued calls), beside
    :func:`sweep_bound`."""
    kw = dict(damp=spec.damp, eps_clamp=spec.eps_clamp)
    plain_spec = spec._replace(modes=("plain",) * len(spec.modes))
    tabs = _class_tables(plan)
    plain_tables = SweepTables(
        tabs, None if plan.src is None else plan.src.long(),
        None if plan.src is None else _sel_plus(plan, chi.device))

    def kernel():
        return bdcm_sweep.sweep_cuda(chi, a_tilted, bias, plan, **kw)

    def plain():
        return _sweep_core(chi, a_tilted, bias, valid, plain_tables,
                           plain_spec)

    def per_class():
        return per_class_sweep(chi, a_tilted, bias, valid, plan, tabs, **kw)

    K = chi.shape[2]
    owned = plan.cid.long() != bdcm_sweep.NO_CLASS

    def rows_of(t):
        return t.reshape(-1, K, K)[owned]

    k, p = rows_of(kernel()), rows_of(plain())
    err = _contract_err(k, p, chi.dtype)
    if not torch.equal(rows_of(bdcm_sweep.sweep_plain(chi, a_tilted, bias,
                                                      plan, **kw)), p):
        raise AssertionError(f"{label}: sweep_plain differs from the plain "
                             f"route")
    del p
    r4 = rows_of(per_class())
    per_class_equal = bool(torch.equal(k, r4))
    per_class_err = float((k - r4).abs().max()) if k.numel() else 0.0
    del k, r4
    pr = plan.pass_rows.long()
    if not torch.equal(kernel().reshape(-1, K, K)[pr],
                       chi.reshape(-1, K, K)[pr]):
        raise AssertionError(f"{label}: rows in no class not passed through")
    if isinstance(bias, NodeBias):
        # the per-row form of the same weights reads the same values
        per_row = _edge_bias(plan, bias.values).reshape(plan.G, plan.rows, K)
        if not torch.equal(
                bdcm_sweep.sweep_cuda(chi, a_tilted, per_row, plan, **kw),
                kernel()):
            raise AssertionError(f"{label}: per-row bias != node bias")
        del per_row
    ms = _cuda_ms(kernel, reps, lead_ms=lead_ms)
    per_class_ms = _cuda_ms(per_class, per_class_reps, lead_ms=lead_ms)
    plain_ms = _cuda_ms(plain, plain_reps, lead_ms=lead_ms)
    bound = sweep_bound(plan, a_tilted, bias)
    torch.cuda.empty_cache()
    out = {"G": plan.G, "rows": plan.rows, "classes": list(plan.class_ds),
           "paths": list(plan.paths), "threads": plan.threads,
           "smem": plan.smem, "ms": ms, "per_class_ms": per_class_ms,
           "plain_ms": plain_ms, "max_abs_err": err[0], "max_rel_err": err[1],
           "per_class_bit_equal": per_class_equal, "per_class_max_abs_diff": per_class_err, **bound}
    log(f"[sweep] {label} ({str(chi.dtype)[6:]}, G={plan.G}, rows "
        f"{plan.rows}, classes {list(plan.class_ds)} on {list(plan.paths)}, "
        f"{plan.threads} threads, {plan.smem} B shared): kernel {ms} ms/sweep, "
        f"per-class route {per_class_ms} ms/sweep, plain {plain_ms} ms/sweep, bound "
        f"{bound['bound_ms']} ms ({bound['bound_by']}: {bound['bytes']} B, "
        f"{bound['flops']} flops); kernel == plain within tolerance (abs "
        f"{err[0]}, rel {err[1]}); per-class route bit-equal {per_class_equal} (max "
        f"diff {per_class_err})")
    return out


def _check_end_state(g, s, what: str) -> None:
    """A chain that reached m_final = 1.0 flows to all +1 under the port's
    end_state."""
    out = end_state(g, s, 1, 1, device="cuda").cpu().numpy()
    if not np.all(out == 1):
        raise AssertionError(f"{what}: m_final 1.0 but end_state is not all +1")


def phase_hpr_ref() -> dict:
    """The CUDA path held to ``hpr_ref.json`` (the JAX package's 3 sweeps at
    the reference shape, f32 and f64) at rtol 1e-4 (f32) and 1e-9 (f64)."""
    with open(os.path.join(HERE, "hpr_ref.json")) as f:
        ref = json.load(f)["records"]
    out = {}
    for dtype, rtol, atol in (("float32", 1e-4, 1e-7), ("float64", 1e-9, 1e-12)):
        got = port_ref_record(dtype, kernel="cuda", device="cuda")
        out[dtype] = hold_to_ref_record(got, ref[dtype], rtol, atol)
    log(f"[12 hpr ref] the CUDA path holds to hpr_ref.json: max rel err "
        f"{out} (rtol 1e-4 f32, 1e-9 f64)")
    return out


def _class_launch_inputs(chi, bias_edge, idx, in_edges):
    """One class's kernel inputs from a state, as the per-class route
    forms them."""
    chi_in = chi[in_edges]
    chi_in *= bias_edge[in_edges][..., None]
    return chi_in, chi[idx]


def _sel_plus(plan, device):
    """bool [K]: the source trajectories whose node bias is column 0."""
    return torch.as_tensor([(plan.bias_cols >> k) & 1 == 0
                            for k in range(2**plan.T)], device=device)


def _edge_bias(plan, biases):
    """The per-edge bias ``[rows, K]`` the per-class route builds from the
    node biases (the per-class kernel takes it gathered)."""
    src = plan.src.long()
    return torch.where(_sel_plus(plan, biases.device), biases[src, 0, None],
                       biases[src, 1, None])


def phase_hpr_ref_timing() -> dict:
    """At the reference shape (RRG d=4, n=10⁴, one class D=3), f32 and f64:
    the G=1 executor's ms per sweep by CUDA events over 200 sweeps
    (host-issued: a host loop of PyTorch ops, so this is the rate the chain
    runs at); the sweep kernel per sweep beside the per-class route and the plain
    route (:func:`phase_sweep`, with the node bias); and the per-class
    kernel per launch against its plain version and bound."""
    g = random_regular_graph(HPR_N, HPR_D, seed=0)
    out = {}
    for dtype in ("float32", "float64"):
        cfg = HPRConfig(dtype=dtype)
        data = BDCMData(g, dtype=dtype)
        ex = HPRGroupExec([(g, data)], cfg, kernel="cuda", device="cuda")
        chi0, b0, s0 = ref_init(g.n, data.num_directed, data.K, data.np_dtype)
        st = ex.init_state([chi0], [b0], [s0], [0])
        st = ex.advance(st, 3)                      # warm up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st = ex.advance(st, 203)
        end.record()
        torch.cuda.synchronize()
        sweep_ms = start.elapsed_time(end) / 200
        if dtype == "float32":
            holder = [st]

            def fifty():
                holder[0] = ex.advance(holder[0], holder[0].t + 50)

            profile_breakdown(fifty,
                              "reference shape, 50 sweeps of the G=1 executor")
            st = holder[0]
        plan = ex.tables
        bias = NodeBias(st.biases.reshape(-1, 2))
        sweep = phase_sweep(f"HPr reference shape {dtype}", st.chi,
                            ex.a_tilted, bias, None, plan, ex.sweep_spec,
                            reps=500, per_class_reps=200, plain_reps=20)
        K = data.K
        (idx, in_edges), = _class_tables(plan)
        chi_in, chi_old = _class_launch_inputs(
            st.chi.reshape(-1, K, K), _edge_bias(plan, bias.values), idx,
            in_edges)
        d = ex.spec.class_ds[0]
        kw = dict(d=d, T=data.T, damp=cfg.damp, eps_clamp=0.0)
        a = ex.a_tilted[0]
        k = dp_contract_grouped(chi_in, a, chi_old, kernel="cuda", **kw)
        p = dp_contract_grouped(chi_in, a, chi_old, kernel="plain", **kw)
        torch.cuda.synchronize()
        err = _contract_err(k, p, data.dtype)
        # the lead covers the host's issue of every timed call (about 60 µs
        # per kernel call, 1 ms per plain call of ~40 ops), and the calls fit
        # the launch queue, so the events read device time, not the host's
        # issue rate
        ms = _cuda_ms(lambda: dp_contract_grouped(chi_in, a, chi_old,
                                                  kernel="cuda", **kw),
                      500, lead_ms=150)
        plain_ms = _cuda_ms(lambda: dp_contract_grouped(chi_in, a, chi_old,
                                                        kernel="plain", **kw),
                            20, lead_ms=150)
        bound = contract_bound(1, chi_in.shape[1], d, data.T, data.dtype)
        out[dtype] = {"ms": ms, "plain_ms": plain_ms, "sweep_ms": sweep_ms,
                      "max_abs_err": err[0], "max_rel_err": err[1], **bound,
                      "bdcm_sweep": sweep}
        log(f"[12 hpr ref] reference shape {dtype} (Ed={chi_in.shape[1]}, "
            f"d={d}): per-class kernel {ms} ms/launch, plain {plain_ms} "
            f"ms/launch, bound {bound['bound_ms']} ms ({bound['bound_by']}); "
            f"kernel == plain within tolerance (abs {err[0]}, rel {err[1]}); "
            f"G=1 executor {sweep_ms} ms/sweep by CUDA events over 200 sweeps")
        del ex, st, chi_in, chi_old, k, p
    torch.cuda.empty_cache()
    return out


def phase_hpr_main() -> dict:
    """The HPr main path at the reference shape (RRG d=4, n=10⁴, p=c=1,
    TT=10⁴), each run with the BDCM counts set to 0 just before and read
    just after: (a) ``python -m graphdyn_torch hpr --device cuda`` at its
    defaults (in process, through ``cli.main``), (b) ``hpr_ensemble(n_rep=4,
    group_size=4)``, the G=4 grid, (c) ``hpr_solve`` in float64."""
    out = {}
    g = random_regular_graph(HPR_N, HPR_D, seed=0)
    TT = HPRConfig().max_sweeps
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "hpr.npz")
        _reset_bdcm_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["hpr", "--device", "cuda", "--out", npz])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"hpr CLI returned {rc}")
        doc = json.loads(buf.getvalue().strip().splitlines()[-1])
        launches = _bdcm_counts("hpr CLI (reference shape)",
                                _hpr_clock(doc["num_steps"], TT))
        with np.load(npz) as f:
            conf = f["conf"][0]
    sweeps = doc["num_steps"][0]
    m_final = 1.0 if sweeps <= TT else 2.0
    if set(doc) != {"solver", "mag_reached", "num_steps", "time", "out"}:
        raise AssertionError(f"hpr CLI keys {sorted(doc)}")
    if m_final == 1.0:
        _check_end_state(g, conf, "hpr CLI")
    out["cli"] = {"sweeps": sweeps, "m_final": m_final, "wall_s": wall,
                  "ms_per_sweep": wall * 1e3 / max(sweeps, 1),
                  "mag_reached": doc["mag_reached"][0], "launches": launches}
    log(f"[13 hpr main] python -m graphdyn_torch hpr --device cuda: {sweeps} "
        f"sweeps, m_final {m_final}, mag_reached {doc['mag_reached'][0]}, wall "
        f"{wall:.3f} s = {out['cli']['ms_per_sweep']:.4f} ms/sweep (host "
        f"clock, set-up included); bdcm_sweep launches (one per sweep) {launches}")

    _reset_bdcm_counts()
    t0 = time.perf_counter()
    ens = hpr_ensemble(HPR_N, HPR_D, HPRConfig(), n_rep=4, group_size=4,
                       device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _bdcm_counts("hpr_ensemble(n_rep=4, group_size=4)",
                            _hpr_clock(ens.num_steps, TT))
    for k in range(4):
        if ens.num_steps[k] <= TT:
            _check_end_state(random_regular_graph(HPR_N, HPR_D, seed=k),
                             ens.conf[k], f"ensemble rep {k}")
    out["group4"] = {"sweeps": ens.num_steps.tolist(), "wall_s": wall,
                     "ms_per_sweep": wall * 1e3 / max(int(ens.num_steps.max()), 1),
                     "launches": launches}
    log(f"[13 hpr main] hpr_ensemble(n_rep=4, group_size=4): sweeps "
        f"{ens.num_steps.tolist()}, mag {ens.mag_reached.tolist()}, wall "
        f"{wall:.3f} s = {out['group4']['ms_per_sweep']:.4f} ms per group "
        f"sweep; bdcm_sweep launches (one per sweep) {launches}")

    _reset_bdcm_counts()
    t0 = time.perf_counter()
    res = hpr_solve(g, HPRConfig(dtype="float64"), seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _bdcm_counts("hpr_solve(float64)",
                            _hpr_clock(res.num_steps, TT))
    if res.chi.dtype != np.float64 or res.m_final not in (1.0, 2.0):
        raise AssertionError(f"hpr_solve f64: {res.chi.dtype}, {res.m_final}")
    if res.m_final == 1.0:
        _check_end_state(g, res.s, "hpr_solve f64")
    out["f64"] = {"sweeps": res.num_steps, "m_final": res.m_final,
                  "wall_s": wall, "ms_per_sweep": wall * 1e3 / max(res.num_steps, 1),
                  "launches": launches}
    # the uninterrupted runs that phase 43 holds its resumed runs to (the
    # CLI's float64 run is this hpr_solve: repetition 0, seed 0)
    out["oracles"] = {"float32": {"conf": conf, "num_steps": sweeps},
                      "float64": {"conf": res.s, "num_steps": res.num_steps}}
    log(f"[13 hpr main] hpr_solve float64: {res.num_steps} sweeps, m_final "
        f"{res.m_final}, wall {wall:.3f} s; bdcm_sweep launches (one per sweep) {launches}")
    out["launches"] = sum(out[k]["launches"] for k in ("cli", "group4", "f64"))
    return out


def phase_hpr_chains() -> dict:
    """On RRG(200, 4) in float64 with the port's stream: the kernel path's
    chain against the plain path's, under the near-tie rule
    (graphdyn_torch.models.hpr_reference)."""
    g = random_regular_graph(200, 4, seed=0)
    cfg = HPRConfig(dtype="float64")
    t0 = time.perf_counter()
    rk = hpr_solve(g, cfg, seed=0, kernel="cuda", device="cuda")
    rp = hpr_solve(g, cfg, seed=0, kernel="plain", device="cuda")
    wall = time.perf_counter() - t0
    if (np.array_equal(rk.s, rp.s) and rk.num_steps == rp.num_steps
            and rk.m_final == rp.m_final):
        verdict = {"how": "equal", "sweeps": rk.num_steps,
                   "m_final": rk.m_final}
    else:
        data = BDCMData(g, dtype="float64")
        exs = {k: HPRGroupExec([(g, data)], cfg, kernel=k, device="cuda")
               for k in ("cuda", "plain")}
        chi0, b0, s0 = host_init(np.random.default_rng(0), data.num_directed,
                                 data.K, g.n, np.float64)
        sts ={k: ex.init_state([chi0], [b0], [s0], [0])
               for k, ex in exs.items()}
        hit = walk_to_divergence(
            lambda st: exs["cuda"].advance(st, st.t + 1),
            lambda st: exs["plain"].advance(st, st.t + 1),
            port_fields, port_fields, sts["cuda"], sts["plain"],
            cfg.max_sweeps + 2)
        if hit is None:
            raise AssertionError("kernel and plain chains differ in their "
                                 "results but in no sweep")
        prev, _, st_p = hit
        u = hpr_uniforms(prev.seeds, prev.t, prev.t + 1, g.n, torch.float64)[0]
        _, b_p, s_p, _ = port_fields(st_p)
        verdict = near_tie_replay(exs["plain"], prev, u.cpu().numpy(), b_p, s_p,
                                  eps_dtype=np.float64)
    if rk.m_final == 1.0:
        _check_end_state(g, rk.s, "kernel chain")
    log(f"[14 hpr chains] RRG(200, 4) float64, port stream: kernel chain "
        f"({rk.num_steps} sweeps, m_final {rk.m_final}) vs plain chain "
        f"({rp.num_steps}, {rp.m_final}): passed, {verdict['how']} "
        f"({verdict}); {wall:.3f} s")
    return verdict


def phase_config2_setup_timing() -> dict:
    """Config 2 (``BASELINE.md:30``: d=3 RRG n=10⁵, 256 replicas) built
    step by step: host set-up seconds per part (graph, edge tables, device
    union, numpy init draw, upload); ms per sweep by CUDA events over
    ``CONFIG2_SWEEPS`` sweeps of the chunk program; the kernel's ms per
    launch (CUDA events, 5 launches) against its bound and the plain
    version's (row-chunked, one launch), and kernel == plain on that
    launch."""
    timers = {}
    cfg = HPRConfig(max_sweeps=CONFIG2_SWEEPS)
    t0 = time.perf_counter()
    g = random_regular_graph(CONFIG2_N, CONFIG2_D, seed=0)
    timers["graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = build_edge_tables(g)
    timers["edge_tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_chunk, setup = make_hpr_batch_chunk(g, cfg, CONFIG2_R, device="cuda")
    torch.cuda.synchronize()
    timers["device_union"] = time.perf_counter() - t0
    R, n, twoE, K = CONFIG2_R, g.n, tables.num_directed, setup.data.K
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    chi0, b0, s0 = host_init(rng, R * twoE, K, R * n, np.float32,
                             chi0=_draw_union_chi(rng, R, twoE, K, np.float32))
    timers["init_draw"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = _BatchState(
        chi=torch.from_numpy(chi0).to("cuda"),
        biases=torch.from_numpy(b0).to("cuda"),
        s=torch.from_numpy(s0).to("cuda"),
        seeds=torch.arange(R, dtype=torch.int64, device="cuda"), t=0,
        m_final=torch.zeros(R, dtype=torch.float32, device="cuda"),
        active=torch.ones(R, dtype=torch.bool, device="cuda"),
        steps=torch.zeros(R, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    timers["upload"] = time.perf_counter() - t0
    del chi0, b0, s0
    log(f"[15 config 2] RRG d={CONFIG2_D} n={CONFIG2_N} R={R} (union "
        f"Ed={R * twoE}): host set-up seconds {timers}")
    st = run_chunk(st, 1)                           # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    st = run_chunk(st, CONFIG2_SWEEPS)
    end.record()
    torch.cuda.synchronize()
    sweep_ms = start.elapsed_time(end) / (CONFIG2_SWEEPS - 1)
    holder = [st._replace(t=CONFIG2_SWEEPS - 2)]

    def one_sweep():
        holder[0] = run_chunk(holder[0], CONFIG2_SWEEPS - 1)

    profile = profile_breakdown(one_sweep, "config 2, one sweep")
    st = holder[0]
    plan, As, _ = setup.sweep.args
    a_t = tilted_factors(As, torch.as_tensor(setup.data.x0, dtype=torch.float32,
                                             device="cuda"), setup.lmbd)
    bsweep = phase_sweep("HPr config 2", st.chi[None], a_t,
                         NodeBias(st.biases), None, plan, setup.sweep.spec,
                         reps=5, per_class_reps=2, plain_reps=1, lead_ms=20)
    del a_t, plan, As
    # one per-class launch at this shape, from the state
    data = setup.data
    (cls,) = data.edge_classes
    idx, in_edges = cls.idx.long(), cls.in_edges.long()
    chi_in, chi_old = _class_launch_inputs(st.chi, setup.bias_to_edge(st.biases),
                                           idx, in_edges)
    del st
    a = (torch.as_tensor(cls.A, dtype=torch.float32, device="cuda")
         * torch.exp(-setup.lmbd * torch.as_tensor(data.x0, dtype=torch.float32,
                                                   device="cuda"))[:, None, None])
    kw = dict(d=cls.d, T=data.T, damp=cfg.damp, eps_clamp=0.0)
    k = dp_contract(chi_in, a, chi_old, kernel="cuda", **kw)
    ms = _cuda_ms(lambda: dp_contract(chi_in, a, chi_old, kernel="cuda", **kw), 5)
    start.record()
    p = dp_contract(chi_in, a, chi_old, kernel="plain", **kw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = _contract_err(k, p, torch.float32)
    bound = contract_bound(1, chi_in.shape[0], cls.d, data.T, torch.float32)
    del chi_in, chi_old, k, p, setup, run_chunk
    torch.cuda.empty_cache()
    log(f"[15 config 2] {sweep_ms} ms/sweep by CUDA events over "
        f"{CONFIG2_SWEEPS - 1} sweeps; kernel {ms} ms/launch (bound "
        f"{bound['bound_ms']} ms, {bound['bound_by']}: {bound['bytes']} B, "
        f"{bound['flops']} flops; {bound['bound_ms'] / ms:.3f} of it), plain "
        f"{plain_ms} ms/launch (row-chunked); kernel == plain within tolerance "
        f"(abs {err[0]}, rel {err[1]})")
    return {"setup_s": timers, "sweep_ms": sweep_ms, "ms": ms,
            "plain_ms": plain_ms, "max_abs_err": err[0], "max_rel_err": err[1],
            "profile": profile, **bound, "bdcm_sweep": bsweep}


def phase_config2_main() -> dict:
    """Config 2 through the entry points, the counts set to 0 before each:
    ``hpr_solve_batch`` (peak device memory printed) and the CLI
    ``hpr --batch-replicas 256 --n 100000 --d 3 --max-sweeps 20``, whose
    JSON must equal the entry point's result."""
    g = random_regular_graph(CONFIG2_N, CONFIG2_D, seed=0)
    cfg = HPRConfig(max_sweeps=CONFIG2_SWEEPS)
    torch.cuda.reset_peak_memory_stats()
    _reset_bdcm_counts()
    t0 = time.perf_counter()
    res = hpr_solve_batch(g, cfg, n_replicas=CONFIG2_R, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _bdcm_counts("hpr_solve_batch (config 2)",
                            _hpr_clock(res.num_steps, CONFIG2_SWEEPS))
    peak = torch.cuda.max_memory_allocated()
    if (res.s.shape != (CONFIG2_R, CONFIG2_N)
            or not np.all(np.isin(res.m_final, (1.0, 2.0)))
            or not np.all(np.abs(res.mag_reached) <= 1.0)):
        raise AssertionError(f"config 2 result out of range: {res.m_final}")
    log(f"[15 config 2] hpr_solve_batch: wall {wall:.3f} s, sweeps "
        f"{sorted(set(res.num_steps.tolist()))}, m_final "
        f"{sorted(set(res.m_final.tolist()))}, mean mag "
        f"{float(res.mag_reached.mean())}; peak device memory {peak} B; "
        f"bdcm_sweep launches (one per sweep) {launches}")
    _reset_bdcm_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["hpr", "--batch-replicas", str(CONFIG2_R), "--n",
                       str(CONFIG2_N), "--d", str(CONFIG2_D), "--max-sweeps",
                       str(CONFIG2_SWEEPS), "--device", "cuda"])
    wall_cli = time.perf_counter() - t0
    launches_cli = _bdcm_counts("hpr CLI (config 2)",
                                _hpr_clock(res.num_steps, CONFIG2_SWEEPS))
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or doc["num_steps"] != res.num_steps.tolist() \
            or doc["m_final"] != res.m_final.tolist():
        raise AssertionError("config-2 CLI result differs from hpr_solve_batch")
    log(f"[15 config 2] python -m graphdyn_torch hpr --batch-replicas 256 --n "
        f"100000 --d 3 --max-sweeps 20: equal to hpr_solve_batch, wall "
        f"{wall_cli:.3f} s; bdcm_sweep launches (one per sweep) {launches_cli}")
    torch.cuda.empty_cache()
    return {"wall_s": wall, "cli_wall_s": wall_cli, "peak_bytes": peak,
            "launches_batch": launches, "launches_cli": launches_cli,
            "launches": launches + launches_cli}


# ---------------------------------------------------------------------------
# the row gather (P) and its probe
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the BDCM kernels past T = 4 and past a block's shared memory
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _plain_chunks(nbytes: int = 4 << 30):
    """The plain reference's row chunks raised from 256 MB to ``nbytes``
    inside (fewer, larger launches on the card); a row's result does not
    depend on the chunk
    (``tests/test_torch_bdcm.py::test_plain_contract_rows_independent_of_
    group_and_chunk``)."""
    from graphdyn_torch.ops import packed

    old = packed._TEMP_BYTES
    packed._TEMP_BYTES = nbytes
    try:
        yield
    finally:
        packed._TEMP_BYTES = old


def _sweep_vs_plain(label: str, chi, a_tilted, bias, valid, plan, spec):
    """One sweep of ``chi`` through the kernel against the plain route on
    the same CUDA tensors, within :data:`CONTRACT_TOL` on every row a class
    updates; returns ``(kernel output, (abs err, rel err))``."""
    plain_spec = spec._replace(modes=("plain",) * len(spec.modes))
    plain_tables = SweepTables(
        _class_tables(plan), None if plan.src is None else plan.src.long(),
        None if plan.src is None else _sel_plus(plan, chi.device))
    K = chi.shape[2]
    owned = plan.cid.long() != bdcm_sweep.NO_CLASS
    k = bdcm_sweep.sweep_cuda(chi, a_tilted, bias, plan, damp=spec.damp,
                              eps_clamp=spec.eps_clamp)
    p = _sweep_core(chi, a_tilted, bias, valid, plain_tables, plain_spec)
    try:
        err = _contract_err(k.reshape(-1, K, K)[owned],
                            p.reshape(-1, K, K)[owned], chi.dtype)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None
    return k, err


def phase_hpr_t5() -> dict:
    """HPr at T = 5: ``python -m graphdyn_torch hpr --device cuda --p 4 --c
    1`` on RRG d=4, n=10⁴ (its other defaults, the sweeps cut to
    :data:`HPR_T5_SWEEPS`) in float32 and float64, with the BDCM counts set
    to 0 just before and read just after (K3′ launches = the sweeps); then
    the first 3 sweeps of a chain from the CLI's init, each held against
    the plain sweep of the same state, and ms per sweep beside
    :func:`sweep_bound` (:func:`phase_sweep`)."""
    g = random_regular_graph(HPR_N, HPR_D, seed=0)
    out = {}
    for dtype in ("float32", "float64"):
        _reset_bdcm_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["hpr", "--device", "cuda", "--p", "4", "--c", "1",
                           "--max-sweeps", str(HPR_T5_SWEEPS), "--dtype",
                           dtype])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"hpr CLI --p 4 --c 1 returned {rc}")
        doc = json.loads(buf.getvalue().strip().splitlines()[-1])
        launches = _bdcm_counts(f"hpr CLI --p 4 --c 1 {dtype}",
                                _hpr_clock(doc["num_steps"], HPR_T5_SWEEPS))
        cfg = HPRConfig(dynamics=DynamicsConfig(p=4, c=1), dtype=dtype,
                        max_sweeps=HPR_T5_SWEEPS)
        data = BDCMData(g, dtype=dtype, p=4, c=1)
        ex = HPRGroupExec([(g, data)], cfg, kernel="cuda", device="cuda")
        chi0, b0, s0 = host_init(np.random.default_rng(0), data.num_directed,
                                 data.K, g.n, data.np_dtype)
        st = ex.init_state([chi0], [b0], [s0], [0])
        label = f"HPr T=5 {dtype}"
        errs = []
        with _plain_chunks():
            for t in range(3):
                bias = NodeBias(st.biases.reshape(-1, 2))
                errs.append(_sweep_vs_plain(f"{label} sweep {t}", st.chi,
                                            ex.a_tilted, bias, None,
                                            ex.tables, ex.sweep_spec)[1])
                st = ex.advance(st, st.t + 1)
            timing = phase_sweep(label, st.chi, ex.a_tilted,
                                 NodeBias(st.biases.reshape(-1, 2)), None,
                                 ex.tables, ex.sweep_spec, reps=10,
                                 per_class_reps=3, plain_reps=1)
        out[dtype] = {"cli_sweeps": doc["num_steps"][0], "cli_wall_s": wall,
                      "launches": launches, "first_sweeps_err": errs,
                      "bdcm_sweep": timing}
        log(f"[32 hpr T=5] python -m graphdyn_torch hpr --device cuda --p 4 "
            f"--c 1 --max-sweeps {HPR_T5_SWEEPS} --dtype {dtype}: "
            f"{doc['num_steps'][0]} sweeps, mag_reached "
            f"{doc['mag_reached'][0]}, wall {wall:.3f} s; bdcm_sweep launches "
            f"(one per sweep) {launches}; the first 3 sweeps against plain "
            f"(abs, rel): {errs}; K3' {timing['ms']} ms/sweep, bound "
            f"{timing['bound_ms']} ms ({timing['bound_by']}), paths "
            f"{timing['paths']}")
        del ex, st
        torch.cuda.empty_cache()
    return out


def phase_sweep_t6() -> dict:
    """T = 6 (p=5, c=1) on RRG(10³, 3): one class, d=2, M=729, K=64, the
    block path; in float32 and float64 the first :data:`T6_SWEEPS` sweeps
    each held against the plain sweep, ms per sweep beside the bound
    (:func:`phase_sweep`), then ``make_sweep``'s sweep run
    :data:`T6_SWEEPS` times with the count set to 0 just before: one launch
    per sweep."""
    g = random_regular_graph(T6_N, 3, seed=0)
    out = {}
    for dt in ("float32", "float64"):
        data = BDCMData(g, dtype=dt, p=5, c=1)
        sweep = make_sweep(data, damp=0.1, eps_clamp=0.0, device="cuda")
        chi = data.init_messages(0).to("cuda")
        c, a_t, valid, plan, spec = _entropy_sweep_inputs(sweep, chi, 0.5,
                                                          data.x0)
        label = f"T=6 RRG(1000, 3) {dt}"
        errs, x = [], c
        with _plain_chunks():
            for t in range(T6_SWEEPS):
                x, err = _sweep_vs_plain(f"{label} sweep {t}", x, a_t, None,
                                         valid, plan, spec)
                errs.append(err)
            res = phase_sweep(label, c, a_t, None, valid, plan, spec,
                              reps=20, per_class_reps=5, plain_reps=1)
        bdcm_sweep.LAUNCHES = 0
        y = chi
        for _ in range(T6_SWEEPS):
            y = sweep(y, 0.5)
        torch.cuda.synchronize()
        res["launches"] = bdcm_sweep.LAUNCHES
        if res["launches"] != T6_SWEEPS or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{label}: {res['launches']} launches for "
                                 f"{T6_SWEEPS} sweeps (or a value not "
                                 f"finite)")
        res["first_sweeps_err"] = errs
        log(f"[33 T=6] {label}: make_sweep's sweep x{T6_SWEEPS} = "
            f"{res['launches']} launches; the first {T6_SWEEPS} sweeps "
            f"against plain (abs, rel): {errs}")
        out[dt] = res
    return out


def phase_entropy_global() -> dict:
    """The global-lattice path at T = 4: ER(2000, 6/1999) (config 3's law)
    at p=3, c=1, in float32 and float64. Its classes and their paths are
    logged, and at least one hub class must take ``'global'`` (d ≥ 13 in
    f32, ≥ 10 in f64); the first 3 sweeps of ``make_sweep`` at λ=0.5 each
    held against the plain sweep, ms per sweep beside the bound
    (:func:`phase_sweep`); then ``entropy_sweep`` at λ ∈ {0, 1, 2, 3} with
    one chunk of :data:`GLOBAL_MAX_SWEEPS` sweeps per λ (its fixed-point
    tolerance loosened to 1, which every damped sweep's delta is under, so
    the ladder visits each λ: the sweep count is cut, not the width),
    counted (K3′ launches = the sweeps), every value finite, and its first
    λ held against the plain ladder's on the card: φ, m_init and ent1
    within 1e-9 (f64) / 1e-4 (f32), the same sweeps (the plain ladder at
    λ = 0 only: a plain sweep of this graph takes 1.2 s in f32, 2 s in
    f64 on an H100, and a chunk is 16 of them)."""
    g = erdos_renyi_graph(GLOBAL_N, GLOBAL_C / (GLOBAL_N - 1),
                          seed=GLOBAL_SEED)
    sub, _ = graphs.remove_isolates(g)
    lambdas = np.array([0.0, 1.0, 2.0, 3.0])
    out = {}
    for dt, atol in (("float32", 1e-4), ("float64", 1e-9)):
        label = f"ER(2000, 6) T=4 {dt}"
        data = BDCMData(sub, dtype=dt, p=3, c=1)
        classes = _class_report(data, label)
        if not any(c["path"] == "global" for c in classes):
            raise AssertionError(f"{label}: no class took the global path: "
                                 f"{classes}")
        sweep = make_sweep(data, damp=0.1, eps_clamp=0.0, device="cuda")
        chi = data.init_messages(0).to("cuda")
        c, a_t, valid, plan, spec = _entropy_sweep_inputs(sweep, chi, 0.5,
                                                          data.x0)
        errs, x = [], c
        with _plain_chunks():
            for t in range(3):
                x, err = _sweep_vs_plain(f"{label} sweep {t}", x, a_t, None,
                                         valid, plan, spec)
                errs.append(err)
            timing = phase_sweep(label, c, a_t, None, valid, plan, spec,
                                 reps=5, per_class_reps=2, plain_reps=1)
        del x
        cfg = EntropyConfig(dynamics=DynamicsConfig(p=3, c=1), eps=1.0,
                            max_sweeps=GLOBAL_MAX_SWEEPS, dtype=dt)
        _reset_bdcm_counts()
        t0 = time.perf_counter()
        res = entropy_sweep(g, cfg, seed=GLOBAL_SEED, lambdas=lambdas,
                            device="cuda")
        wall = time.perf_counter() - t0
        launches = _bdcm_counts(f"entropy_sweep {label}",
                                _ladder_sweeps([res.sweeps]))
        t0 = time.perf_counter()
        with _plain_chunks():
            res_p = entropy_sweep(g, cfg, seed=GLOBAL_SEED,
                                  lambdas=lambdas[:1], kernel="plain",
                                  device="cuda")
        plain_wall = time.perf_counter() - t0
        got, want = eref.curve_record(res), eref.curve_record(res_p)
        if (got["lambdas"] != lambdas.tolist()
                or got["sweeps"][:1] != want["sweeps"]):
            raise AssertionError(f"{label}: kernel ladder {got} vs plain "
                                 f"{want}")
        phi_err = 0.0
        for f in eref.CURVE_FIELDS:
            a, b = np.asarray(got[f]), np.asarray(want[f])
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"{label}: {f} not finite: {a}")
            phi_err = max(phi_err, float(np.abs(a[:1] - b).max()))
        if phi_err > atol:
            raise AssertionError(f"{label}: the curve is {phi_err} off the "
                                 f"plain ladder's (atol {atol})")
        out[dt] = {"classes": classes, "first_sweeps_err": errs,
                   "bdcm_sweep": timing, "launches": launches,
                   "wall_s": wall, "plain_wall_s": plain_wall,
                   "lambdas": got["lambdas"], "sweeps": got["sweeps"],
                   "curve_err": phi_err}
        log(f"[34 entropy global] entropy_sweep {label}, λ "
            f"{got['lambdas']} of {lambdas.tolist()}, one chunk each: sweeps "
            f"{got['sweeps']}, wall {wall:.3f} s (the plain ladder at λ=0 "
            f"{plain_wall:.3f} s), bdcm_sweep launches (one per sweep) "
            f"{launches}; φ, m_init, ent1 at λ=0 within {phi_err} of the "
            f"plain ladder's (atol {atol}); the first 3 sweeps against plain "
            f"(abs, rel): {errs}")
        torch.cuda.empty_cache()
    return out


def phase_t7_refused() -> None:
    """A T = 7 plan raises on the card, with its reason, before any
    launch."""
    for dt in (torch.float32, torch.float64):
        try:
            bdcm_sweep.launch_shape((2,), 7, dt)
        except ValueError as e:
            if "T <= 6" not in str(e):
                raise
            log(f"[35 T=7] launch_shape((2,), 7, {dt}) raises: {e}")
        else:
            raise AssertionError("a T = 7 plan was admitted")


def phase_gather_parity() -> dict:
    """The row-gather kernel against ``index_select``, bit for bit: W in
    :data:`GATHER_PARITY_WIDTHS` (single words and 16-byte vectors, one warp
    per row and several rows per warp), n_idx in {1, 255, 1000, 100003} (not
    multiples of 256, a last tile part full), indices drawn with repeats
    from a small source, words with the top bit set (every bit pattern is
    drawn), a source whose rows are not 16-byte aligned, the plan's depth
    and every other depth the kernel takes."""
    t0 = time.perf_counter()
    n_cases, seed = 0, 0

    def case(src, idx, depth):
        nonlocal n_cases
        got = gather_cuda.row_gather_cuda(src, idx, depth=depth)
        want = row_gather_plain(src, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(
                f"row_gather: {bad} words differ from index_select at W="
                f"{src.shape[1]}, n_idx={idx.shape[0]}, depth={depth}")
        n_cases += 1

    for W in GATHER_PARITY_WIDTHS:
        for n_src, n_idx in ((7, 1), (50, 255), (1000, 1000), (4099, 100003)):
            seed += 1
            src, idx = gather_probe.draw(n_src, n_idx, W, seed, "cuda")
            if n_src < n_idx and int(torch.unique(idx).numel()) == n_idx:
                raise AssertionError("the parity draw has no repeated index")
            if not bool((src < 0).any()):
                raise AssertionError("the parity draw has no top-bit word")
            for depth in (None,) + gather_cuda.DEPTHS:
                case(src, idx, depth)
        # rows that start 4 bytes past a 16-byte boundary: single words
        flat = torch.empty(1000 * W + 1, dtype=torch.int32, device="cuda")
        flat.random_(-2**31, 2**31)
        src = flat[1:].view(1000, W)
        idx = torch.randint(0, 1000, (777,), dtype=torch.int32, device="cuda")
        case(src, idx, None)
    dt = time.perf_counter() - t0
    log(f"[16 gather parity] row_gather == index_select bit for bit in "
        f"{n_cases} cases (W in {GATHER_PARITY_WIDTHS}, n_idx in {{1, 255, "
        f"1000, 100003}}, repeated indices, top-bit words, unaligned rows, "
        f"the plan's depth and depths {gather_cuda.DEPTHS}) in {dt:.3f} s")
    return {"cases": n_cases, "max_abs_err": 0.0}


def phase_gather_probe() -> dict:
    """P's main path, counted: the probe's ``main()`` at its defaults (n_src
    10⁶, W in {128, 512, 1024}, n_idx = 3·10⁶·128/W), in process, with the
    launch count set to 0 just before and read just after; every line must
    match ``index_select``. Then the port's own row widths at the shapes
    their main paths gather (:data:`GATHER_PORT_SHAPES`), each timed beside
    ``index_select`` and the byte bound."""
    gather_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gather_probe.main([])
    wall = time.perf_counter() - t0
    launches = gather_cuda.LAUNCHES
    if rc != 0 or launches <= 0:
        raise AssertionError(f"gather probe: rc {rc}, row_gather launches "
                             f"{launches}")
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    if len(rows) != 6 or not all(r["matches_torch"] for r in rows):
        raise AssertionError(f"gather probe lines: {rows}")
    for r in rows:
        log(f"[17 gather probe] {r['impl']:18s} W={r['W']:5d} n_idx="
            f"{r['n_idx']} ({r['n_distinct']} distinct): {r['ms']} ms, {r['rows_per_s']:.4e} rows/s, "
            f"{r['GBps']:.2f} GB/s, {r['bound_share']:.4f} of the "
            f"{r['bound_ms']} ms byte bound")
    log(f"[17 gather probe] python -m graphdyn_torch.scripts.gather_probe: "
        f"wall {wall:.3f} s; row_gather launches {launches}")
    port = {}
    for label, n_src, W, n_idx in GATHER_PORT_SHAPES:
        src, idx = gather_probe.draw(n_src, n_idx, W, 0, "cuda")
        lib, ker = gather_probe.measure(src, idx, depth=None)
        if not ker["matches_torch"]:
            raise AssertionError(f"row_gather differs at {label}")
        port[label] = {"W": W, "n_src": n_src, "n_idx": n_idx,
                       "n_distinct": ker["n_distinct"], "ms": ker["ms"], "library_ms": lib["ms"],
                       "bound_ms": ker["bound_ms"],
                       "rows_per_s": ker["rows_per_s"],
                       "library_rows_per_s": lib["rows_per_s"],
                       "GBps": ker["GBps"], "library_GBps": lib["GBps"],
                       "bound_share": ker["bound_share"],
                       "library_bound_share": lib["bound_share"]}
        log(f"[17 gather port widths] {label} (n_src={n_src}, W={W}, n_idx="
            f"{n_idx}, {ker['n_distinct']} distinct): kernel {ker['ms']} ms ({ker['rows_per_s']:.4e} rows/s,"
            f" {ker['GBps']:.2f} GB/s, {ker['bound_share']:.4f} of the bound "
            f"{ker['bound_ms']} ms); index_select {lib['ms']} ms "
            f"({lib['rows_per_s']:.4e} rows/s, {lib['bound_share']:.4f})")
        del src, idx
        torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "wall_s": wall, "port": port}


# ---------------------------------------------------------------------------
# the entropy λ-ladders (the sweep kernel on the entropy path)
# ---------------------------------------------------------------------------


def _class_report(data: BDCMData, label: str) -> list:
    """Every edge class of ``data``: its (d, Ed), the kernel's verdict and
    its launch plan; every class must be admitted."""
    out = []
    for cls in data.edge_classes:
        plan = bdcm_cuda.launch_plan(cls.d, data.T, data.dtype)
        if not bdcm_cuda.bdcm_kernel_supported(cls.d, data.T, data.dtype):
            raise AssertionError(f"{label}: the kernel refuses d={cls.d}")
        out.append({"d": cls.d, "Ed": int(cls.idx.shape[0]),
                    "path": plan["path"]})
    log(f"[18 entropy classes] {label} (T={data.T}, {str(data.dtype)[6:]}): "
        f"{out}")
    return out


def _class_timings(data: BDCMData, label: str, lmbd: float) -> list:
    """Each edge class of ``data`` launched alone at its own size with the
    shared factor at ``lmbd`` on random row-normalised inputs: the kernel's
    ms per launch (CUDA events over 20 queued launches), the plain
    version's (one call) and the bound; kernel == plain within the stated
    tolerance."""
    out = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    dt, T, K = data.dtype, data.T, data.K
    tilt = tilt_vector(lmbd, data.x0, dt).to("cuda")
    for cls in data.edge_classes:
        d, Ed = cls.d, int(cls.idx.shape[0])
        a = torch.as_tensor(cls.A, dtype=dt, device="cuda") * tilt[:, None, None]
        ci = torch.rand((1, Ed, d, K, K), generator=gen, device="cuda",
                        dtype=dt)
        co = torch.rand((1, Ed, K, K), generator=gen, device="cuda", dtype=dt)
        kw = dict(d=d, T=T, damp=0.1, eps_clamp=0.0)
        k = dp_contract_grouped(ci, a, co, kernel="cuda", **kw)
        p = dp_contract_grouped(ci, a, co, kernel="plain", **kw)
        torch.cuda.synchronize()
        err = _contract_err(k, p, dt)
        ms = _cuda_ms(lambda: dp_contract_grouped(ci, a, co, kernel="cuda",
                                                  **kw), 20, lead_ms=20)
        plain_ms = _cuda_ms(lambda: dp_contract_grouped(
            ci, a, co, kernel="plain", **kw), 1, lead_ms=20)
        bound = contract_bound(1, Ed, d, T, dt)
        row = {"d": d, "Ed": Ed, "M": (d + 1) ** T,
               "path": bdcm_cuda.launch_plan(d, T, dt)["path"], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
               "bound_by": bound["bound_by"], "max_abs_err": err[0],
               "max_rel_err": err[1]}
        out.append(row)
        log(f"[18 entropy classes] {label} d={d} Ed={Ed} ({row['path']} "
            f"path): kernel {ms} ms/launch, plain {plain_ms} ms, bound "
            f"{bound['bound_ms']} ms ({bound['bound_by']}); kernel == plain "
            f"within tolerance (abs {err[0]}, rel {err[1]})")
        del ci, co, k, p
    torch.cuda.empty_cache()
    return out


def _entropy_sweep_inputs(sweep, chi, lmbd: float, x0):
    """(chi[None], the shared factors at ``lmbd``, valid, plan, spec) of a
    :func:`make_sweep`-built entropy sweep."""
    plan, As, valid = sweep.args
    a_t = tilted_factors(As, torch.as_tensor(x0, dtype=valid.dtype,
                                             device="cuda"), lmbd)
    return chi[None], a_t, valid, plan, sweep.spec


def phase_sweep_entropy(ref: dict) -> dict:
    """The BDCM sweep kernel on the entropy path's shapes
    (:func:`phase_sweep`: parity with the plain route, then ms per sweep
    beside the per-class route and the plain route): config 4's union (f32, 8
    classes, register and block paths, leaf rows passed through), the same
    union padded with ghost rows (class_bucket 32), the congruent ensemble
    (64 × RRG(1000, 3), G=64), the golden instance (f64, the per-group
    factor at G=1) and a grid of 8 ER(300) cells at 8 λ (G=8, per-group
    factor, ghost rows)."""
    out = {}
    subs = [graphs.remove_isolates(g)[0] for g in _config4_graphs()]
    union = graphs.disjoint_union(subs)[0]
    for label, bucket, reps in (("config 4 union", None, 200),
                                ("config 4 union, padded", 32, 20)):
        data = BDCMData(union, class_bucket=bucket)
        sweep = make_sweep(data, damp=0.1, eps_clamp=0.0, device="cuda")
        chi = data.init_messages(0).to("cuda")
        if bucket:
            K = data.K
            chi = torch.cat([chi, chi.new_full((1, K, K), 1.0 / (K * K))])
        c, a_t, valid, plan, spec = _entropy_sweep_inputs(sweep, chi, 0.5,
                                                          data.x0)
        out[label] = phase_sweep(label, c, a_t, None, valid, plan, spec,
                                 reps=reps, per_class_reps=max(reps // 4, 2),
                                 plain_reps=3)
    gs = [random_regular_graph(CONFIG4_N, 3, seed=k) for k in range(CONFIG4_G)]
    ens = EnsembleBDCM([BDCMData(g) for g in gs])
    sweep = make_ensemble_sweep(ens, damp=0.1, device="cuda")
    plan, As, valid = sweep.args
    a_t = tilted_factors(As, torch.as_tensor(ens.x0, dtype=ens.dtype,
                                             device="cuda"), 0.5)
    out["congruent ensemble"] = phase_sweep(
        "congruent ensemble", ens.init_messages(0).to("cuda"), a_t, None,
        valid, plan, sweep.spec, reps=200, per_class_reps=50, plain_reps=3)
    g = eref.golden_graph(ref)
    sub, n_iso = graphs.remove_isolates(g)
    data = BDCMData(sub, dtype="float64")
    ex = EntropyCellExec([(data, g.n, n_iso)], eref.golden_config(),
                         device="cuda")
    out["golden"] = phase_sweep(
        "golden instance", ex.stack_chi([data.init_messages(0)]),
        ex.factors([0.5]), None, ex.valid, ex.tables, ex.spec, reps=200,
        per_class_reps=50, plain_reps=3)
    gg = GROUPED_GRID
    cells = []
    for k, deg in enumerate(gg["deg"] * 3):
        sub, n_iso = graphs.remove_isolates(erdos_renyi_graph(
            gg["n"], deg / (gg["n"] - 1), seed=k))
        cells.append((BDCMData(sub, class_bucket=64), gg["n"], n_iso))
    cells = cells[:8]
    ex = EntropyCellExec(cells, EntropyConfig(), device="cuda")
    out["grid G=8"] = phase_sweep(
        "entropy grid, 8 cells", ex.stack_chi(
            [c[0].init_messages(k) for k, c in enumerate(cells)]),
        ex.factors([0.1 * k for k in range(8)]), None, ex.valid, ex.tables,
        ex.spec, reps=100, per_class_reps=25, plain_reps=3)
    return out


def _caterpillar(degrees):
    """A tree of hubs in a path, hub k of degree ``degrees[k]`` (leaves make
    up the rest), from the port's ``graph_from_edges``: one BDCM edge class
    per hub degree (d = degree − 1)."""
    H = len(degrees)
    edges = [(k, k + 1) for k in range(H - 1)]
    n = H
    for k, D in enumerate(degrees):
        for _ in range(D - (k > 0) - (k < H - 1)):
            edges.append((k, n))
            n += 1
    return graphs.graph_from_edges(n, np.array(edges))


def phase_sweep_many_classes() -> dict:
    """The sweep kernel past the 64 classes it once took: a caterpillar
    whose hubs have the degrees MANY_CLASS_DEGREES (80 edge classes, d = 1
    to 80, register and block paths) at T=2, in float32 and float64, each
    held to the plain route within :data:`CONTRACT_TOL` and timed
    (:func:`phase_sweep`); then the package's sweep (``make_sweep``) run
    MANY_CLASS_SWEEPS times with the kernel's count set to 0 just before:
    one launch per sweep."""
    g = _caterpillar(MANY_CLASS_DEGREES)
    out = {}
    for dt in ("float32", "float64"):
        data = BDCMData(g, dtype=dt)
        sweep = make_sweep(data, damp=0.1, eps_clamp=0.0, device="cuda")
        if len(sweep.spec.class_ds) <= 64:
            raise AssertionError(f"many-class graph has only "
                                 f"{len(sweep.spec.class_ds)} classes")
        chi = data.init_messages(0).to("cuda")
        c, a_t, valid, plan, spec = _entropy_sweep_inputs(sweep, chi, 0.5,
                                                          data.x0)
        label = f"{len(plan.class_ds)} classes ({dt})"
        res = phase_sweep(label, c, a_t, None, valid, plan, spec, reps=20,
                          per_class_reps=3, plain_reps=2)
        bdcm_sweep.LAUNCHES = 0
        x = chi
        for _ in range(MANY_CLASS_SWEEPS):
            x = sweep(x, 0.5)
        torch.cuda.synchronize()
        res["launches"] = bdcm_sweep.LAUNCHES
        if res["launches"] != MANY_CLASS_SWEEPS or not bool(
                torch.isfinite(x).all()):
            raise AssertionError(f"{label}: {res['launches']} launches for "
                                 f"{MANY_CLASS_SWEEPS} sweeps (or a value "
                                 f"not finite)")
        log(f"[sweep] {label}: make_sweep's sweep x{MANY_CLASS_SWEEPS} = "
            f"{res['launches']} launches of the sweep kernel")
        out[label] = res
    return out


def phase_entropy_golden(ref: dict) -> dict:
    """``entropy_sweep`` in float64 over λ = 0..0.9 on the golden instance
    (rebuilt from the record's edges): the ten notebook triples within 5e-3,
    the JAX package's curve within 1e-9 (sweep counts under the near-tie
    rule), the sweep kernel's launches counted (one per sweep, none of the
    per-class kernel); then its classes timed one by one through the
    per-class kernel."""
    g = eref.golden_graph(ref)
    _reset_bdcm_counts()
    t0 = time.perf_counter()
    res = entropy_sweep(g, eref.golden_config(), seed=eref.GOLDEN_SEED,
                        device="cuda")
    wall = time.perf_counter() - t0
    launches = _bdcm_counts("entropy_sweep (golden instance, f64)",
                            _ladder_sweeps([res.sweeps]))
    tri = eref.hold_golden_triples(res)
    held = eref.hold_curve(eref.curve_record(res), ref["golden"]["float64"],
                           atol=1e-9, eps=1e-6)
    log(f"[18 entropy golden] entropy_sweep float64 on the seed-9425 "
        f"instance (n={g.n}, {g.num_edges} edges): sweeps "
        f"{res.sweeps.tolist()}, wall {wall:.3f} s; triples within {tri} "
        f"(<= 5e-3); entropy_ref.json held: {held}; bdcm_sweep launches "
        f"(one per sweep) {launches}")
    sub, _ = graphs.remove_isolates(g)
    data = BDCMData(sub, dtype="float64")
    classes = _class_report(data, "golden instance")
    timings = _class_timings(data, "golden instance", 0.5)
    return {"wall_s": wall, "sweeps": res.sweeps.tolist(), "launches":
            launches, "triples_err": tri, "ref": held, "classes": classes,
            "timings": timings}


def phase_entropy_union_ref(ref: dict) -> dict:
    """The reduced config-4 union of the record (4 × ER(300, 1.5/299), 8 λ,
    max_sweeps 400) through ``entropy_ensemble_union``: float64 within 1e-9
    under the near-tie rule, float32 within 1e-4 (sweep counts within 2);
    two float32 runs equal bit for bit."""
    out, launches = {}, 0
    for dtype, atol in (("float64", 1e-9), ("float32", 1e-4)):
        _reset_bdcm_counts()
        res = entropy_ensemble_union(eref.union_graphs(),
                                     eref.union_config(dtype),
                                     seed=eref.UNION_SHAPE["seed"],
                                     lambdas=eref.union_lambdas(),
                                     device="cuda")
        launches += _bdcm_counts(f"entropy_ensemble_union (reduced, {dtype})",
                                 _ladder_sweeps([res.sweeps]))
        got, want = eref.curve_record(res), ref["union"][dtype]
        if dtype == "float64":
            out[dtype] = eref.hold_curve(got, want, atol=atol, eps=1e-6)
        else:
            if (got["lambdas"] != want["lambdas"]
                    or got["nonconverged"] != want["nonconverged"]
                    or np.abs(np.subtract(got["sweeps"],
                                          want["sweeps"])).max() > 2):
                raise AssertionError(f"reduced union f32: {got} vs {want}")
            err = max(float(np.abs(np.subtract(got[f], want[f])).max())
                      for f in eref.CURVE_FIELDS)
            if err > atol:
                raise AssertionError(f"reduced union f32 off by {err}")
            out[dtype] = {"max_abs_err": err, "sweeps": got["sweeps"]}
            _reset_bdcm_counts()
            again = entropy_ensemble_union(eref.union_graphs(),
                                           eref.union_config(dtype),
                                           seed=eref.UNION_SHAPE["seed"],
                                           lambdas=eref.union_lambdas(),
                                           device="cuda")
            launches += _bdcm_counts("entropy_ensemble_union (again)",
                                     _ladder_sweeps([again.sweeps]))
            if not (np.array_equal(again.ent, res.ent)
                    and np.array_equal(again.m_init, res.m_init)):
                raise AssertionError("two union runs differ")
    log(f"[19 entropy union ref] reduced config-4 union held to "
        f"entropy_ref.json: {out}; a second float32 run equal bit for bit; "
        f"bdcm_sweep launches (one per sweep) {launches}")
    out["launches"] = launches
    return out


def phase_entropy_grouped() -> dict:
    """``entropy_grid`` on the card with group sizes 0 (serial), 3 and 8
    over a 9-cell grid (:data:`GROUPED_GRID`, cells stopping at different λ
    allowed): every result array equal bit for bit, through the kernel."""
    gg = GROUPED_GRID
    cfg = EntropyConfig(lmbd_max=gg["lmbd_max"], num_rep=gg["num_rep"])
    runs, launches = {}, 0
    for G in (0, 3, 8):
        _reset_bdcm_counts()
        t0 = time.perf_counter()
        runs[G] = entropy_grid(gg["n"], np.asarray(gg["deg"]), cfg, seed=0,
                               group_size=G, device="cuda")
        runs[f"wall{G}"] = time.perf_counter() - t0
        launches += _bdcm_counts(f"entropy_grid(group_size={G})",
                                 _grid_sweeps(runs[G], G))
    for G in (3, 8):
        for f in runs[0]._fields:
            if not np.array_equal(getattr(runs[G], f), getattr(runs[0], f)):
                raise AssertionError(f"grouped G={G} != serial in {f}")
    log(f"[20 entropy grouped] entropy_grid n={gg['n']} deg {gg['deg']} x "
        f"{gg['num_rep']} reps: group sizes 3 and 8 equal the serial loop "
        f"bit for bit (n_lambda {runs[0].n_lambda.tolist()}); walls serial "
        f"{runs['wall0']:.3f} s, G=3 {runs['wall3']:.3f} s, G=8 "
        f"{runs['wall8']:.3f} s; bdcm_sweep launches (one per sweep) {launches}")
    return {"launches": launches, "walls": {G: runs[f"wall{G}"]
                                            for G in (0, 3, 8)}}


def _config4_graphs():
    return [erdos_renyi_graph(CONFIG4_N, CONFIG4_C / (CONFIG4_N - 1), seed=k)
            for k in range(CONFIG4_G)]


def _config4_config() -> EntropyConfig:
    return EntropyConfig(max_sweeps=CONFIG4_MAX_SWEEPS)


def _config4_lambdas() -> np.ndarray:
    return np.linspace(0.0, CONFIG4_LMBD_MAX, CONFIG4_L)


def _ladder_report(res, wall: float, G: int) -> dict:
    curve = {"m_init": masked_mean(res.m_init, axis=1).tolist(),
             "ent1": masked_mean(res.ent1, axis=1).tolist()}
    return {"wall_s": wall, "lambdas": int(res.lambdas.size),
            "graph_lambda_points_per_s": res.lambdas.size * G / wall,
            "sweeps": res.sweeps.tolist(),
            "nonconverged": float(res.nonconverged),
            "finite": bool(np.isfinite(res.m_init).all()
                           and not np.isnan(res.ent1).any()),
            "member_mean": curve}


def phase_config4_main() -> dict:
    """Config 4 at full width through ``entropy_ensemble_union``: wall time,
    graph-λ-points/s, sweeps per λ, nonconverged, the sweep kernel's
    launches, peak device memory; the union's classes (every one admitted)
    timed one by one; the device breakdown of one fixed point under the
    profiler."""
    t0 = time.perf_counter()
    gs = _config4_graphs()
    t_graphs = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()       # earlier phases' live tensors
    _reset_bdcm_counts()
    t0 = time.perf_counter()
    res = entropy_ensemble_union(gs, _config4_config(), seed=0,
                                 lambdas=_config4_lambdas(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _bdcm_counts("entropy_ensemble_union (config 4)",
                            _ladder_sweeps([res.sweeps]))
    peak = torch.cuda.max_memory_allocated() - held
    rep = _ladder_report(res, wall, CONFIG4_G)
    if not rep["finite"] or res.ent.shape != (res.lambdas.size, CONFIG4_G):
        raise AssertionError(f"config 4 result: {rep}")
    log(f"[21 config 4] entropy_ensemble_union, {CONFIG4_G} x ER(n="
        f"{CONFIG4_N}, c={CONFIG4_C}), {CONFIG4_L} lambda in [0, "
        f"{CONFIG4_LMBD_MAX}], max_sweeps {CONFIG4_MAX_SWEEPS}, float32: wall "
        f"{wall:.3f} s (graphs {t_graphs:.3f} s before it), "
        f"{rep['lambdas']} lambda visited, "
        f"{rep['graph_lambda_points_per_s']:.4f} graph-lambda-points/s, "
        f"sweeps {rep['sweeps']}, nonconverged {rep['nonconverged']}; peak "
        f"device memory of the run {peak} B (above the {held} B the earlier "
        f"phases hold); bdcm_sweep launches (one per sweep) {launches}; member "
        f"means {rep['member_mean']}")
    subs = [graphs.remove_isolates(g)[0] for g in gs]
    union = graphs.disjoint_union(subs)[0]
    data = BDCMData(union)
    classes = _class_report(data, "config-4 union")
    timings = _class_timings(data, "config-4 union", 0.5)
    fp = make_fixed_point(data, EntropyConfig(max_sweeps=64), device="cuda")
    if set(fp.spec.modes) != {"cuda"}:
        raise AssertionError(f"config-4 classes off the kernel: {fp.spec.modes}")
    log(f"[21 config 4] every one of the {len(fp.spec.modes)} edge classes "
        f"runs through the kernel (modes {fp.spec.modes}); 0 on the plain "
        f"version")
    chi0 = data.init_messages(0).to("cuda")
    fp(chi0, 0.0)                                    # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fp(chi0, 0.0)
    torch.cuda.synchronize()
    fp_wall = time.perf_counter() - t0
    profile = profile_breakdown(lambda: fp(chi0, 0.0),
                                "config 4, one fixed point of 64 sweeps")
    # the profiler slows the host's issue, so its own busy share is a lower
    # bound; the device time it sums over the fixed point's wall time
    # without it is the device's busy share in the run
    busy = profile["device_us"] * 1e-6 / fp_wall
    log(f"[21 config 4] one fixed point of 64 sweeps: {fp_wall * 1e3:.3f} ms "
        f"wall without the profiler ({fp_wall * 1e3 / 64:.4f} ms/sweep); "
        f"device busy share {busy:.4f}")
    return {"launches": launches, "peak_bytes": peak, "graphs_s": t_graphs,
            **rep, "classes": classes, "timings": timings,
            "profile": profile, "fp64_wall_s": fp_wall, "busy_share": busy}


def phase_congruent_ensemble() -> dict:
    """``entropy_ensemble`` on 64 × RRG(1000, 3) at config 4's λ and config:
    one launch per sweep over the ensemble axis (the shared factor)."""
    gs = [random_regular_graph(CONFIG4_N, 3, seed=k) for k in range(CONFIG4_G)]
    _reset_bdcm_counts()
    t0 = time.perf_counter()
    res = entropy_ensemble(gs, _config4_config(), seed=0,
                           lambdas=_config4_lambdas(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _bdcm_counts("entropy_ensemble (64 RRG)",
                            _ladder_sweeps([res.sweeps]))
    rep = _ladder_report(res, wall, CONFIG4_G)
    if not rep["finite"]:
        raise AssertionError(f"congruent ensemble result: {rep}")
    log(f"[22 congruent ensemble] entropy_ensemble, {CONFIG4_G} x RRG(n="
        f"{CONFIG4_N}, d=3), config 4's lambda and config: wall {wall:.3f} s, "
        f"{rep['lambdas']} lambda visited, "
        f"{rep['graph_lambda_points_per_s']:.4f} graph-lambda-points/s, "
        f"sweeps {rep['sweeps']}, nonconverged {rep['nonconverged']}; "
        f"bdcm_sweep launches (one per sweep) {launches}")
    return {"launches": launches, **rep}


def phase_entropy_cli() -> dict:
    """``python -m graphdyn_torch entropy --device cuda`` at its defaults
    (n=1000, deg 1.0 1.5 2.0, num_rep 3, the grouped entropy_grid) but for
    its λ ladder, cut to λ ≤ :data:`ENTROPY_CLI_LMBD_MAX` (31 of the 121
    points) to keep the script's time, in process, with its wall time and
    the reference's JSON keys."""
    _reset_bdcm_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        npz = os.path.join(tmp, "ent.npz")
        with contextlib.redirect_stdout(buf), _grid_results() as grids:
            rc = cli.main(["entropy", "--device", "cuda", "--lmbd-max",
                           str(ENTROPY_CLI_LMBD_MAX), "--out", npz])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with np.load(npz) as f:
            # what phase 44 holds its resumed run to
            held = {k: f[k] for k in ("ent", "m_init", "ent1", "counts",
                                      "n_lambda")}
    if len(grids) != 1:
        raise AssertionError(f"entropy CLI: {len(grids)} entropy_grid calls")
    launches = _bdcm_counts("entropy CLI", _grid_sweeps(*grids[0]))
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or set(doc) != {"solver", "deg", "ent1_first_lambda",
                               "counts", "out", "plot"}:
        raise AssertionError(f"entropy CLI: rc {rc}, keys {sorted(doc)}")
    if not np.all(np.isfinite(doc["ent1_first_lambda"])):
        raise AssertionError(f"entropy CLI: {doc}")
    n_lmbd = lambda_ladder(EntropyConfig(lmbd_max=ENTROPY_CLI_LMBD_MAX)).size
    log(f"[23 entropy cli] python -m graphdyn_torch entropy --device cuda "
        f"--lmbd-max {ENTROPY_CLI_LMBD_MAX} (defaults otherwise: n=1000, deg "
        f"1.0 1.5 2.0, num_rep 3, lambda step 0.1, {n_lmbd} points): wall "
        f"{wall:.3f} "
        f"s; counts {doc['counts']}; ent1 at lambda 0 "
        f"{doc['ent1_first_lambda']}; bdcm_sweep launches (one per sweep) {launches}")
    return {"wall_s": wall, "launches": launches, "counts": doc["counts"],
            "grids": held}


# ---------------------------------------------------------------------------
# the SA searches: the serial chain (full and light-cone), the grouped `sa`
# ensemble, the chromatic chain and the tempering ladder (plain PyTorch on
# the card: no TPU kernel lies on this path)
# ---------------------------------------------------------------------------


def _same_sa(got, want, what: str) -> None:
    """``num_steps``, ``s`` and ``m_final`` equal, ``mag_reached`` within
    1e-6."""
    for name in ("num_steps", "s", "m_final"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"{what}: {name} differs")
    err = float(np.max(np.abs(got.mag_reached.astype(np.float64)
                              - want.mag_reached.astype(np.float64))))
    if err > 1e-6:
        raise AssertionError(f"{what}: mag_reached differs by {err}")


def _check_sa_consensus(g, res, p: int, c: int, what: str) -> int:
    """Every chain reported at m_final = 1 rolls out to all +1 under the
    port's end_state on the card; returns how many there were."""
    hits = np.flatnonzero(res.m_final == 1.0)
    for k in hits:
        out = end_state(g, res.s[k], p, c, device="cuda").cpu().numpy()
        if not np.all(out == 1):
            raise AssertionError(f"{what}: chain {k} m_final 1.0 but its "
                                 "end state is not all +1")
    return int(hits.size)


def _check_ensemble_consensus(res, args, what: str) -> int:
    """``_check_sa_consensus`` for each repetition of an ``sa`` ensemble
    (repetition k on RRG(n, d) drawn from ``seed + k``)."""
    hits = 0
    for k in np.flatnonzero(res.m_final == 1.0):
        g = random_regular_graph(args.n, args.d, seed=args.seed + int(k))
        out = end_state(g, res.conf[k], args.p, args.c,
                        device="cuda").cpu().numpy()
        if not np.all(out == 1):
            raise AssertionError(f"{what}: repetition {k} m_final 1.0 but "
                                 "its end state is not all +1")
        hits += 1
    return hits


def phase_sa_parity() -> dict:
    """Injected-stream chains on the card against the same chains on the
    CPU in the port, full and light-cone: RRG n=300, d=4, (p, c) = (3, 1),
    R=4, and a ragged ER graph with isolates (n=300, c=3); then counter-
    stream chains (card == CPU by construction) on RRG(24, 3) at p=2, which
    reach consensus, each checked to roll out to all +1; then the chromatic
    chain and the tempering ladder, card == CPU, at small sizes."""
    log(f"[26 searches] card: {card_line()}")
    out = {}
    cases = {"RRG n=300 d=4": random_regular_graph(SA_PARITY_N, 4, seed=0),
             "ER n=300 c=3": erdos_renyi_graph(SA_PARITY_N, 3.0 / 299,
                                               seed=1)}
    cfg = SAConfig(dynamics=DynamicsConfig(p=3, c=1))
    rng = np.random.default_rng(5)
    for label, g in cases.items():
        R, L = 4, SA_PARITY_L
        kw = dict(s0=(2 * rng.integers(0, 2, size=(R, g.n)) - 1).astype(np.int8),
                  proposals=rng.integers(0, g.n, size=(R, L)).astype(np.int32),
                  uniforms=rng.random(size=(R, L)))
        t0 = time.perf_counter()
        cpu = simulated_annealing(g, cfg, device="cpu", **kw)
        t_cpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = simulated_annealing(g, cfg, device="cuda", **kw)
        t_card = time.perf_counter() - t0
        _same_sa(card, cpu, f"sa parity {label} full")
        lc = simulated_annealing(g, cfg, device="cuda",
                                 rollout_mode="lightcone", **kw)
        _same_sa(lc, card, f"sa parity {label} light-cone vs full")
        accepts = int(np.sum(cpu.s != kw["s0"]))
        out[label] = {"steps": cpu.num_steps.tolist(),
                      "m_final": cpu.m_final.tolist(),
                      "card_s": t_card, "cpu_s": t_cpu}
        log(f"[26 sa parity] {label}, p=3 c=1, R={R}, {L} injected steps: "
            f"card == CPU (num_steps {card.num_steps.tolist()}, s, m_final "
            f"{card.m_final.tolist()} equal, mag_reached within 1e-6), "
            f"light-cone == full on the card; {accepts} spins differ from "
            f"s0; wall card {t_card:.3f} s, CPU {t_cpu:.3f} s")
    g = random_regular_graph(24, 3, seed=2)
    cfg2 = SAConfig(dynamics=DynamicsConfig(p=2, c=1))
    kw = dict(n_replicas=4, seed=3, max_steps=5000)
    card = simulated_annealing(g, cfg2, device="cuda", **kw)
    _same_sa(card, simulated_annealing(g, cfg2, device="cpu", **kw),
             "sa parity counter stream")
    hits = _check_sa_consensus(g, card, 2, 1, "sa parity counter stream")
    if hits == 0:
        raise AssertionError("sa parity: no counter-stream chain reached "
                             "consensus")
    log(f"[26 sa parity] counter stream, RRG(24, 3) p=2 c=1, R=4: card == "
        f"CPU (num_steps {card.num_steps.tolist()}); {hits} chains at "
        f"m_final 1 each roll out to all +1 on the card")
    chrom_kw = dict(n_replicas=40, seed=1, m_target=0.6, max_sweeps=30,
                    chunk_sweeps=8)
    gc = random_regular_graph(SA_PARITY_N, 3, seed=4)
    ccfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
    a = chromatic_anneal(gc, ccfg, device="cuda", **chrom_kw)
    b = chromatic_anneal(gc, ccfg, device="cpu", **chrom_kw)
    for name in a._fields:
        if not np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name))):
            raise AssertionError(f"chromatic parity: {name} differs")
    log(f"[26 sa parity] chromatic_anneal RRG(300, 3), R=40 (W=2), "
        f"{a.sweeps} sweeps: card == CPU in every field (accepted "
        f"{a.accepted}, steps_to_target {a.steps_to_target[:6].tolist()}...)")
    tmp_kw = dict(n_lanes=4, seed=2, max_steps=900, swap_interval=100,
                  m_target=0.6, beta_max=8.0)
    gt = random_regular_graph(64, 3, seed=0)
    a = temper_search(gt, ccfg, device="cuda", **tmp_kw)
    b = temper_search(gt, ccfg, device="cpu", **tmp_kw)
    for name in a._fields:
        if not np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name))):
            raise AssertionError(f"temper parity: {name} differs")
    log(f"[26 sa parity] temper_search RRG(64, 3), 4 lanes, 900 steps: card "
        f"== CPU in every field (swaps {a.swap_accepts}/{a.swap_attempts})")
    return out


def _sa_profile(label: str, run) -> dict:
    run()                                      # warm-up
    torch.cuda.synchronize()
    return profile_breakdown(run, label, top=6)


def phase_sa_main() -> dict:
    """The ``sa`` CLI at its defaults (n=10⁴, d=4, p=3, c=1, n_stat=5, the
    grouped G=5 ensemble, full rollout), with ``--max-steps`` cut to
    :data:`SA_MAIN_STEPS`, through ``cli._sa_main`` (the command's code,
    which prints its JSON); then the same with ``--rollout-mode lightcone``,
    which runs the serial repetition loop. The two must give the same
    chains bit for bit (a group equals the serial chains of the same seeds,
    and light-cone equals full). Host reads are counted; the device's busy
    share is read by the profiler over one chunk of each mode."""
    out = {}
    dev = torch.device("cuda")
    for mode in ("full", "lightcone"):
        argv = ["sa", "--device", "cuda", "--max-steps", str(SA_MAIN_STEPS)]
        if mode == "lightcone":
            argv += ["--rollout-mode", "lightcone"]
        args = cli.build_parser().parse_args(argv)
        sa_models.HOST_READS = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = cli._sa_main(args, dev)
        wall = time.perf_counter() - t0
        doc = json.loads(buf.getvalue().strip().splitlines()[-1])
        if set(doc) != {"solver", "mag_reached", "num_steps", "m_final",
                        "out"}:
            raise AssertionError(f"sa CLI keys {sorted(doc)}")
        if not (np.all(np.isfinite(res.mag_reached))
                and res.conf.shape == (5, args.n)):
            raise AssertionError(f"sa CLI {mode}: bad result")
        reads = sa_models.HOST_READS
        steps = res.num_steps.astype(np.int64)
        chains = 1 if mode == "full" else 5   # chains per program
        per_chain = reads / chains
        bound = (int(steps.max()) if mode == "full" else int(steps.sum())
                 ) / sa_models.CHUNK_STEPS + chains
        if reads > bound:
            raise AssertionError(f"sa {mode}: {reads} host reads > {bound}")
        hits = _check_ensemble_consensus(res, args, f"sa CLI {mode}")
        out[mode] = {"res": res, "wall_s": wall, "host_reads": reads,
                     "host_reads_per_chain": per_chain,
                     "chain_steps_per_s": float(steps.sum()) / wall,
                     "consensus_chains": hits}
        log(f"[27 sa main] sa CLI defaults, --rollout-mode {mode} "
            f"({'grouped G=5' if mode == 'full' else 'serial'}), "
            f"--max-steps {SA_MAIN_STEPS} (cut from 2n^3, clamped to "
            f"2^31-2): num_steps {steps.tolist()}, mag_reached "
            f"{res.mag_reached.tolist()}, m_final {res.m_final.tolist()}; "
            f"wall {wall:.3f} s, {out[mode]['chain_steps_per_s']:.1f} chain "
            f"steps/s (set-up included); host reads {reads} "
            f"({per_chain:.1f} per chain, chunk {sa_models.CHUNK_STEPS} "
            f"steps); consensus chains {hits}")
    full, lc = out["full"]["res"], out["lightcone"]["res"]
    for name in full._fields:
        if not np.array_equal(getattr(full, name), getattr(lc, name)):
            raise AssertionError(f"sa main: grouped full != serial light-cone "
                                 f"in {name}")
    log("[27 sa main] the grouped full-rollout ensemble equals the serial "
        "light-cone chains of the same seeds bit for bit (every field)")
    # one chunk of each mode: its wall by the host clock (ending in a
    # sync), then the same chunk under the profiler for its device time;
    # eager and replayed from a CUDA graph
    cfg = SAConfig(dynamics=DynamicsConfig(p=3, c=1))
    graphs = [random_regular_graph(10_000, 4, seed=k) for k in range(5)]
    preps = [sa_models.prepare_sa_inputs(g, cfg, n_replicas=1, seed=k)
             for k, g in enumerate(graphs)]
    _, idx, st, consts, static = sa_group._assemble_group(
        graphs, preps, list(range(5)), cfg, dtype="float32", group_size=5,
        device=dev)
    K = sa_models.CHUNK_STEPS
    g = graphs[0]
    tables = build_lightcone_tables(g, 3, device=dev)
    st1 = sa_models._sa_init(
        None, torch.from_numpy(preps[0][2]).to(dev),
        sa_models.chain_keys(0, 1, dev),
        torch.full((1,), cfg.a0_frac * g.n, device=dev),
        torch.full((1,), cfg.b0_frac * g.n, device=dev), rollout_steps=3,
        R_coef=1, C_coef=1, lightcone=True,
        nbr=torch.from_numpy(g.nbr).to(dev))
    consts1 = sa_models.sa_consts(cfg, g.n, torch.float32, dev)
    dummy = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    chunks = {
        "full": (st, lambda s_: sa_group._sa_group_loop(
            idx, s_, consts, chunk_steps=K, **static)),
        "lightcone": (st1, lambda s_: sa_models._sa_loop(
            None, s_, consts1, dummy, dummy, rollout_steps=3, R_coef=1,
            C_coef=1, max_steps=2**31 - 2, injected=False, stream_len=1,
            chunk_steps=K, lc_tables=tables)),
    }
    for mode, (s0_, fn) in chunks.items():
        calls = {"eager": fn,
                 "graph": sa_models.chunk_caller(fn)}
        for how, call in calls.items():
            call(s0_)                          # warm-up (captures the graph)
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                call(s0_)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            out[mode][f"{how}_wall_us_per_step"] = (
                float(np.median(walls)) * 1e6 / K)
        # the same kernels either way: the device time of a replay
        prof = profile_breakdown(lambda: calls["graph"](s0_),
                                 f"sa {mode}, one chunk of {K} steps "
                                 f"(graph replay)", top=6)
        dev_us = prof["device_us"] / K
        out[mode]["device_us_per_step"] = dev_us
        for how in calls:
            wall_us = out[mode][f"{how}_wall_us_per_step"]
            out[mode][f"{how}_busy_share"] = dev_us / wall_us
            log(f"[27 sa main] {mode}, one chunk of {K} steps, {how}: "
                f"{wall_us:.2f} us per step of wall (host clock, median of "
                f"3 chunks), {dev_us:.2f} us of device time (profiler, "
                f"graph replay): busy share {dev_us / wall_us:.4f}")
    return out


def phase_chromatic_main() -> dict:
    """The ``chromatic`` CLI at its defaults (n=10⁴, d=3, p=c=1, 32
    replicas, m_target 0.9, max_sweeps 5000, 64 sweeps per chunk) through
    ``cli._chromatic_main``; each replica that reached the target is checked
    against its rolled-out end state on the card."""
    args = cli.build_parser().parse_args(["chromatic", "--device", "cuda"])
    packed_cuda.LAUNCHES = 0
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = cli._chromatic_main(args, torch.device("cuda"))
    wall = time.perf_counter() - t0
    # read before the checks and timing runs below, which launch it again
    launches = packed_cuda.LAUNCHES
    if launches != 1:
        raise AssertionError(f"chromatic CLI: {launches} packed_step "
                             "launches, expected 1 (the initial end sums)")
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    if set(doc) != {"solver", "chi", "sweeps", "device_steps", "accepted",
                    "m_end", "steps_to_target", "sweeps_to_target", "out"}:
        raise AssertionError(f"chromatic CLI keys {sorted(doc)}")
    g = random_regular_graph(args.n, args.d, seed=args.seed)
    end = end_state(g, res.s, 1, 1, device="cuda").cpu().numpy()
    m_end = end.astype(np.float64).sum(axis=1) / g.n
    if not np.array_equal(m_end, res.m_end):
        raise AssertionError("chromatic CLI: m_end is not the rolled-out "
                             "end state's magnetization")
    reached = res.steps_to_target >= 0
    if not np.all(res.m_end[reached] >= args.m_target):
        raise AssertionError("chromatic CLI: a replica past its first "
                             "passage is below the target")
    run_sweeps = -(-res.sweeps // args.chunk_sweeps) * args.chunk_sweeps
    # the sweep rate without the set-up: one 64-sweep chunk on prebuilt
    # tables at m_target 1.0 (no replica stops), its wall by the host clock
    # ending in a read, and its device time under the profiler
    tables = build_chromatic_tables(g, seed=args.seed)
    cfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))

    def sweeps(k):
        return chromatic_anneal(g, cfg, n_replicas=32, seed=args.seed,
                                m_target=1.0, max_sweeps=k, chunk_sweeps=k,
                                tables=tables, device="cuda")

    sweeps(64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r64 = sweeps(64)
    wall64 = time.perf_counter() - t0
    # the busy share over a shorter chunk: the profiler's tables over 64
    # sweeps took ~100 s of post-processing on the card's host
    k = CHROMATIC_PROFILE_SWEEPS
    sweeps(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweeps(k)
    wall_k = time.perf_counter() - t0
    prof = profile_breakdown(lambda: sweeps(k), f"chromatic, {k} sweeps on "
                             "prebuilt tables", top=6)
    if r64.sweeps != 64:
        raise AssertionError(f"chromatic timing run: {r64.sweeps} sweeps")
    out = {"wall_s": wall, "sweeps": res.sweeps, "chi": res.chi,
           "sweeps_per_s": res.sweeps / wall,
           "run_sweeps_per_s": run_sweeps / wall,
           "timed_sweeps_per_s": 64 / wall64,
           "timed_busy_share": prof["device_us"] / (wall_k * 1e6),
           "class_steps_per_s": res.device_steps / wall,
           "first_passage_sweeps": res.sweeps_to_target.tolist(),
           "reached": int(reached.sum()),
           "packed_step_launches": launches}
    log(f"[28 chromatic main] chromatic CLI defaults: chi {res.chi}, "
        f"{res.sweeps} sweeps ({res.device_steps} class steps; the chunk "
        f"ran {run_sweeps} sweeps, those after the last first passage "
        f"masked no-ops: {out['run_sweeps_per_s']:.2f} sweeps/s run), "
        f"wall {wall:.3f} s = {out['sweeps_per_s']:.2f} sweeps/s, "
        f"{out['class_steps_per_s']:.1f} class steps/s (set-up included); "
        f"{out['reached']}/32 replicas at m_end >= 0.9, first-passage "
        f"sweeps min {res.sweeps_to_target[reached].min() if reached.any() else -1} "
        f"median {np.median(res.sweeps_to_target[reached]) if reached.any() else -1} "
        f"max {res.sweeps_to_target.max()}; m_end equals the rolled-out end "
        f"states; packed_step launches in the CLI run (the initial end "
        f"sums) {launches}")
    log(f"[28 chromatic main] 64 sweeps on prebuilt tables (m_target 1.0, "
        f"no replica stops): {wall64:.3f} s = {out['timed_sweeps_per_s']:.2f} "
        f"sweeps/s, {64 * res.chi / wall64:.1f} class steps/s; {k} sweeps: "
        f"{wall_k:.3f} s, device {prof['device_us'] / 1e3:.3f} ms under the "
        f"profiler: busy share {out['timed_busy_share']:.4f}")
    return out


def phase_temper_main() -> dict:
    """The ``temper`` CLI at its defaults (n=10⁴, d=3, p=1, 8 lanes, β
    geomspace(1, 64), swap interval 1000, m_target 1.0) with ``--max-steps``
    cut to :data:`TEMPER_MAIN_STEPS`, through ``cli._temper_main``."""
    args = cli.build_parser().parse_args(
        ["temper", "--device", "cuda", "--max-steps", str(TEMPER_MAIN_STEPS)])
    sa_models.HOST_READS = 0
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = cli._temper_main(args, torch.device("cuda"))
    wall = time.perf_counter() - t0
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    if set(doc) != {"solver", "lanes", "lane_shards", "betas", "num_steps",
                    "m_final", "t_target", "steps_to_target", "target_lane",
                    "swap_attempts", "swap_accepts", "swap_acceptance_rate",
                    "out"}:
        raise AssertionError(f"temper CLI keys {sorted(doc)}")
    g = random_regular_graph(args.n, args.d, seed=args.seed)
    hits = _check_sa_consensus(g, res, 1, 1, "temper CLI")
    steps = res.num_steps.astype(np.int64)
    pair = [f"{int(a)}/{int(t)}" for a, t in zip(res.pair_accepts,
                                                 res.pair_attempts)]
    out = {"wall_s": wall, "lane_steps_per_s": float(steps.sum()) / wall,
           "ladder_steps_per_s": float(steps.max()) / wall,
           "pair_accepts": res.pair_accepts.tolist(),
           "pair_attempts": res.pair_attempts.tolist(),
           "swap_acceptance_rate": res.swap_acceptance_rate,
           "host_reads": sa_models.HOST_READS, "consensus_lanes": hits,
           "num_steps": steps.tolist()}
    log(f"[29 temper main] temper CLI defaults, --max-steps "
        f"{TEMPER_MAIN_STEPS} (cut from 2n^3): num_steps {steps.tolist()}, "
        f"m_final {res.m_final.tolist()}, t_target {res.t_target.tolist()}; "
        f"wall {wall:.3f} s = {out['ladder_steps_per_s']:.1f} ladder steps/s "
        f"({out['lane_steps_per_s']:.1f} lane steps/s, set-up included); "
        f"swap accepts/attempts per lane pair (k, k+1): {pair}, overall "
        f"{res.swap_acceptance_rate:.4f}; host reads "
        f"{sa_models.HOST_READS}; lanes at consensus {hits}, each rolled out "
        f"to all +1")
    return out


def phase_gather_interleaved() -> dict:
    """P against ``index_select`` in turns (P, I, I, P, ...), ``GATHER_REPS``
    repeats of each, every repeat the mean of ``gather_probe.ITERS`` queued
    calls by CUDA events: at the probe's widths (n_src 10⁶, W in {128, 512,
    1024}, its n_idx rule and seeds), at the headline step's own gather
    (n_src 10⁶+1, W=512, 3·10⁶ rows) and at the port's 16- and 32-word rows
    (config 3, HPr config 2's chi rows, the fused scale shape). P is the
    plan ``launch_plan`` picks (the vector path at its measured depth and
    store policy). Reports the median and the range of each, beside the read-once bound
    (each distinct source row read once) and the all-reads bound (every
    gathered row read and written); an implementation is slower beyond the
    spread where its fastest repeat is slower than the other's slowest."""
    shapes = [(f"probe W={W}", 1_000_000, W,
               gather_probe.probe_n_idx(3_000_000, W), W)
              for W in (128, 512, 1024)]
    shapes.append(("headline (W=512)", 1_000_001, 512, 3_000_000, 0))
    shapes += [(label, n_src, W, n_idx, 0)
               for label, n_src, W, n_idx in GATHER_PORT_SHAPES[1:4]]
    out = {}
    for label, n_src, W, n_idx, seed in shapes:
        src, idx = gather_probe.draw(n_src, n_idx, W, seed, "cuda")
        plan = gather_cuda.launch_plan(W, True)
        fns = {"P": lambda: row_gather(src, idx, kernel="cuda"),
               "index_select": lambda: src.index_select(0, idx)}
        want = fns["index_select"]()
        for impl, fn in fns.items():
            if impl != "index_select" and not torch.equal(fn(), want):
                raise AssertionError(f"row_gather ({impl}) differs at {label}")
        del want
        torch.cuda.synchronize()
        times = {impl: [] for impl in fns}
        order = tuple(fns)
        for r in range(GATHER_REPS):
            for impl in (order if r % 2 == 0 else order[::-1]):
                times[impl].append(gather_probe.cuda_ms(fns[impl],
                                                        gather_probe.ITERS))
        n_distinct = int(torch.unique(idx).numel())
        bound = gather_probe.gather_bound(n_idx, W, n_distinct)["bound_ms"]
        all_reads = 2 * n_idx * W * 4 / HBM_BYTES_PER_S * 1e3
        row = {"W": W, "n_src": n_src, "n_idx": n_idx, "bound_ms": bound,
               "all_reads_bound_ms": all_reads, "reps": GATHER_REPS,
               "plan": plan}
        for impl, ts in times.items():
            row[impl] = {"median_ms": float(np.median(ts)),
                         "min_ms": float(min(ts)), "max_ms": float(max(ts)),
                         "ms": ts}

        def verdict(a, b):
            if row[a]["min_ms"] > row[b]["max_ms"]:
                return f"{a} slower than {b} beyond the spread"
            if row[a]["max_ms"] < row[b]["min_ms"]:
                return f"{a} faster than {b} beyond the spread"
            return f"{a} and {b} within the spread"

        row["verdict"] = verdict("P", "index_select")
        out[label] = row
        log(f"[30 gather interleaved] {label} (n_src={n_src}, n_idx={n_idx}, "
            f"P's plan {plan}), {GATHER_REPS} repeats each in turns: "
            + "; ".join(f"{impl} median {row[impl]['median_ms']:.5f} ms (range "
                        f"{row[impl]['min_ms']:.5f}-{row[impl]['max_ms']:.5f})"
                        for impl in fns)
            + f"; read-once bound {bound:.5f} ms, all-reads bound "
            f"{all_reads:.5f} ms; {row['verdict']}")
        del src, idx
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the power-law path: KB (the bucketed step), the lifted K1/K2', the
# streamed rollout and the layouts of the solvers
# ---------------------------------------------------------------------------


def phase_kb_parity(g_bench, b_bench) -> dict:
    """KB against its plain version, bit for bit, through
    ``bucketed_rollout`` and ``bucketed_rollout_plain``: all four (rule,
    tie) pairs on ``powerlaw_graph(600, 2.3, 2, 7)`` at W in {1, 3, 4, 32}
    and on the bench graph at W = 32 (its hub bucket is 32768 wide: eight
    warps per item); three steps each. Also one streamed chunk of the bench
    graph (KB with a self table, the ``_stream_chunk_device`` shape) against
    the plain chunk step."""
    t0 = time.perf_counter()
    g600 = graphs.powerlaw_graph(600, gamma=2.3, dmin=2, seed=7)
    cases = [("pl600", g600, graphs.degree_buckets(g600), W)
             for W in (1, 3, 4, 32)]
    cases.append(("bench", g_bench, b_bench, POWERLAW_R // 32))
    n_cases = 0
    seed = 500
    for label, g, b, W in cases:
        order = torch.as_tensor(b.order, device="cuda")
        for rule, tie in RULE_TIES:
            seed += 1
            sp = _random_words(g.n, W, seed).index_select(0, order)
            k = bucketed.bucketed_rollout(b, sp, 3, rule, tie)
            p = bucketed.bucketed_rollout_plain(b, sp, 3, rule, tie)
            torch.cuda.synchronize()
            if not torch.equal(k, p):
                raise AssertionError(f"KB != plain: {label} W={W} {rule}/{tie} "
                                     f"max_abs_err {_max_abs_err(k, p)}")
            n_cases += 1
    # one streamed chunk of the bench graph with its hub
    plan = streamed.build_stream_plan(g_bench, W=1, n_chunks=400)
    ch = plan.chunks[-1]
    W = POWERLAW_R // 32
    slab = torch.cat([_random_words(ch.M, W, 77),
                      torch.zeros(1, W, dtype=torch.int32, device="cuda")])
    nbr, deg, self_loc = (torch.as_tensor(a, device="cuda")
                          for a in (ch.nbr_loc, ch.deg, ch.self_loc))
    for rule, tie in RULE_TIES:
        out = torch.empty((ch.C, W), dtype=torch.int32, device="cuda")
        bucketed_cuda.bucketed_step([(nbr, deg, self_loc, 0)], slab, out,
                                    rule=rule, tie=tie)
        want = bucketed.PlainBucketStep(nbr, deg, rule, tie)(
            slab, slab.index_select(0, self_loc.long()))
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"KB chunk != plain: {rule}/{tie}")
        n_cases += 1
    torch.cuda.empty_cache()
    log(f"[36 KB parity] {n_cases} cases (powerlaw_graph(600) at W = 1, 3, "
        f"4, 32; the bench graph at W = 32, hub {int(g_bench.dmax)}, "
        f"buckets {list(b_bench.widths)}; a streamed chunk of width "
        f"{ch.width} with its self table), four (rule, tie) pairs each: "
        f"KB == plain bit for bit in {time.perf_counter() - t0:.3f} s")
    return {"cases": n_cases, "max_abs_err": 0.0}


def phase_packed_planes() -> dict:
    """The lifted K1/K2' instantiations the bench graph does not reach, each
    held bit for bit, all four (rule, tie) pairs, three steps: 8 planes on
    ``powerlaw_graph(600, 2.3, 2, 7)`` (dmax 163) against the plain padded
    rollout and ``bucketed_rollout_global`` (KB); 32 planes on a 16-row
    table of 65,600 slots (degrees from 65,536 up: a multigraph, whose rows
    the kernel reads as it reads any) against KB's plain wide-bucket step
    over the same table."""
    out = {}
    g = graphs.powerlaw_graph(600, gamma=2.3, dmin=2, seed=7)
    nbr, deg = _tables(g)
    W = 4
    for k, (rule, tie) in enumerate(RULE_TIES):
        sp = _random_words(g.n, W, 600 + k)
        got = packed_rollout(nbr, deg, sp, 3, rule, tie)
        for name, want in (
                ("plain", packed_rollout_plain(nbr, deg, sp, 3, rule, tie)),
                ("KB", bucketed.bucketed_rollout_global(g, sp, 3, rule,
                                                        tie))):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K1/K2' at dmax {g.dmax} != {name}: {rule}/{tie} "
                    f"max_abs_err {_max_abs_err(got, want)}")
    out["8"] = {"dmax": int(g.dmax),
                "kernel_planes": packed_cuda.kernel_planes(
                    packed_cuda.n_planes(g.dmax)), "cases": 4}
    rows, width = 16, 65_600
    gen = torch.Generator(device="cuda")
    gen.manual_seed(65536)
    nbr = torch.randint(0, rows + 1, (rows, width), dtype=torch.int32,
                        device="cuda", generator=gen)
    deg = torch.randint(65_536, width + 1, (rows,), dtype=torch.int32,
                        device="cuda", generator=gen)
    slot = torch.arange(width, device="cuda")[None, :]
    nbr = torch.where(slot < deg[:, None], nbr, rows).contiguous()
    for k, (rule, tie) in enumerate(RULE_TIES):
        ext = torch.cat([_random_words(rows, W, 700 + k),
                         torch.zeros(1, W, dtype=torch.int32, device="cuda")])
        dst = torch.empty_like(ext)
        packed_cuda.packed_step(nbr, deg, ext, dst,
                                minority=rule == "minority",
                                change=tie == "change")
        want = bucketed.PlainBucketStep(nbr, deg, rule, tie)(ext, ext[:rows])
        torch.cuda.synchronize()
        if not torch.equal(dst[:rows], want) or dst[rows].any():
            raise AssertionError(
                f"K1/K2' at dmax {width} != plain: {rule}/{tie} "
                f"max_abs_err {_max_abs_err(dst[:rows], want)}")
    out["32"] = {"dmax": width, "min_degree": int(deg.min()),
                 "kernel_planes": packed_cuda.kernel_planes(
                     packed_cuda.n_planes(width)), "cases": 4}
    if (out["8"]["kernel_planes"], out["32"]["kernel_planes"]) != (8, 32):
        raise AssertionError("the plane checks ran other instantiations: "
                             f"{out['8']['kernel_planes']}, "
                             f"{out['32']['kernel_planes']}")
    torch.cuda.empty_cache()
    log(f"[36b K1/K2' planes] dmax {out['8']['dmax']} (the "
        f"{out['8']['kernel_planes']}-plane instantiation) == plain and KB; "
        f"dmax {width} with degrees from {out['32']['min_degree']} (the "
        f"{out['32']['kernel_planes']}-plane instantiation) == the plain "
        f"wide-bucket step; four (rule, tie) pairs each, bit for bit")
    return out


def _steps_ms(step, ext, reps: int) -> float:
    """Milliseconds per step of a stepper by CUDA events, queued back to
    back behind a device sleep."""
    state = [ext]

    def advance():
        state[0] = step(state[0])

    for _ in range(2):
        advance()
    return _cuda_ms(advance, reps, lead_ms=50)


def phase_powerlaw_main(g, b) -> dict:
    """The bench shape (``bench.py:powerlaw_rate_row``: ``powerlaw_graph(10⁵,
    2.2, 2, seed 0)``, R = 1024) through ``bucketed_rollout``, counted: one
    warm call as the bench makes, then 3 iterations of 20 steps, KB's
    launches must equal the 60 steps; the result held against the plain
    version. Then, outside the count: KB's time per step by CUDA events
    (and its narrow and wide segments apart, each one launch of those
    segments), the plain version's, the bound; the equal-edge d=8 RRG in
    the same call, its bare K1/K2' step and its entry point
    (``packed_rollout``, 3 × 20 steps as the bench times it), and the
    ratios of the rates, bare and through the entry points; the lifted
    K1/K2' on the padded power-law table (dmax = the hub's degree) held
    against ``bucketed_rollout_global`` (KB) bit for bit, and its time per
    step."""
    n, W = g.n, POWERLAW_R // 32
    sp = _random_words(n, W, 31).index_select(
        0, torch.as_tensor(b.order, device="cuda"))
    bucketed.bucketed_rollout(b, sp, POWERLAW_STEPS)          # warm
    bucketed_cuda.LAUNCHES = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    st = sp
    for _ in range(POWERLAW_ITERS):
        st = bucketed.bucketed_rollout(b, st, POWERLAW_STEPS)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bucketed_cuda.LAUNCHES
    steps = POWERLAW_ITERS * POWERLAW_STEPS
    if launches != steps:
        raise AssertionError(f"bucketed_rollout launched KB {launches} times "
                             f"for {steps} steps")
    main_ms = start.elapsed_time(end) / steps
    ref = sp
    for _ in range(POWERLAW_ITERS):
        ref = bucketed.bucketed_rollout_plain(b, ref, POWERLAW_STEPS)
    if not torch.equal(st, ref):
        raise AssertionError("bench-shape bucketed rollout != plain")
    del ref, st
    # timing outside the count
    tabs = bucketed.device_buckets(b, torch.device("cuda"))
    ext = torch.cat([sp, torch.zeros(1, W, dtype=torch.int32, device="cuda")])
    ms = _steps_ms(bucketed_cuda.KernelBucketedStep(
        tabs, n=n, rule="majority", tie="stay"), ext, 200)
    plain_ms = _steps_ms(bucketed.PlainBucketedStep(tabs, "majority", "stay"),
                         ext, 3)
    bound = kb_bound(n, W, g.deg)
    parts = {}
    for part in ("narrow", "wide"):
        segs = [(nb, dg, None, r0) for nb, dg, r0 in tabs
                if (nb.shape[1] > bucketed.UNROLL_MAX) == (part == "wide")]
        rows = sum(s[0].shape[0] for s in segs)
        part_deg = torch.cat([s[1] for s in segs]).cpu().numpy()
        dst = torch.empty_like(ext)
        launch = bucketed_cuda.Launch(segs, W=W, src_rows=n + 1,
                                      dst_rows=n + 1, device=ext.device,
                                      rule="majority", tie="stay")
        t = _cuda_ms(lambda: launch(ext, dst), 200, lead_ms=50)
        plain = bucketed.PlainBucketedStep(
            [tb_ for tb_ in tabs
             if (tb_[0].shape[1] > bucketed.UNROLL_MAX) == (part == "wide")],
            "majority", "stay")
        plain(ext)
        t_plain = _cuda_ms(lambda: plain(ext), 3, lead_ms=50)
        parts[part] = {"ms": t, "plain_ms": t_plain, "rows": rows,
                       "sum_deg": int(part_deg.sum()),
                       "segments": len(segs),
                       "widths": [int(s[0].shape[1]) for s in segs],
                       **kb_bound(n, W, part_deg)}
    rate = n * POWERLAW_R / (ms * 1e-3)
    # the equal-edge padded RRG control (bench.py:675-679)
    d = max(3, int(round(float(g.deg.sum()) / n)))
    if (n * d) % 2:
        d += 1
    g_r = random_regular_graph(n, d, seed=0)
    nbr_r, deg_r = _tables(g_r)
    ext_r = torch.cat([_random_words(n, W, 32),
                       torch.zeros(1, W, dtype=torch.int32, device="cuda")])
    rrg_ms = _steps_ms(_stepper(nbr_r, deg_r, "majority", "stay"), ext_r, 200)
    rrg_rate = n * POWERLAW_R / (rrg_ms * 1e-3)
    rrg_bound = step_bound(g_r, W, fast=False)
    st_r = packed_rollout(nbr_r, deg_r, ext_r[:n], POWERLAW_STEPS)   # warm
    start.record()
    for _ in range(POWERLAW_ITERS):
        st_r = packed_rollout(nbr_r, deg_r, st_r, POWERLAW_STEPS)
    end.record()
    torch.cuda.synchronize()
    rrg_main_ms = start.elapsed_time(end) / steps
    del nbr_r, deg_r, ext_r, st_r
    # the lifted K1/K2' on the padded power-law table
    t0 = time.perf_counter()
    nbr_p, deg_p = _tables(g)
    t_upload = time.perf_counter() - t0
    sp_g = _random_words(n, W, 33)
    packed_cuda.LAUNCHES = 0
    k = packed_rollout(nbr_p, deg_p, sp_g, 3)
    want = bucketed.bucketed_rollout_global(g, sp_g, 3, buckets=b)
    torch.cuda.synchronize()
    if not torch.equal(k, want):
        raise AssertionError("lifted K1/K2' != KB on the bench graph "
                             f"(dmax {g.dmax})")
    if packed_cuda.LAUNCHES != 3:
        raise AssertionError("the padded bench rollout did not launch K1/K2'")
    ext_p = torch.cat([sp_g, torch.zeros(1, W, dtype=torch.int32,
                                         device="cuda")])
    padded_ms = _steps_ms(_stepper(nbr_p, deg_p, "majority", "stay"), ext_p, 5)
    padded_bound = step_bound(g, W, fast=False)
    del nbr_p, deg_p, ext_p, k, want
    torch.cuda.empty_cache()
    out = {"ms": ms, "plain_ms": plain_ms, "main_ms": main_ms,
           "host_ms_per_step": wall * 1e3 / steps, "launches": launches,
           "spin_updates_per_s": rate, **bound, "parts": parts,
           "main_spin_updates_per_s": n * POWERLAW_R / (main_ms * 1e-3),
           "rrg": {"d": d, "ms": rrg_ms, "spin_updates_per_s": rrg_rate,
                   "main_ms": rrg_main_ms, "bound_ms": rrg_bound["bound_ms"],
                   "bound_by": rrg_bound["bound_by"]},
           "rrg_over_bucketed_x": rrg_rate / rate,
           "rrg_over_bucketed_main_x": main_ms / rrg_main_ms,
           "padded": {"ms": padded_ms, "dmax": int(g.dmax),
                      "planes": packed_cuda.n_planes(g.dmax),
                      "kernel_planes": packed_cuda.kernel_planes(
                          packed_cuda.n_planes(g.dmax)),
                      "bound_ms": padded_bound["bound_ms"],
                      "bound_by": padded_bound["bound_by"],
                      "table_upload_s": t_upload},
           "table_entries": b.table_entries,
           "padded_entries": n * int(g.dmax)}
    log(f"[37 powerlaw] powerlaw_graph(10^5, 2.2, 2, 0): hub {g.dmax}, "
        f"degree CV {graphs.degree_cv(g.deg):.4f}, {b.B} buckets, "
        f"{b.table_entries} table entries (padded {n * int(g.dmax)}); R="
        f"{POWERLAW_R}: bucketed_rollout {steps} steps, {launches} KB "
        f"launches, {main_ms} ms/step on the main path (host wall "
        f"{out['host_ms_per_step']} ms/step; the RRG's packed_rollout "
        f"{rrg_main_ms} ms/step: RRG/bucketed through the entry points "
        f"{out['rrg_over_bucketed_main_x']:.4f}x); KB {ms} ms/step = {rate:.6e} "
        f"spin-updates/s, bound {bound['bound_ms']} ms ({bound['bound_by']}: "
        f"{bound['bytes']} B); narrow segments {parts['narrow']['ms']} ms "
        f"(bound {parts['narrow']['bound_ms']}), wide {parts['wide']['ms']} "
        f"ms (bound {parts['wide']['bound_ms']}); plain {plain_ms} ms/step; "
        f"equal-edge RRG d={d} K1/K2' {rrg_ms} ms/step = {rrg_rate:.6e} "
        f"spin-updates/s (bound {rrg_bound['bound_ms']} ms): RRG/bucketed "
        f"{out['rrg_over_bucketed_x']:.4f}x; lifted K1/K2' padded at dmax "
        f"{g.dmax} ({out['padded']['planes']} planes, instantiation "
        f"{out['padded']['kernel_planes']}) == KB bit for bit, {padded_ms} "
        f"ms/step (bound {padded_bound['bound_ms']} ms)")
    return out


def _stream_budget(g, W: int) -> int:
    """``bench.py:stream_rate_row``'s device budget: a quarter of the
    modelled resident bucketed bytes, clamped below by twice the worst
    hub's one-node chunk."""
    resident = bucketed.bucketed_state_bytes(
        g.n, W, graphs.degree_buckets(g).table_entries)
    return max(resident // 4,
               2 * streamed.streamed_min_bytes(int(g.deg.max()), W))


def _run_cli(argv) -> tuple[dict, float]:
    """Run the port's CLI in this process; its JSON line and wall time."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{argv[0]} CLI exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), wall


def phase_stream_main() -> dict:
    """The ``stream`` CLI at ``bench.py:stream_rate_row``'s shape (n =
    65,536, the same law, R = 1024, 10 steps) with its device budget, at
    prefetch depth 0 and then 2, each counted: KB's launches must be chunks
    × steps. Both depths' configurations must equal
    ``bucketed_rollout_global`` (KB, resident) of the CLI's own initial
    state bit for bit, over at least 4 chunks. Then a churn run (``--churn-
    rate 8 --churn-seed 0``) at the CLI's defaults (n = 4096) on the card
    equals the same run on the CPU. Then, as ``bench.py:stream_rate_row``
    measures the pipeline: ``streamed_rollout`` on one prebuilt plan at
    depths 0 and 2 in turns (0, 2, 2, 0), ``STREAM_STEPS`` steps a leg
    after one warm step each: ms per step, ``hiding_frac`` = 1 − ms(2) /
    ms(0), and the host's gather time (``build_s``) and wait for it
    (``wait_s``) per step."""
    out = {}
    W = STREAM_R // 32
    g = graphs.powerlaw_graph(STREAM_N, gamma=2.2, dmin=2, seed=0)
    budget = _stream_budget(g, W)
    rng = np.random.default_rng(0)
    s0 = (2 * rng.integers(0, 2, size=(STREAM_R, STREAM_N)) - 1).astype(
        np.int8)
    from graphdyn_torch.ops.packed import pack_spins, unpack_spins

    want = unpack_spins(bucketed.bucketed_rollout_global(
        g, pack_spins(torch.as_tensor(s0, device="cuda")), STREAM_STEPS),
        STREAM_R).cpu().numpy()
    base = ["stream", "--n", str(STREAM_N), "--gamma", "2.2", "--replicas",
            str(STREAM_R), "--steps", str(STREAM_STEPS), "--device-budget",
            str(budget), "--device", "cuda"]
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        for depth in (0, 2):
            path = os.path.join(tmp, f"d{depth}.npz")
            bucketed_cuda.LAUNCHES = 0
            doc, wall = _run_cli(base + ["--prefetch-depth", str(depth),
                                         "--out", path])
            launches = bucketed_cuda.LAUNCHES
            if doc["chunks"] < 4:
                raise AssertionError(f"stream plan has {doc['chunks']} chunks")
            if launches != doc["chunks"] * STREAM_STEPS:
                raise AssertionError(f"stream depth {depth}: {launches} KB "
                                     f"launches for {doc['chunks']} chunks x "
                                     f"{STREAM_STEPS} steps")
            with np.load(path) as f:
                conf = f["conf"]
            if not np.array_equal(conf, want):
                raise AssertionError(f"stream depth {depth} != resident "
                                     "bucketed_rollout_global")
            out[depth] = {**doc, "wall_s": wall, "launches": launches,
                          "budget": budget}
            log(f"[38 stream] stream CLI n={STREAM_N} R={STREAM_R} "
                f"{STREAM_STEPS} steps, budget {budget} B, prefetch depth "
                f"{depth}: {doc['chunks']} chunks, {launches} KB launches, "
                f"wall {wall:.3f} s, overlap_frac {doc['overlap_frac']}, "
                f"h2d {doc['h2d_bytes']} B, d2h {doc['d2h_bytes']} B; == "
                f"resident bucketed_rollout_global bit for bit")
        churn = ["stream", "--churn-rate", "8", "--churn-seed", "0"]
        confs = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"churn_{dev}.npz")
            bucketed_cuda.LAUNCHES = 0
            doc, wall = _run_cli(churn + ["--device", dev, "--out", path])
            with np.load(path) as f:
                confs[dev] = (f["conf"], f["m_end"])
            out[f"churn_{dev}"] = {**doc, "wall_s": wall,
                                   "launches": bucketed_cuda.LAUNCHES}
        if not all(np.array_equal(a, b) for a, b in zip(confs["cuda"],
                                                        confs["cpu"])):
            raise AssertionError("churned stream run: card != CPU")
        if out["churn_cuda"]["launches"] <= 0 or out["churn_cpu"]["launches"]:
            raise AssertionError("churned stream run: KB launch counts")
    log(f"[38 stream] churn run (n=4096, --churn-rate 8): "
        f"{out['churn_cuda']['mutations']} mutations, card == CPU bit for "
        f"bit ({out['churn_cuda']['launches']} KB launches on the card)")
    # the pipeline alone, on one prebuilt plan
    plan = streamed.build_stream_plan(g, W=W, device_budget_bytes=budget)
    sp = pack_spins(torch.as_tensor(s0, device="cuda")).cpu()
    legs = {0: [], 2: []}
    for depth in (0, 2):
        streamed.streamed_rollout(g, sp, 1, plan=plan, prefetch_depth=depth)
    for depth in (0, 2, 2, 0):
        stats = {}
        t0 = time.perf_counter()
        got = streamed.streamed_rollout(g, sp, STREAM_STEPS, plan=plan,
                                        prefetch_depth=depth, stats_out=stats)
        wall = time.perf_counter() - t0
        if not np.array_equal(unpack_spins(got, STREAM_R).numpy(), want):
            raise AssertionError(f"streamed_rollout depth {depth} != "
                                 "resident bucketed_rollout_global")
        legs[depth].append({"ms_per_step": wall * 1e3 / STREAM_STEPS,
                            "build_ms_per_step": stats["build_s"] * 1e3
                            / STREAM_STEPS,
                            "wait_ms_per_step": stats["wait_s"] * 1e3
                            / STREAM_STEPS,
                            "overlap_frac": stats["overlap_frac"]})
    pipe = {str(d): {k: float(np.mean([leg[k] for leg in v])) for k in v[0]}
            for d, v in legs.items()}
    pipe["legs"] = {str(d): v for d, v in legs.items()}
    pipe["hiding_frac"] = max(0.0, 1.0 - pipe["2"]["ms_per_step"]
                              / pipe["0"]["ms_per_step"])
    pipe["chunks"] = plan.K
    # the host cost of the chunks' KB launch objects, summed over the plan
    # (ms per step): each made anew, against each rebound to new tables of
    # the same shapes, as the pipeline does from a chunk's second step
    made, rebound = 0.0, 0.0
    for ch in plan.chunks:
        seg = tuple(torch.as_tensor(a, device="cuda")
                    for a in (ch.nbr_loc, ch.deg, ch.self_loc)) + (0,)
        slab = torch.zeros((ch.M + 1, W), dtype=torch.int32, device="cuda")
        dst = torch.empty((ch.C, W), dtype=torch.int32, device="cuda")
        t0 = time.perf_counter()
        launch = bucketed_cuda.Launch(
            [seg], W=W, src_rows=ch.M + 1, dst_rows=ch.C, device=slab.device,
            rule="majority", tie="stay", check_tables=False)
        launch.check(slab, dst)
        made += time.perf_counter() - t0
        seg2 = tuple(t.clone() for t in seg[:3]) + (0,)
        t0 = time.perf_counter()
        launch.rebind([seg2])
        launch.check(slab, dst)
        rebound += time.perf_counter() - t0
    pipe["launch_made_ms_per_step"] = made * 1e3
    pipe["launch_rebound_ms_per_step"] = rebound * 1e3
    out["pipeline"] = pipe
    log(f"[38 stream] streamed_rollout on one plan ({plan.K} chunks), "
        f"{STREAM_STEPS} steps a leg, depths in turns 0, 2, 2, 0: depth 0 "
        f"{pipe['0']['ms_per_step']:.3f} ms/step (gather "
        f"{pipe['0']['build_ms_per_step']:.3f}), depth 2 "
        f"{pipe['2']['ms_per_step']:.3f} ms/step (gather "
        f"{pipe['2']['build_ms_per_step']:.3f}, waited "
        f"{pipe['2']['wait_ms_per_step']:.3f}, overlap_frac "
        f"{pipe['2']['overlap_frac']:.4f}); hiding_frac "
        f"{pipe['hiding_frac']:.4f}; the chunks' KB launch objects made "
        f"anew {pipe['launch_made_ms_per_step']:.4f} ms per step, rebound "
        f"{pipe['launch_rebound_ms_per_step']:.4f}")
    return out


def phase_layouts() -> dict:
    """The solvers' layouts on the card: ``simulated_annealing(layout=
    'auto')`` on ``powerlaw_graph(2000, 2.3, 2, 1)`` (auto routes it
    bucketed) equals the padded run on the relabeled graph, mapped back;
    ``fused_anneal(layout='auto')`` on a power-law graph built with dmax =
    48 (degree CV above the threshold) equals its
    padded run on the relabeled graph, mapped back; the ``sa`` CLI with
    ``--layout bucketed`` runs once (its chains checked by rollout)."""
    out = {}
    g = graphs.powerlaw_graph(2000, gamma=2.3, dmin=2, seed=1)
    if bucketed.auto_layout(g.deg) != "bucketed":
        raise AssertionError("the SA layout graph does not route bucketed")
    order = graphs.degree_buckets(g).order
    g_b, inv = graphs.permute_nodes(g, order)
    kw = dict(n_replicas=4, seed=3, max_steps=LAYOUT_SA_STEPS, device="cuda")
    cfg = SAConfig()
    t0 = time.perf_counter()
    res = simulated_annealing(g, cfg, layout="auto", **kw)
    out["sa_wall_s"] = time.perf_counter() - t0
    pad = simulated_annealing(g_b, cfg, layout="padded", **kw)
    _same_sa(res, pad._replace(s=pad.s[..., inv]), "SA layout='auto'")
    g_f = graphs.powerlaw_graph(2000, gamma=2.3, dmin=2, dmax=48, seed=1)
    if bucketed.auto_layout(g_f.deg) != "bucketed" or g_f.dmax > 63:
        raise AssertionError("the fused layout graph does not fit its role")
    g_fb, inv_f = graphs.permute_nodes(g_f, graphs.degree_buckets(g_f).order)
    fcfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
    fkw = dict(n_replicas=64, seed=0, max_sweeps=200, chunk_sweeps=50,
               device="cuda")
    fused_cuda.LAUNCHES = 0
    f_a = fused_anneal(g_f, fcfg, layout="auto", **fkw)
    out["fused_launches"] = fused_cuda.LAUNCHES
    f_p = fused_anneal(g_fb, fcfg, layout="padded", **fkw)
    if not (np.array_equal(f_a.s, f_p.s[..., inv_f])
            and np.array_equal(f_a.steps_to_target, f_p.steps_to_target)
            and f_a.accepted == f_p.accepted and f_a.kernel_used == "cuda"):
        raise AssertionError("fused layout='auto' != padded on the relabeled "
                             "graph")
    if out["fused_launches"] <= 0:
        raise AssertionError("fused layout='auto' did not launch K4'")
    argv = ["sa", "--device", "cuda", "--layout", "bucketed", "--max-steps",
            str(LAYOUT_SA_STEPS), "--n-stat", "2"]
    args = cli.build_parser().parse_args(argv)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res_cli = cli._sa_main(args, torch.device("cuda"))
    out["sa_cli_wall_s"] = time.perf_counter() - t0
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    if doc["solver"] != "sa" or res_cli.conf.shape != (2, args.n):
        raise AssertionError("sa --layout bucketed: bad result")
    out["sa_cli_consensus"] = _check_ensemble_consensus(
        res_cli, args, "sa --layout bucketed")
    log(f"[39 layouts] simulated_annealing(layout='auto') on "
        f"powerlaw_graph(2000, 2.3, 2, 1) (hub {g.dmax}) == padded on the "
        f"relabeled graph ({out['sa_wall_s']:.3f} s); fused_anneal(layout="
        f"'auto') on a dmax-{g_f.dmax} power-law graph == padded relabeled "
        f"({out['fused_launches']} K4' launches); sa --layout bucketed ran "
        f"in {out['sa_cli_wall_s']:.3f} s")
    return out


def phase_b4_labelling(g_h, nbr_h, deg_h) -> dict:
    """ROADMAP B4: K1/K2' at the headline shape (d=3 RRG, n=10⁶, W=512) in
    the as-built labelling and after ``permute_nodes(g, bfs_order(g))``, in
    turns, median of ``B4_REPS`` each (each repeat the mean of 20 queued
    steps). One step of the relabeled graph equals the permuted step."""
    W = HEADLINE_R // 32
    t0 = time.perf_counter()
    order = graphs.bfs_order(g_h)
    g_bfs, inv = graphs.permute_nodes(g_h, order)
    setup = time.perf_counter() - t0
    nbr_b, deg_b = _tables(g_bfs)
    sp = _random_words(g_h.n, W, 41)
    order_t = torch.as_tensor(order, device="cuda")
    inv_t = torch.as_tensor(inv, device="cuda")
    a = packed_rollout(nbr_h, deg_h, sp, 1)
    bb = packed_rollout(nbr_b, deg_b, sp.index_select(0, order_t), 1)
    if not torch.equal(bb.index_select(0, inv_t), a):
        raise AssertionError("the BFS-labelled step != the permuted step")
    del a, bb
    zero = torch.zeros(1, W, dtype=torch.int32, device="cuda")
    legs = {"as_built": (_stepper(nbr_h, deg_h, "majority", "stay"),
                         torch.cat([sp, zero])),
            "bfs": (_stepper(nbr_b, deg_b, "majority", "stay"),
                    torch.cat([sp.index_select(0, order_t), zero]))}
    times = {k: [] for k in legs}
    for r in range(B4_REPS):
        for k in (tuple(legs) if r % 2 == 0 else tuple(legs)[::-1]):
            step, ext = legs[k]
            times[k].append(_steps_ms(step, ext, 20))
    out = {"setup_s": setup}
    for k, ts_ in times.items():
        out[k] = {"median_ms": float(np.median(ts_)), "min_ms": min(ts_),
                  "max_ms": max(ts_), "ms": ts_}
    del legs, nbr_b, deg_b
    torch.cuda.empty_cache()
    log(f"[40 B4] headline K1/K2' step, {B4_REPS} repeats each in turns: "
        f"as built median {out['as_built']['median_ms']:.5f} ms (range "
        f"{out['as_built']['min_ms']:.5f}-{out['as_built']['max_ms']:.5f}), "
        f"BFS labelling median {out['bfs']['median_ms']:.5f} ms (range "
        f"{out['bfs']['min_ms']:.5f}-{out['bfs']['max_ms']:.5f}); bfs_order "
        f"+ permute_nodes {setup:.3f} s on the host")
    return out


# ---------------------------------------------------------------------------
# K4' past dmax 63 (C4), and durability: each CLI's run preempted and
# resumed, held to its uninterrupted twin
# ---------------------------------------------------------------------------


def _square_graph(g):
    """``G²`` built sparse (every pair in a closed neighbourhood), for a
    graph whose hub makes ``graphs.power_graph``'s dense expansion too
    large; the distance-2 colouring's input."""
    nbr, deg = g.nbr.astype(np.int64), g.deg.astype(np.int64)
    e = g.edges.astype(np.int64)
    codes = [e.min(axis=1) * g.n + e.max(axis=1)]
    for v in np.flatnonzero(deg > 1):
        nb = nbr[v, :deg[v]]
        a, b = np.triu_indices(nb.size, 1)
        lo, hi = np.minimum(nb[a], nb[b]), np.maximum(nb[a], nb[b])
        codes.append(lo * g.n + hi)
    codes = np.unique(np.concatenate(codes))
    return graphs.graph_from_edges(g.n, np.stack([codes // g.n,
                                                  codes % g.n], axis=1))


def phase_fused_hubs() -> dict:
    """K4′ past degree 63 (C4), on power-law graphs relabeled as
    ``layout='bucketed'`` relabels them: ``powerlaw_graph(600, 2.3, 2, 7)``
    (dmax 163, the 8-plane instantiation) and ``powerlaw_graph(4000, 2.0,
    2, 1)`` (dmax 1011, the 16-plane one). The kernel against its plain
    version, bit for bit in every FusedState field, over the first
    :data:`HUBS_PARITY_STEPS` class steps of a sweep (the hub's class is
    class 0: the greedy colouring takes the highest degree first; the plain
    version's hub step is its costly one: ~0.15 s at dmax 163, seconds at
    1011); the kernel's ms per class step over one whole sweep (CUDA
    events) beside the plain version's over those steps and the bound;
    then ``fused_anneal(layout='bucketed')`` on the dmax-163 graph through
    the entry point, counted, equal to itself in other chunks."""
    out = {}
    cases = {"dmax163": (graphs.powerlaw_graph(600, gamma=2.3, dmin=2,
                                               seed=7), (1, 2)),
             "dmax1011": (graphs.powerlaw_graph(HUBS_N, gamma=2.0, dmin=2,
                                                seed=HUBS_SEED), (1,))}
    cfg = _sa_config()
    for name, (g0, widths) in cases.items():
        # relabeled bucket-major, as fused_anneal(layout='bucketed') does
        g = graphs.permute_nodes(g0, graphs.degree_buckets(g0).order)[0]
        t0 = time.perf_counter()
        g2 = _square_graph(g)
        tables = build_fused_tables(
            g, cfg, seed=0, coloring=(g2, graphs.greedy_coloring(g2, seed=0)))
        t_tables = time.perf_counter() - t0
        hub_class = int(tables.chrom.colors[int(np.argmax(g.deg))])
        steps = HUBS_PARITY_STEPS[name]
        if hub_class >= steps:
            raise AssertionError(f"{name}: the hub's class {hub_class} lies "
                                 f"past the {steps} checked class steps")
        rows = {}
        for W in widths:
            st, td, static, _, _, _, _ = _assemble_fused(
                g, cfg, n_replicas=32 * W - 3, seed=W, m_target=1.0,
                betas=None, tables=tables, device=torch.device("cuda"))
            kw = dict(stop_on_first=False, **static)
            k = fused_chunk(_clone(st), W, td, kernel="cuda",
                            chunk_steps=steps, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = fused_chunk(_clone(st), W, td, kernel="plain",
                            chunk_steps=steps, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3 / steps
            e = _state_err(k, p)
            if e or bool(k.sp_ext[g.n].ne(0).any()) or int(k.accepted) <= 0:
                raise AssertionError(
                    f"fused kernel != plain past dmax 63: {name} W={W}: "
                    f"max_abs_err {e}, accepted {int(k.accepted)}")
            # the kernel over one whole sweep, after the checked launch
            ms = _cuda_ms(lambda: fused_chunk(
                _clone(st), W, td, kernel="cuda", chunk_steps=tables.chi,
                **kw), reps=1) / tables.chi
            bound = class_step_bound(tables.chrom, W)
            rows[W] = {"ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound["bound_ms"],
                       "bound_by": bound["bound_by"], "max_abs_err": e,
                       "parity_steps": steps, "accepted": int(k.accepted)}
        inst = fused_cuda.kernel_instance(g.dmax)
        out[name] = {"n": g.n, "dmax": g.dmax, "chi": tables.chi,
                     "instance": list(inst), "by_W": rows,
                     "tables_s": t_tables}
        log(f"[41 C4] K4′ on {name} (n={g.n}, dmax {g.dmax}, chi "
            f"{tables.chi}, instantiation (NP, NB, DM) = {inst}, tables "
            f"{t_tables:.3f} s): kernel == plain bit for bit over the first "
            f"{steps} class steps (the hub's class {hub_class} among them) "
            + "; ".join(
                f"W={W}: {r['ms']:.5f} ms per class step over a sweep "
                f"(events), plain {r['plain_ms']:.3f} ms over the checked "
                f"steps, bound {r['bound_ms']:.7f} ({r['bound_by']})"
                for W, r in rows.items()))
    g = cases["dmax163"][0]
    kw = dict(n_replicas=32, seed=1, m_target=0.9, max_sweeps=4,
              layout="bucketed", device="cuda")
    fused_cuda.LAUNCHES = 0
    got = fused_anneal(g, cfg, chunk_sweeps=2, **kw)
    torch.cuda.synchronize()
    launches = fused_cuda.LAUNCHES
    split = fused_anneal(g, cfg, chunk_sweeps=1, **kw)
    if launches <= 0 or got.kernel_used != "cuda" or not (
            np.array_equal(got.s, split.s) and got.accepted == split.accepted
            and got.accepted > 0):
        raise AssertionError(f"fused_anneal(layout='bucketed') at dmax 163: "
                             f"{launches} launches, kernel {got.kernel_used}, "
                             f"equal across chunk splits "
                             f"{np.array_equal(got.s, split.s)}")
    out["launches"] = launches
    log(f"[41 C4] fused_anneal(layout='bucketed') on powerlaw_graph(600, "
        f"2.3, 2, 7), 4 sweeps: {launches} fused_chunk launches, chi "
        f"{got.chi}, accepted {got.accepted}, the same in chunks of 1 sweep")
    return out


@contextlib.contextmanager
def _fault_env(specs):
    """``GRAPHDYN_FAULT_PLAN`` set to ``specs`` for the scope and read
    afresh, as a new process reads it; cleared after."""
    os.environ[faults.ENV_VAR] = json.dumps(specs)
    faults._env_plan_cache.clear()
    try:
        yield
    finally:
        os.environ.pop(faults.ENV_VAR, None)
        faults._env_plan_cache.clear()
        clear_shutdown()


class _CkptCost:
    """Wall seconds, counts and bytes of the durable store's snapshot saves
    and loads in a scope (the store's methods wrapped, not changed)."""

    def __init__(self):
        self.save_s = self.load_s = 0.0
        self.saves = self.loads = self.bytes = 0

    def __enter__(self):
        self._persist = tstore.DurableCheckpoint._persist
        self._load = tstore.DurableCheckpoint.load
        cost = self

        def persist(ck, payload, meta):
            t0 = time.perf_counter()
            cost._persist(ck, payload, meta)
            cost.save_s += time.perf_counter() - t0
            cost.saves += 1
            cost.bytes = max(cost.bytes,
                             os.path.getsize(ck.path + ".npz"))

        def load(ck):
            t0 = time.perf_counter()
            got = cost._load(ck)
            if got is not None:
                cost.load_s += time.perf_counter() - t0
                cost.loads += 1
            return got

        tstore.DurableCheckpoint._persist = persist
        tstore.DurableCheckpoint.load = load
        return self

    def __exit__(self, *exc):
        tstore.DurableCheckpoint._persist = self._persist
        tstore.DurableCheckpoint.load = self._load

    def report(self) -> dict:
        return {"saves": self.saves, "loads": self.loads,
                "bytes": self.bytes,
                "save_ms": self.save_s * 1e3 / max(self.saves, 1),
                "load_ms": self.load_s * 1e3 / max(self.loads, 1)}


def _cli_rc(argv) -> int:
    """``cli.main(argv)`` in this process, its output discarded; its exit
    code. An injected hard preemption propagates (the process would die
    there)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return cli.main(argv)


def _cli_preempted(argv, site: str, at: int) -> None:
    """A leg killed by ``GRAPHDYN_FAULT_PLAN`` at the ``at``-th hit of
    ``site`` (the exception a real process would die of)."""
    with _fault_env([{"site": site, "action": "preempt", "at": at}]):
        try:
            _cli_rc(argv)
        except faults.InjectedPreemption:
            return
    raise AssertionError(f"{argv[0]}: no preemption at {site} #{at}")


def _cli_signalled(argv, site: str, at: int) -> None:
    """A leg that gets a graceful-shutdown request at the ``at``-th hit of
    ``site`` (``GRAPHDYN_FAULT_PLAN``'s ``signal`` action, what a SIGTERM
    handler does): it must save there and exit 75."""
    with _fault_env([{"site": site, "action": "signal", "at": at}]):
        rc = _cli_rc(argv)
    if rc != EX_TEMPFAIL:
        raise AssertionError(f"{argv[0]}: exit {rc} on a shutdown request, "
                             f"not {EX_TEMPFAIL}")


def _cli_sigterm(argv, delay_s: float) -> float:
    """A leg that receives a real SIGTERM ``delay_s`` after the CLI's
    handler is installed: it must exit 75. Returns the signal's time (unix
    clock). A no-op handler stands in while the CLI's is not installed, so
    a late signal cannot end this script."""
    import signal
    import threading

    ours = lambda signum, frame: None        # noqa: E731
    prev = signal.signal(signal.SIGTERM, ours)
    sent = []

    def killer():
        deadline = time.monotonic() + 120.0
        while signal.getsignal(signal.SIGTERM) is ours:
            if time.monotonic() > deadline:
                return
            time.sleep(0.005)
        time.sleep(delay_s)
        if signal.getsignal(signal.SIGTERM) is not ours:
            sent.append(time.time())
            os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=killer)
    t.start()
    try:
        rc = _cli_rc(argv)
    finally:
        t.join()
        signal.signal(signal.SIGTERM, prev)
    if not sent or rc != EX_TEMPFAIL:
        raise AssertionError(f"{argv[0]}: SIGTERM sent {bool(sent)}, exit "
                             f"{rc}, not {EX_TEMPFAIL}")
    return sent[0]


def _same_npz(path: str, want: dict, what: str) -> None:
    with np.load(path) as f:
        for k, v in want.items():
            if not np.array_equal(f[k], np.asarray(v)):
                raise AssertionError(f"{what}: resumed {k} != uninterrupted")


def phase_sa_durable(oracle, tmp: str) -> dict:
    """The ``sa`` CLI at its defaults (5 × RRG(10⁴, 4), p=3), ``--max-steps``
    cut as phase 27 cuts it, on the serial repetition loop (``--group-size
    0``: the chain in flight snapshots itself) with ``--checkpoint`` and
    ``--checkpoint-interval 0``: killed by ``GRAPHDYN_FAULT_PLAN`` at a
    ``chunk.boundary`` of the second repetition; resumed and sent a real
    SIGTERM, which must exit 75 with a snapshot written after the signal; resumed to the end.
    The result must equal phase 27's uninterrupted run (grouped == serial)."""
    ck, npz = os.path.join(tmp, "sa", "run"), os.path.join(tmp, "sa.npz")
    argv = ["sa", "--device", "cuda", "--max-steps", str(SA_MAIN_STEPS),
            "--group-size", "0", "--checkpoint", ck, "--checkpoint-interval",
            "0", "--out", npz]
    kill_at = SA_MAIN_STEPS // sa_models.CHUNK_STEPS + 3
    t0 = time.perf_counter()
    with _CkptCost() as cost:
        _cli_preempted(argv, "chunk.boundary", kill_at)
        sent = _cli_sigterm(argv, SIGTERM_DELAY_S)
        # the shutdown snapshot (the chain's at its chunk boundary, or the
        # driver's at a repetition boundary) is written after the signal
        snaps = [os.path.join(os.path.dirname(ck), f)
                 for f in os.listdir(os.path.dirname(ck))
                 if f.endswith(".npz") and ".v" not in f and ".tmp" not in f]
        if max((os.path.getmtime(f) for f in snaps), default=0.0) < sent:
            raise AssertionError(f"sa: no snapshot written after the SIGTERM "
                                 f"({snaps})")
        if _cli_rc(argv) != 0:
            raise AssertionError("sa: the resumed run failed")
    wall = time.perf_counter() - t0
    _same_npz(npz, {"mag_reached": oracle.mag_reached,
                    "num_steps": oracle.num_steps, "conf": oracle.conf,
                    "graphs": oracle.graphs}, "sa CLI")
    rep = {"wall_s": wall, **cost.report()}
    log(f"[42 sa durable] sa CLI defaults, --max-steps {SA_MAIN_STEPS}, "
        f"serial: killed at chunk.boundary #{kill_at}, resumed and "
        f"SIGTERMed (exit 75, a snapshot written after the signal), "
        f"resumed: equal to "
        f"phase 27's uninterrupted run bit for bit; three legs {wall:.3f} s; "
        f"{rep['saves']} snapshots of {rep['bytes']} B, {rep['save_ms']:.3f} "
        f"ms a save, {rep['load_ms']:.3f} ms a load")
    return rep


def phase_hpr_durable(oracles: dict, tmp: str) -> dict:
    """The ``hpr`` CLI at its defaults (RRG d=4, n=10⁴, K3′) in float32 and
    float64, on the serial loop (``--group-size 0``: the chain in flight
    snapshots itself every 200-sweep chunk): a graceful-shutdown request
    at the 3rd ``chunk.boundary`` (exit 75, snapshot at that boundary),
    then resumed. The result must equal phase 13's uninterrupted run of the
    same chain bit for bit, and K3′'s launches over both legs must equal
    the sweeps of the run's clock."""
    out = {}
    TT = HPRConfig().max_sweeps
    for dtype, want in oracles.items():
        ck = os.path.join(tmp, f"hpr_{dtype}", "run")
        npz = os.path.join(tmp, f"hpr_{dtype}.npz")
        argv = ["hpr", "--device", "cuda", "--dtype", dtype, "--group-size",
                "0", "--checkpoint", ck, "--checkpoint-interval", "0",
                "--out", npz]
        _reset_bdcm_counts()
        t0 = time.perf_counter()
        with _CkptCost() as cost:
            _cli_signalled(argv, "chunk.boundary", 3)
            if _cli_rc(argv) != 0:
                raise AssertionError(f"hpr {dtype}: the resumed run failed")
        wall = time.perf_counter() - t0
        launches = _bdcm_counts(f"hpr CLI {dtype}, both legs",
                                _hpr_clock([want["num_steps"]], TT))
        _same_npz(npz, {"conf": want["conf"][None],
                        "num_steps": [want["num_steps"]]}, f"hpr {dtype}")
        out[dtype] = {"wall_s": wall, "launches": launches, **cost.report()}
        log(f"[43 hpr durable] hpr CLI defaults {dtype}, serial: exit 75 at "
            f"chunk.boundary #3, resumed: equal to phase 13's run bit for "
            f"bit ({want['num_steps']} sweeps); K3′ launches over both legs "
            f"{launches} = the run's sweeps; {wall:.3f} s; "
            f"{out[dtype]['saves']} snapshots of {out[dtype]['bytes']} B, "
            f"{out[dtype]['save_ms']:.3f} ms a save, "
            f"{out[dtype]['load_ms']:.3f} ms a load")
    return out


def phase_entropy_durable(want: dict, tmp: str) -> dict:
    """The ``entropy`` CLI as phase 23 runs it (λ ≤ 3), with
    ``--checkpoint`` and ``--checkpoint-interval 0``: killed at the
    :data:`ENTROPY_KILL_AT`-th ``lambda.boundary``, resumed: the grids must
    equal phase 23's uninterrupted run bit for bit. Then ``sweep.nan`` at the
    :data:`ENTROPY_NAN_AT`-th completed fixed point of a λ ≤ 0.5 run takes
    the JAX package's degrade path: the poisoned cell records
    non-convergence at that λ (its NaN row kept as the reference keeps it)
    and stops; the other cells run on; the run exits 0."""
    ck, npz = os.path.join(tmp, "ent", "run"), os.path.join(tmp, "ent.npz")
    argv = ["entropy", "--device", "cuda", "--lmbd-max",
            str(ENTROPY_CLI_LMBD_MAX), "--checkpoint", ck,
            "--checkpoint-interval", "0", "--out", npz]
    t0 = time.perf_counter()
    with _CkptCost() as cost:
        _cli_preempted(argv, "lambda.boundary", ENTROPY_KILL_AT)
        if _cli_rc(argv) != 0:
            raise AssertionError("entropy: the resumed run failed")
    wall = time.perf_counter() - t0
    _same_npz(npz, want, "entropy CLI")
    nan_npz = os.path.join(tmp, "ent_nan.npz")
    with _fault_env([{"site": "sweep.nan", "action": "nan",
                      "at": ENTROPY_NAN_AT}]):
        rc = _cli_rc(["entropy", "--device", "cuda", "--lmbd-max", "0.5",
                      "--out", nan_npz])
    with np.load(nan_npz) as f:
        ent, counts, n_lmbd = f["ent"], f["counts"], f["n_lambda"]
    # the poisoned cell: its last visited row is the NaN one, recorded as
    # non-converged at that λ (0 at λ = 0, the reference's sentinel), and
    # it stopped there; no other cell has a NaN row
    poisoned = np.argwhere(np.isnan(ent).any(axis=2))
    if rc != 0 or len(poisoned) != 1:
        raise AssertionError(f"entropy sweep.nan: exit {rc}, NaN rows in "
                             f"cells {poisoned.tolist()}")
    di, rep = poisoned[0]
    k = int(n_lmbd[di, rep]) - 1
    lam = float(lambda_ladder(EntropyConfig(lmbd_max=0.5))[k])
    if not (np.isnan(ent[di, rep, k]).all()
            and not np.isnan(ent[di, rep, :k]).any()
            and float(counts[di, rep]) == lam):
        raise AssertionError(f"entropy sweep.nan: cell {[di, rep]} went on "
                             f"past its poisoned lambda (n_lambda "
                             f"{n_lmbd[di, rep]}, counts {counts[di, rep]})")
    out = {"wall_s": wall, **cost.report(), "nan_cell": [int(di), int(rep)],
           "nan_lambda": lam}
    log(f"[44 entropy durable] entropy CLI (lambda <= "
        f"{ENTROPY_CLI_LMBD_MAX}): killed at lambda.boundary "
        f"#{ENTROPY_KILL_AT}, resumed: "
        f"equal to phase 23's run bit for bit, {wall:.3f} s; "
        f"{out['saves']} snapshots of {out['bytes']} B, "
        f"{out['save_ms']:.3f} ms a save, {out['load_ms']:.3f} ms a load; "
        f"sweep.nan at fixed point #{ENTROPY_NAN_AT}: cell "
        f"{out['nan_cell']} stopped at lambda {lam} as non-converged, exit 0")
    return out


def phase_stream_durable(tmp: str) -> dict:
    """The ``stream`` CLI at phase 38's shape (n = 65,536, R = 1024, its
    device budget) with churn (``--churn-rate 64``), 4 steps: uninterrupted,
    then with ``--checkpoint``: a graceful-shutdown request at the 3rd
    ``chunk.boundary`` (exit 75), resumed (the journaled churn replayed).
    Equal bit for bit; KB's launches over both legs = chunks × steps."""
    W = STREAM_R // 32
    g = graphs.powerlaw_graph(STREAM_N, gamma=2.2, dmin=2, seed=0)
    steps = 4
    base = ["stream", "--n", str(STREAM_N), "--gamma", "2.2", "--replicas",
            str(STREAM_R), "--steps", str(steps), "--device-budget",
            str(_stream_budget(g, W)), "--churn-rate", "64", "--churn-seed",
            "3", "--device", "cuda"]
    ref = os.path.join(tmp, "stream_ref.npz")
    doc, _ = _run_cli(base + ["--out", ref])
    ck, npz = os.path.join(tmp, "stream", "run"), os.path.join(tmp,
                                                                "stream.npz")
    argv = base + ["--checkpoint", ck, "--checkpoint-interval", "0",
                   "--out", npz]
    bucketed_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    with _CkptCost() as cost:
        _cli_signalled(argv, "chunk.boundary", 3)
        if _cli_rc(argv) != 0:
            raise AssertionError("stream: the resumed run failed")
    wall = time.perf_counter() - t0
    launches = bucketed_cuda.LAUNCHES
    with np.load(ref) as f:
        _same_npz(npz, {"conf": f["conf"], "m_end": f["m_end"]}, "stream CLI")
    if launches != doc["chunks"] * steps or doc["mutations"] <= 0:
        raise AssertionError(f"stream: {launches} KB launches over both legs "
                             f"for {doc['chunks']} chunks x {steps} steps "
                             f"({doc['mutations']} mutations)")
    _, problems = tstore.validate_journal(tstore.journal_path_for(ck))
    if problems:
        raise AssertionError(f"stream journal: {problems}")
    out = {"wall_s": wall, "launches": launches, "chunks": doc["chunks"],
           "mutations": doc["mutations"], **cost.report()}
    log(f"[45 stream durable] stream CLI n={STREAM_N} R={STREAM_R}, "
        f"{steps} steps, churn ({doc['mutations']} mutations): exit 75 at "
        f"chunk.boundary #3, resumed with the journaled churn: equal bit for "
        f"bit; KB launches over both legs {launches} = {doc['chunks']} "
        f"chunks x {steps} steps; {wall:.3f} s; {out['saves']} snapshots of "
        f"{out['bytes']} B, {out['save_ms']:.3f} ms a save, "
        f"{out['load_ms']:.3f} ms a load")
    return out


def phase_temper_fused_durable(config1: dict, tmp: str) -> dict:
    """The ``temper`` CLI at its defaults, cut as phase 29 cuts it, with
    ``--checkpoint``: a graceful-shutdown request at the 4th swap boundary
    (exit 75), resumed: equal to an uninterrupted run bit for bit. Then
    ``fused`` at config 1 with ``--deadline 0.01``: exit 75 at its first
    chunk; the same command without the deadline equals phase 8's run (b)
    bit for bit (the chain re-derives from the seed)."""
    base = ["temper", "--device", "cuda", "--max-steps",
            str(TEMPER_MAIN_STEPS)]
    ref = os.path.join(tmp, "temper_ref.npz")
    _run_cli(base + ["--out", ref])
    ck, npz = os.path.join(tmp, "temper", "run"), os.path.join(tmp,
                                                                "temper.npz")
    argv = base + ["--checkpoint", ck, "--checkpoint-interval", "0",
                   "--out", npz]
    t0 = time.perf_counter()
    with _CkptCost() as cost:
        _cli_signalled(argv, "chunk.boundary", 4)
        if _cli_rc(argv) != 0:
            raise AssertionError("temper: the resumed run failed")
    wall = time.perf_counter() - t0
    with np.load(ref) as f:
        _same_npz(npz, {k: f[k] for k in f.files}, "temper CLI")
    out = {"wall_s": wall, **cost.report()}
    fused = ["fused", "--device", "cuda"] + [
        a for k, v in CONFIG1_RUNS["b"].items()
        for a in (f"--{k.replace('_', '-')}", str(v))]
    rc = _cli_rc(["--deadline", "0.01"] + fused)
    if rc != EX_TEMPFAIL:
        raise AssertionError(f"fused --deadline: exit {rc}, not 75")
    again = os.path.join(tmp, "fused.npz")
    _run_cli(fused + ["--out", again])
    want = config1["results"]["b"]
    with np.load(again) as f:
        if not (np.array_equal(f["conf"], want.s)
                and np.array_equal(f["steps_to_target"],
                                   want.steps_to_target)):
            raise AssertionError("fused: the rerun after --deadline != "
                                 "phase 8's run")
    log(f"[46 temper/fused durable] temper CLI defaults (--max-steps "
        f"{TEMPER_MAIN_STEPS}): exit 75 at swap boundary #4, resumed: equal "
        f"bit for bit, {wall:.3f} s; {out['saves']} snapshots of "
        f"{out['bytes']} B, {out['save_ms']:.3f} ms a save, "
        f"{out['load_ms']:.3f} ms a load; fused config 1 --deadline 0.01: "
        f"exit 75, rerun == phase 8's run (b)")
    return out


def phase_supervised(tmp: str) -> dict:
    """``python -m graphdyn_torch run-supervised -- sa ...`` (RRG(10⁴, 4),
    p=3, 3 repetitions of 1000 steps, serial, ``--checkpoint``) with
    ``GRAPHDYN_FAULT_PLAN`` killing each episode after its 2nd repetition:
    the supervisor restarts from the snapshot (its episodes real child
    processes) and the result equals the uninterrupted run; then a crash at
    every episode's first chunk boundary is a loop: quarantined, exit 86
    (the supervisor's in-process episodes). Each killed episode leaves its
    flight post-mortem, which names its crash site and which the supervisor
    keeps as evidence. Then the ``pallas.lower`` site injected into the
    ``hpr`` CLI: the run raises, no result is written, a post-mortem is."""
    sa = ["sa", "--device", "cuda", "--n-stat", "3", "--max-steps", "1000",
          "--group-size", "0"]
    ref = os.path.join(tmp, "sup_ref")
    _run_cli(sa + ["--out", ref])
    out_p = os.path.join(tmp, "sup")
    env_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = HERE + (os.pathsep + env_path if env_path
                                       else "")
    t0 = time.perf_counter()
    try:
        with _fault_env([{"site": "rep.boundary", "action": "preempt",
                          "at": 2}]):
            rc = _cli_rc(["run-supervised", "--backoff-base", "0.01",
                          "--workdir", os.path.join(tmp, "w"), "--", *sa,
                          "--checkpoint", os.path.join(tmp, "sup", "run"),
                          "--checkpoint-interval", "0", "--out", out_p])
    finally:
        if env_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = env_path
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"run-supervised: exit {rc}")
    with np.load(ref + ".npz") as f:
        _same_npz(out_p + ".npz", {k: f[k] for k in f.files}, "run-supervised")
    # each killed episode left its flight post-mortem, which the supervisor
    # keeps as evidence
    kept = sorted(f for f in os.listdir(os.path.join(tmp, "w", "supervise"))
                  if f.startswith("postmortem.ep"))
    if not kept:
        raise AssertionError("run-supervised: no post-mortem in the evidence")
    pol = supervisor.RestartPolicy(backoff=RetryPolicy(
        tries=4, base_delay_s=0.01, max_delay_s=0.02, jitter=True))
    with _fault_env([{"site": "chunk.boundary", "action": "preempt",
                      "at": 1, "count": 99}]):
        rep = supervisor.supervise(
            sa + ["--checkpoint", os.path.join(tmp, "loop", "run")],
            workdir=os.path.join(tmp, "w2"), policy=pol,
            runner=supervisor.run_inprocess)
    if rep["exit"] != supervisor.EX_QUARANTINE or len(rep["episodes"]) != 3:
        raise AssertionError(f"crash loop: {rep['exit']}, "
                             f"{len(rep['episodes'])} episodes")
    _, problems = tstore.validate_journal(rep["journal"])
    if problems:
        raise AssertionError(f"supervisor journal: {problems}")
    if not all("postmortem" in ep and not ep["site"].startswith("exit:")
               for ep in rep["episodes"]):
        raise AssertionError(f"crash loop: episodes without a post-mortem "
                             f"site: {rep['episodes']}")
    hpr_out = os.path.join(tmp, "lower.npz")
    wd = os.path.join(tmp, "lower")
    os.makedirs(wd)
    old = os.getcwd()
    os.chdir(wd)                    # where the run's post-mortem lands
    try:
        with _fault_env([{"site": "pallas.lower", "action": "raise",
                          "count": 99}]):
            try:
                _cli_rc(["hpr", "--device", "cuda", "--out", hpr_out])
            except faults.InjectedLoweringError:
                pass
            else:
                raise AssertionError("pallas.lower: the hpr run completed")
    finally:
        os.chdir(old)
    if os.path.exists(hpr_out):
        raise AssertionError("pallas.lower: a result was written")
    if not os.path.exists(os.path.join(wd, obs_flight.POSTMORTEM_NAME)):
        raise AssertionError("pallas.lower: no flight post-mortem")
    log(f"[47 supervised] run-supervised -- sa (3 reps, killed after the "
        f"2nd rep of each episode): restarted and completed, equal to the "
        f"uninterrupted run, {wall:.3f} s; a crash loop at the first chunk "
        f"boundary: quarantined after {len(rep['episodes'])} episodes, exit "
        f"{rep['exit']}, each episode's post-mortem site "
        f"{rep['episodes'][0]['site']}; the restarted run's evidence holds "
        f"{len(kept)} post-mortem(s) ({', '.join(kept)}); pallas.lower "
        f"injected into hpr: the run raised, no result (the port never "
        f"carries on in the plain version), a post-mortem")
    return {"wall_s": wall, "quarantine_exit": rep["exit"],
            "postmortems": kept}


# ---------------------------------------------------------------------------
# telemetry (A17): the ledger, the profiler trace, the cost of recording,
# the memory gauges and memcheck, the roofline check, the flight post-mortem
# ---------------------------------------------------------------------------


def _npz_same(a: str, b: str, label: str, skip=()) -> None:
    """``a`` and ``b`` hold the same arrays bit for bit (``skip``: wall-clock
    keys)."""
    with np.load(a) as fa, np.load(b) as fb:
        if sorted(fa.files) != sorted(fb.files):
            raise AssertionError(f"{label}: npz keys {fa.files} vs {fb.files}")
        for k in fa.files:
            if k not in skip and not np.array_equal(fa[k], fb[k]):
                raise AssertionError(f"{label}: {k} differs with telemetry on")


def _chunk_windows(events: list, ledger: list, chunk: str,
                   label: str) -> dict:
    """Hold the chrome trace of a ``--profile`` run to its ledger: every
    K3′ launch (the host's launch call, joined to its kernel by the trace's
    correlation id; the kernel's own start where the launch call is not in
    the trace) lies inside one of the ``record_function`` ranges named with
    a ``... > chunk`` path, the ranges are the ledger's chunk spans one for
    one, and each span's ``wall_s`` is at least the device time of the K3′
    kernels launched inside it: the span closes after the card. The host
    and device clocks of the trace are aligned only to some µs, so a
    kernel's end is compared with its range's end only as a reported
    excursion."""
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = []
    joined = 0
    for e in events:
        if e.get("cat") == "kernel" and "bdcm_sweep_kernel" in e.get("name",
                                                                      ""):
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            joined += ts is not None
            kernels.append((e["ts"] if ts is None else ts, e["ts"],
                            e["ts"] + e["dur"]))
    kernels.sort()
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name", "").split(" > ")[-1] == chunk)
    spans = sorted((e for e in ledger if e.get("ev") == "span"
                    and e.get("name") == chunk), key=lambda e: e["t0"])
    if not kernels or not ranges:
        raise AssertionError(f"{label}: {len(kernels)} K3′ kernel events, "
                             f"{len(ranges)} {chunk} ranges in the trace")
    if len(ranges) != len(spans):
        raise AssertionError(f"{label}: {len(ranges)} {chunk} ranges in the "
                             f"trace, {len(spans)} spans in the ledger")
    paths = {r[2] for r in ranges}
    ledger_paths = set(obs_report.summarize(ledger)["spans"])
    if not paths <= ledger_paths:
        raise AssertionError(f"{label}: trace ranges {paths - ledger_paths} "
                             f"are no ledger span paths")
    dev_us = [0.0] * len(ranges)
    outside = 0
    late_us = 0.0
    j = 0
    for launch, k0, k1 in kernels:
        while j < len(ranges) and ranges[j][1] < launch:
            j += 1
        if j < len(ranges) and ranges[j][0] <= launch:
            dev_us[j] += k1 - k0
            late_us = max(late_us, k1 - ranges[j][1])
        else:
            outside += 1
    if outside:
        raise AssertionError(f"{label}: {outside} of {len(kernels)} K3′ "
                             f"launches outside every {chunk} range "
                             f"({joined} joined to their launch calls)")
    short = [(i, sp["wall_s"], d / 1e6) for i, (sp, d)
             in enumerate(zip(spans, dev_us)) if sp["wall_s"] * 1e6 < d]
    if short:
        raise AssertionError(f"{label}: chunk spans shorter than their K3′ "
                             f"device time (index, wall_s, device_s): "
                             f"{short[:5]}")
    wall = sum(sp["wall_s"] for sp in spans)
    return {"kernels": len(kernels), "joined": joined, "chunks": len(ranges),
            "paths": sorted(paths), "chunk_wall_s": wall,
            "k3_device_s": sum(dev_us) / 1e6,
            "k3_share_of_chunk_wall": sum(dev_us) / 1e6 / wall,
            "max_kernel_end_past_range_us": late_us,
            "min_span_over_device": min(
                sp["wall_s"] * 1e6 / d for sp, d in zip(spans, dev_us) if d)}


def _telemetry_leg(argv: list, tmp: str, label: str, chunk: str,
                   skip=()) -> dict:
    """``argv`` (a CLI with ``--out``) plain, then with ``--obs-ledger`` and
    ``--profile``: the same result bit for bit, a ledger that parses with a
    manifest naming the card, and the trace held to it
    (:func:`_chunk_windows`)."""
    plain_out = os.path.join(tmp, f"{label}_plain")
    obs_out = os.path.join(tmp, f"{label}_obs")
    ledger = os.path.join(tmp, f"{label}.jsonl")
    pdir = os.path.join(tmp, f"{label}_prof")
    doc0, wall0 = _run_cli(argv + ["--out", plain_out])
    # the allocator's peak restarts here, so the run's obs.mem.peak gauges
    # read this run's peak over what the script already holds (base)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    doc1, wall1 = _run_cli(["--obs-ledger", ledger, "--profile", pdir, *argv,
                            "--out", obs_out])
    for k in doc0:
        if k not in skip and k != "out" and doc0[k] != doc1[k]:
            raise AssertionError(f"{label}: printed {k} differs with "
                                 f"telemetry on")
    _npz_same(plain_out + ".npz", obs_out + ".npz", label, skip)
    events, torn = obs_read_ledger(ledger)
    man = next(e["run"] for e in events if e.get("ev") == "manifest")
    if torn or man.get("device_name") != torch.cuda.get_device_name(0) \
            or not man.get("power_limit"):
        raise AssertionError(f"{label}: ledger torn {torn}, manifest {man}")
    (path,) = obs_trace.trace_files(pdir)
    with open(path) as f:
        trace_events = json.load(f)["traceEvents"]
    held = _chunk_windows(trace_events, events, chunk, label)
    summary = obs_report.summarize(events)
    held.update(wall_s=wall0, profiled_wall_s=wall1,
                trace_bytes=os.path.getsize(path), events=len(events),
                counters=sorted(summary["counters"]),
                gauges=sorted(summary["gauges"]),
                mem_peak=summary["gauges"].get("obs.mem.peak", {}).get("max"),
                mem_base=base)
    log(f"[48 obs ledger] {label}: output equal with --obs-ledger and "
        f"--profile; ledger {len(events)} events, manifest "
        f"{man['device_name']}, {man['power_limit']}; {held['kernels']} K3′ "
        f"launches ({held['joined']} joined to their launch calls) inside "
        f"the {held['chunks']} {chunk} ranges "
        f"({', '.join(held['paths'])}), each span's wall >= its K3′ device "
        f"time (min ratio {held['min_span_over_device']:.3f}; K3′ "
        f"{held['k3_device_s']:.4f} s of {held['chunk_wall_s']:.4f} s of "
        f"chunk wall; a kernel's end at most "
        f"{held['max_kernel_end_past_range_us']:.1f} us past its range's on "
        f"the trace's clocks); walls {wall0:.3f} s plain, {wall1:.3f} s "
        f"profiled; "
        f"trace {held['trace_bytes']} B; peak gauge {held['mem_peak']}")
    return held


def phase_obs_ledger(tmp: str) -> dict:
    """Phase 48: the ``hpr`` CLI (the reference shape, f32, its sweeps cut
    to :data:`OBS_HPR_SWEEPS`) and the ``entropy`` CLI (λ ≤
    :data:`OBS_ENTROPY_LMBD_MAX`) with ``--obs-ledger`` and ``--profile``
    (:func:`_telemetry_leg`)."""
    return {
        "hpr": _telemetry_leg(["hpr", "--device", "cuda", "--max-sweeps",
                               str(OBS_HPR_SWEEPS)], tmp, "hpr",
                              "pipeline.hpr.chunk", skip=("time",)),
        "entropy": _telemetry_leg(
            ["entropy", "--device", "cuda", "--lmbd-max",
             str(OBS_ENTROPY_LMBD_MAX)], tmp, "entropy",
            "pipeline.entropy.chunk")}


def phase_obs_cost(tmp: str) -> dict:
    """Phase 49: what recording costs, on and off in turns
    (:data:`OBS_REPEATS` legs of each, medians of the warm chunks), with the
    ledger installed by ``obs.recording`` as ``--obs-ledger`` installs it:
    the HPr reference's ms per sweep through its chunk loop
    (``HPRGroupExec.run``: RRG(10⁴, 4), f32, chunks of
    :data:`OBS_HPR_CHUNK` sweeps, :data:`OBS_HPR_SWEEPS` sweeps), and the
    ``sa`` default chunk's µs per step through the grouped chunk loop
    (``run_sa_group`` on the CLI's default ensemble, 5 × RRG(10⁴, 4), p=3,
    c=1, chunks of 256 steps replayed from a CUDA graph,
    :data:`OBS_SA_STEPS` steps). A chunk's time is the host clock between
    two ``on_chunk`` calls, each after the chunk's host read; the first
    (cold) chunk of a leg and its last (partial) one are left out. The SA on-legs' ledgers give the
    ``sa.chunk`` memory gauges."""
    cfg = SAConfig(dynamics=DynamicsConfig(p=3, c=1))
    graphs_ = [random_regular_graph(10_000, 4, seed=k) for k in range(5)]
    preps = [sa_models.prepare_sa_inputs(g, cfg, n_replicas=1, seed=k,
                                         max_steps=OBS_SA_STEPS)
             for k, g in enumerate(graphs_)]
    hcfg = HPRConfig(max_sweeps=OBS_HPR_SWEEPS)
    item = hpr_group._build_rep(HPR_N, HPR_D, hcfg, 0, "pairing")
    hex_ = HPRGroupExec([item], hcfg, device="cuda")

    def warm_chunks(run):
        stamps = []
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        res = run(lambda *_: stamps.append(time.perf_counter()))
        return np.diff(stamps)[1:-1], res

    def hpr_leg():
        st = hex_.init_state([item[2]], [item[3]], [item[4]], [0])
        dt, st = warm_chunks(lambda cb: hex_.run(
            st, chunk_sweeps=OBS_HPR_CHUNK, on_chunk=cb))
        return dt * 1e3 / OBS_HPR_CHUNK, st.s.cpu().numpy()

    def sa_leg():
        dt, res = warm_chunks(lambda cb: sa_group.run_sa_group(
            graphs_, preps, list(range(5)), cfg, group_size=5,
            on_chunk=cb, device="cuda"))
        return dt * 1e6 / sa_models.CHUNK_STEPS, res.s

    legs = {"hpr_ms_per_sweep": ([], [], hpr_leg, "ms/sweep"),
            "sa_us_per_step": ([], [], sa_leg, "us/step")}
    mem_sa = []
    first: dict = {}
    for i in range(OBS_REPEATS):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            for name, (on_v, off_v, leg, _) in legs.items():
                path = os.path.join(tmp, f"cost_{name}_{i}.jsonl")
                if on and name == "sa_us_per_step":
                    # the SA loop's own peak: restart the allocator's peak
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    sa_base = torch.cuda.memory_allocated()
                with (obs.recording(path) if on
                      else contextlib.nullcontext()):
                    per, out = leg()
                (on_v if on else off_v).append(float(np.median(per)))
                if on and name == "sa_us_per_step":
                    mem_sa += [e["value"] - sa_base
                               for e in obs_read_ledger(path)[0]
                               if e.get("name") == "obs.mem.peak"]
                if not np.array_equal(first.setdefault(name, out), out):
                    raise AssertionError(f"{name}: a leg's chains differ "
                                         f"with recording "
                                         f"{'on' if on else 'off'}")
    res = {}
    for name in ("hpr_ms_per_sweep", "sa_us_per_step"):
        on_v, off_v, _, unit = legs[name]
        on, off = float(np.median(on_v)), float(np.median(off_v))
        res[name] = {"on": on_v, "off": off_v, "median_on": on,
                     "median_off": off, "cost": on / off - 1.0}
        log(f"[49 obs cost] {name}: recording on median {on:.5f} {unit}, "
            f"off {off:.5f} {unit} ({OBS_REPEATS} legs each, in turns, "
            f"each the median of its warm chunks): cost "
            f"{100 * (on / off - 1.0):+.2f}% (on {[round(v, 5) for v in on_v]}"
            f", off {[round(v, 5) for v in off_v]})")
    # the SA loop's obs.mem.peak over the bytes held when its leg began
    res["sa_mem_peak"] = max(mem_sa) if mem_sa else None
    # what one recorded chunk boundary pays, piece by piece (µs per call,
    # 200 calls each): the allocator's stats, one event written and flushed
    # to a ledger in this directory, one host read of a chunk state's steps
    # and live chains
    st = torch.zeros(5, dtype=torch.int32, device="cuda")
    live = torch.ones(5, dtype=torch.bool, device="cuda")
    rec = obs.Recorder(os.path.join(tmp, "pieces.jsonl"))
    pieces = {"memory_stats": lambda: obs.memband.device_memory_stats(),
              "event": lambda: rec.gauge("obs.mem.peak", 1, loop="sa.chunk"),
              "host_read": lambda: torch.stack(
                  [st.max().to(torch.int64), live.sum()]).tolist()}
    res["pieces_us"] = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        res["pieces_us"][name] = (time.perf_counter() - t0) / 200 * 1e6
    rec.close()
    log(f"[49 obs cost] one recorded chunk boundary's pieces, us per call: "
        f"{ {k: round(v, 2) for k, v in res['pieces_us'].items()} }")
    return res


def _obs_cli(sub: str) -> tuple[int, list]:
    """``python -m graphdyn_torch.obs <sub> --format=json`` on the card:
    its exit code (the findings) and its rows."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, "-m", "graphdyn_torch.obs", sub,
                           "--format=json"], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode > 100 or not proc.stdout.strip():
        raise AssertionError(f"obs {sub}: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    return proc.returncode, json.loads(proc.stdout)


def phase_obs_memory(ledgers: dict, cost: dict) -> dict:
    """Phase 50: the ``obs.mem.peak`` gauges of the chunk loops (HPr and
    entropy from phase 48's ledgers, SA from phase 49's), each read as its
    loop's own peak over the bytes the script held when the allocator's
    peak was restarted at the loop's start (the stream loop emits none, as
    in the JAX package: its device bytes are memcheck's ``streamed_chunk``
    row), and ``python -m graphdyn_torch.obs memcheck`` on the card, each
    program's own peak against its byte model."""
    rc, rows = _obs_cli("memcheck")
    for r in rows:
        if r["measured"] is None:
            log(f"[50 obs memory] memcheck {r['program']}: model "
                f"{r['model']:.0f} B, measured null ({r['reason']})")
        else:
            log(f"[50 obs memory] memcheck {r['program']}: peak "
                f"{r['measured']} B, model {r['model']:.0f} B, frac "
                f"{r['frac']:.4f} (band [{r['lo']}, {r['hi']}]) "
                f"{'ok' if r['ok'] else 'OUT OF BAND'}")
    if rc:
        raise AssertionError(f"memcheck: {rc} row(s) out of band")
    if None in (ledgers["hpr"]["mem_peak"], ledgers["entropy"]["mem_peak"],
                cost["sa_mem_peak"]):
        raise AssertionError("obs.mem.peak gauges missing")
    # each loop's own peak: its gauges' max over the bytes the script held
    # when the allocator's peak was restarted at the loop's start
    gauges = {"hpr.chunk": ledgers["hpr"]["mem_peak"]
              - ledgers["hpr"]["mem_base"],
              "entropy.chunk": ledgers["entropy"]["mem_peak"]
              - ledgers["entropy"]["mem_base"],
              "sa.chunk": cost["sa_mem_peak"]}
    if min(gauges.values()) <= 0:
        raise AssertionError(f"obs.mem.peak under the held bytes: {gauges}")
    log(f"[50 obs memory] obs.mem.peak gauges, each loop's own peak over "
        f"the bytes held at its start (B): {gauges}; held "
        f"{ledgers['hpr']['mem_base']} / {ledgers['entropy']['mem_base']} B "
        f"at the hpr / entropy runs")
    return {"memcheck": rows, "memcheck_rc": rc, "mem_peak": gauges}


def phase_obs_roofline() -> dict:
    """Phase 51: ``python -m graphdyn_torch.obs check`` on the card, with
    the H100 profile: the packed rollout (K1/K2′), a BDCM sweep (K3′) and
    the grouped entropy chunk at the smoke shapes against the byte models
    over 3.35 TB/s."""
    rc, rows = _obs_cli("check")
    if len(rows) != 3:
        raise AssertionError(f"obscheck: {len(rows)} rows (no H100 profile?)")
    for r in rows:
        log(f"[51 obs roofline] {r['program']}: {r['measured']:.6e} "
            f"{r['unit']}, model {r['model']:.6e}, frac {r['frac']:.6f} "
            f"(band [{r['lo']}, {r['hi']}]) "
            f"{'ok' if r['ok'] else 'OUT OF BAND'}")
    if rc:
        raise AssertionError(f"obscheck: {rc} program(s) out of band")
    return {"rows": rows, "rc": rc}


def phase_obs_flight(tmp: str) -> dict:
    """Phase 52: an ``hpr`` run killed by an injected fault (``raise`` at its
    first ``rep.boundary``) leaves ``obs_postmortem.jsonl`` in its working
    directory, with the ``obs.crash`` event naming the fault; the same run
    with ``--obs-ledger`` leaves the event in the ledger and no file."""
    out = {}
    argv = ["hpr", "--device", "cuda", "--max-sweeps", "200"]
    for mode in ("postmortem", "ledger"):
        wd = os.path.join(tmp, f"flight_{mode}")
        os.makedirs(wd)
        ledger = os.path.join(wd, "run.jsonl")
        old = os.getcwd()
        os.chdir(wd)
        try:
            with _fault_env([{"site": "rep.boundary", "action": "raise",
                              "at": 1}]):
                try:
                    _cli_rc((["--obs-ledger", ledger] if mode == "ledger"
                             else []) + argv)
                except faults.InjectedFault:
                    pass
                else:
                    raise AssertionError("flight: the hpr run completed")
        finally:
            os.chdir(old)
        pm = os.path.join(wd, obs_flight.POSTMORTEM_NAME)
        events = obs_read_ledger(pm if mode == "postmortem" else ledger)[0]
        crash = [e for e in events if e.get("name") == "obs.crash"]
        if len(crash) != 1 or os.path.exists(pm) != (mode == "postmortem"):
            raise AssertionError(f"flight {mode}: {len(crash)} obs.crash "
                                 f"events, post-mortem file "
                                 f"{os.path.exists(pm)}")
        out[mode] = crash[0]["attrs"]
        log(f"[52 obs flight] hpr killed at rep.boundary ({mode}): obs.crash "
            f"{crash[0]['attrs']['exc_type']} at {crash[0]['attrs']['site']}"
            f", heartbeat {crash[0]['attrs'].get('heartbeat_where')}; "
            f"{len(events)} events")
    return out


def phase_obs(tmp: str) -> dict:
    """The telemetry group (phases 48-52)."""
    ledgers = phase_obs_ledger(tmp)
    cost = phase_obs_cost(tmp)
    return {"ledger": ledgers, "cost": cost,
            "memory": phase_obs_memory(ledgers, cost),
            "roofline": phase_obs_roofline(),
            "flight": phase_obs_flight(tmp)}


# ---------------------------------------------------------------------------
# node-axis sharding over torch.distributed (the parallel group)
# ---------------------------------------------------------------------------


def _shard_bound(tables, p: int, W: int) -> dict:
    """The least time of one K1/K2′ launch on shard ``p`` of ``tables``:
    the rows the function needs read once (its real owned rows and every
    other row that one of them has as a neighbour: real ghosts, hubs, the
    zero row), its real owned rows written once, the neighbour indices of
    those rows (it loops to each row's degree) and their degrees, over HBM
    bandwidth; the logic of those rows over the INT32 rate."""
    from graphdyn_torch.obs.roofline import INT32_OPS_PER_S, majority_ops

    cnt = int(tables.counts[p])
    deg = tables.deg_loc[p, :cnt].astype(np.int64)
    nbr = tables.nbr_loc[p, :cnt]
    used = nbr[np.arange(nbr.shape[1])[None, :] < deg[:, None]]
    reads = cnt + int(np.unique(used[used >= cnt]).size)
    nbytes = 4 * W * (reads + cnt) + 4 * int(deg.sum()) + 4 * cnt
    ops = majority_ops(W, deg)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    return {"bytes": nbytes, "rows_read": reads, "ops": ops,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / INT32_OPS_PER_S else "operations")}


def phase_shard_step_parity(cases) -> dict:
    """K1/K2′'s launch on the halo shard layout against its plain twin, bit
    for bit, for every (rule, tie) on every shard of each partition in
    ``cases`` (``(label, graph, partition, W)``), into a buffer of sentinel
    words that must keep them past the real owned rows; then its ms per
    launch on the widest shard of the first (CUDA events) beside the plain
    twin's and the bound."""
    from graphdyn_torch.parallel import halo as ph

    out = {"cases": []}
    for label, g, part, W in cases:
        t = ph.build_halo_tables(g, part)
        sp = _random_words(g.n, W, 5).cpu()
        from graphdyn_torch.interop import words_to_numpy, words_from_numpy

        sp_h = words_to_numpy(sp)
        for p in range(t.P):
            src_h = words_from_numpy(ph.scatter_shard(t, sp_h, p))
            src = src_h.cuda()
            nbr = torch.as_tensor(t.nbr_loc[p], device="cuda")
            deg = torch.as_tensor(t.deg_loc[p], device="cuda")
            for rule, tie in RULE_TIES:
                step = ph.ShardStep(nbr, deg, n_update=int(t.counts[p]),
                                    rule=rule, tie=tie)
                got = step(src, torch.full_like(src, 0x5A5A5A5A))
                want = ph.shard_step_plain(nbr, deg, src,
                                           torch.full_like(src, 0x5A5A5A5A),
                                           n_update=int(t.counts[p]),
                                           rule=rule, tie=tie)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"shard-layout K1/K2' != plain twin: {label} shard "
                        f"{p} {rule}/{tie}")
            out["cases"].append({"label": label, "shard": p,
                                 "rows": t.n_rows, "real": int(t.counts[p]),
                                 "pad_rows": t.n_local_max - int(t.counts[p]),
                                 "ghosts": int(t.ghost_counts[p]),
                                 "hubs": t.n_hubs})
        if "ms" not in out:
            p = int(np.argmax(t.counts + t.ghost_counts))
            src = words_from_numpy(ph.scatter_shard(t, sp_h, p)).cuda()
            dst = src.clone()
            nbr = torch.as_tensor(t.nbr_loc[p], device="cuda")
            deg = torch.as_tensor(t.deg_loc[p], device="cuda")
            step = ph.ShardStep(nbr, deg, n_update=int(t.counts[p]),
                                rule="majority", tie="stay")
            step(src, dst)
            out["ms"] = _cuda_ms(lambda: step(src, dst), 20)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ph.shard_step_plain(nbr, deg, src, dst,
                                n_update=int(t.counts[p]))
            end.record()
            torch.cuda.synchronize()
            out["plain_ms"] = start.elapsed_time(end)
            out.update(_shard_bound(t, p, W))
            out["shape"] = (f"{label}: shard {p} of {t.P}, [{t.n_rows}, {W}] "
                            f"({int(t.counts[p])} real owned rows, "
                            f"{t.n_local_max - int(t.counts[p])} pad, "
                            f"{int(t.ghost_counts[p])} ghosts)")
            del src, dst
    log(f"[53 shard step] K1/K2' on the halo shard layout == its plain twin "
        f"bit for bit and writes no row past the real owned ones, 4 (rule, "
        f"tie) x every shard of {[c[0] for c in cases]}; {out['shape']}: "
        f"{out['ms']} ms/launch, plain {out['plain_ms']} ms, bound "
        f"{out['bound_ms']} ms ({out['bound_by']}: {out['bytes']} B, "
        f"{out['rows_read']} rows read); library_ms null (no single PyTorch "
        f"call computes a packed majority step)")
    return out


def _par_inputs(tmp: str, ctx: dict) -> dict:
    """The inputs the spawned ranks read from ``tmp``: the headline and
    config-3 graphs and partitions, the small SA graph and its streams."""
    import pickle

    t0 = time.perf_counter()
    part_h = graphs.partition_graph(ctx["g_h"], 2, seed=0)
    t_part_h = time.perf_counter() - t0
    g_e = ctx["config3"][0]
    t0 = time.perf_counter()
    part_e = graphs.partition_graph(g_e, 2, seed=0)
    t_part_e = time.perf_counter() - t0
    g_sa = random_regular_graph(PAR_SA_N, 3, seed=2)
    rng = np.random.default_rng(3)
    s0 = np.where(rng.random((PAR_SA_R, PAR_SA_N)) < 0.6, 1, -1
                  ).astype(np.int8)
    prop = rng.integers(0, PAR_SA_N, size=(PAR_SA_R, PAR_SA_L)
                        ).astype(np.int32)
    unif = rng.random(size=(PAR_SA_R, PAR_SA_L))
    inputs = {"g_h": ctx["g_h"], "part_h": part_h, "g_e": g_e,
              "part_e": part_e, "g_sa": g_sa, "s0": s0, "prop": prop,
              "unif": unif, "ckpt": os.path.join(tmp, "ck", "sa")}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f, protocol=4)
    inputs["part_s"] = {"headline": t_part_h, "config3": t_part_e}
    return inputs


def _par_rank(rank: int, world: int, tmp: str) -> dict:
    """One spawned rank of the parallel group's P=2 legs (two ranks sharing
    the card over gloo, :func:`graphdyn_torch.scripts.halo_ranks.
    run_ranks`): the headline and config-3 halo rollouts, the sharded
    consensus at the headline width, the sharded SA in its gather and halo
    modes under injected streams, and a checkpointed run that is preempted
    at its second chunk boundary."""
    import pickle

    from graphdyn_torch.parallel.mesh import make_mesh
    from graphdyn_torch.parallel.sa_sharded import sa_sharded
    from graphdyn_torch.scripts.halo_ranks import halo_leg

    res = {}
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh((1, world), ("replica", "node"), device="cuda")
    for key, g, part, W, seed, label in (
            ("headline", inp["g_h"], inp["part_h"], HEADLINE_R // 32, 1,
             "headline"),
            ("config3", inp["g_e"], inp["part_e"], CONFIG3_R // 32, 3,
             "config 3")):
        res[key] = halo_leg(g, part, W, seed, mesh, label, steps=PAR_STEPS,
                            timed=PAR_TIMED_STEPS)
    buf = io.StringIO()
    packed_cuda.LAUNCHES = 0
    with contextlib.redirect_stdout(buf):
        rc = cli.main(PAR_CONSENSUS_ARGV + ["--sharded"])
    res["consensus"] = {"rc": rc, "out": buf.getvalue(),
                        "launches": packed_cuda.LAUNCHES}
    cfg = _sa_config()
    for mode in ("gather", "halo"):
        t0 = time.perf_counter()
        r = sa_sharded(inp["g_sa"], cfg, mesh=mesh, s0=inp["s0"],
                       proposals=inp["prop"], uniforms=inp["unif"],
                       node_mode=mode, chunk_steps=64, device="cuda")
        res[f"sa_{mode}"] = {f: getattr(r, f) for f in r._fields}
        res[f"sa_{mode}"]["wall_s"] = time.perf_counter() - t0
    plan = faults.FaultPlan([faults.FaultSpec("chunk.boundary", "preempt",
                                              at=2)])
    try:
        with plan:
            sa_sharded(inp["g_sa"], cfg, mesh=mesh, s0=inp["s0"],
                       proposals=inp["prop"], uniforms=inp["unif"],
                       node_mode="halo", chunk_steps=64,
                       checkpoint_path=inp["ckpt"],
                       checkpoint_interval_s=0.0, device="cuda")
        res["preempt"] = "finished"
    except faults.InjectedPreemption:
        res["preempt"] = "preempted"
    return res


def _same_result(got: dict, want, what: str) -> None:
    for f in ("s", "num_steps", "m_final", "mag_reached"):
        if not np.array_equal(np.asarray(got[f]), np.asarray(getattr(want, f))):
            raise AssertionError(f"{what}: {f} differs from its twin")


def phase_config5_lightcone(tmp: str) -> dict:
    """Config 5's single-card width as a user runs it: ``sa --sharded
    --rollout-mode lightcone`` through the CLI on the one-rank job, d=5
    RRG, n=10⁶, 1024 replicas on the CLI's ladder (``--ladder-max-frac``:
    a0 linear in [a0-frac, 4·a0-frac], one value per replica, where the
    configuration has 16 rungs of 64 replicas each), p=c=1, cut to
    CONFIG5_CHUNKS chunks of CONFIG5_CHUNK steps, with ``--obs-ledger``.
    µs per chain step (one step advances all 1024 replicas) from the
    ledger's ``pipeline.sa_sharded.chunk`` spans, and the call's peak
    device memory."""
    ledger = os.path.join(tmp, "config5.jsonl")
    a0_frac = _sa_config().a0_frac
    argv = ["--obs-ledger", ledger, "sa", "--sharded", "--rollout-mode",
            "lightcone", "--n", str(SCALE_N), "--d", str(SCALE_D), "--p",
            "1", "--c", "1", "--n-replicas", str(SCALE_R), "--a0-frac",
            str(a0_frac), "--ladder-max-frac", str(4 * a0_frac),
            "--max-steps", str(CONFIG5_CHUNKS * CONFIG5_CHUNK),
            "--chunk-steps", str(CONFIG5_CHUNK), "--seed", "0", "--device",
            "cuda"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    steps = np.asarray(doc["num_steps"])
    m_final = np.asarray(doc["m_final"], np.float64)
    if rc != 0 or doc["solver"] != "sa_sharded" \
            or doc["mesh"] != {"replica": 1, "node": 1} \
            or steps.shape != (SCALE_R,) or steps.max() < 1 \
            or steps.max() > CONFIG5_CHUNKS * CONFIG5_CHUNK + 1 \
            or not np.isfinite(m_final).all():
        raise AssertionError(f"config 5 sa --sharded: exit {rc}, solver "
                             f"{doc['solver']}, mesh {doc['mesh']}, steps "
                             f"{steps.max()}")
    spans = [e for e in obs_read_ledger(ledger)[0] if e.get("ev") == "span"]
    chunks = [e["wall_s"] for e in spans
              if e["name"] == "pipeline.sa_sharded.chunk"]
    (run,) = [e["wall_s"] for e in spans if e["name"] == "run"]
    loop_s = float(sum(chunks))
    us = loop_s / (len(chunks) * CONFIG5_CHUNK) * 1e6
    log(f"[56 config 5] {' '.join(argv[2:])}: {len(chunks)} chunks of "
        f"{CONFIG5_CHUNK} steps (chains stopped at {int(steps.max())}): "
        f"{us:.1f} us per step of all {SCALE_R} replicas (the chunk spans' "
        f"{loop_s:.3f} s, each chunk synchronised); the command {wall:.3f} s"
        f" ({run:.3f} s in its run span: graph, host light-cone tables, "
        f"placement, the trajectory cache, the chunks); peak device memory "
        f"{peak} B; m_final {sorted(set(m_final.tolist()))[:4]}")
    return {"wall_s": wall, "run_span_s": run, "steps": int(steps.max()),
            "us_per_step": us, "loop_s": loop_s, "chunks": len(chunks),
            "peak_bytes": peak}


def phase_parallel(ctx: dict) -> dict:
    """Node-axis sharding: the shard-layout launch against
    its twin; the P=2 legs on two spawned ranks sharing the card over gloo
    (the headline and config-3 halo rollouts, the sharded consensus, the
    sharded SA and a preempted SA run); the P=1 legs on a one-rank NCCL
    group in this process (the same rollouts and consensus, config 5's
    light-cone width, and the P=2 run resumed at P=1); memcheck's halo
    row."""
    import torch.distributed as dist

    from graphdyn_torch.obs import memband
    from graphdyn_torch.parallel.mesh import init_distributed, make_mesh
    from graphdyn_torch.parallel.sa_sharded import sa_sharded
    from graphdyn_torch.scripts.halo_ranks import halo_leg, run_ranks

    out = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        inp = _par_inputs(tmp, ctx)
        out["partition_s"] = inp["part_s"]
        out["shard_step"] = phase_shard_step_parity(
            [("headline P=2", ctx["g_h"], inp["part_h"], HEADLINE_R // 32),
             ("config 3 P=2", inp["g_e"], inp["part_e"], CONFIG3_R // 32),
             ("config 3 P=3", inp["g_e"],
              graphs.partition_graph(inp["g_e"], 3, seed=0), 3)])
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_ranks(_par_rank, 2, tmp, device="cuda", backend="gloo",
                          root=tmp, timeout=PAR_SPAWN_TIMEOUT_S)
        out["spawn_wall_s"] = time.perf_counter() - t0
        r0 = ranks[0]
        for leg in ("headline", "config3"):
            for r in ranks:
                if not r[leg]["equal"] \
                        or r[leg]["launches"]["shard"] != PAR_STEPS:
                    raise AssertionError(f"P=2 {leg}: {r[leg]}")
        log(f"[54 halo P=2] two ranks on one card over gloo (staged through "
            f"pinned host buffers), {PAR_STEPS} steps each, equal to the "
            f"unsharded K1/K2' rollout: "
            + "; ".join(
                f"{r0[k]['label']}: edge_cut {r0[k]['edge_cut']}, partition "
                f"{inp['part_s'][k]:.3f} s on the host, main path wall "
                f"{r0[k]['wall_s']:.3f} s, shard launches (rank 0/1) "
                f"{[r[k]['launches']['shard'] for r in ranks]}, per step "
                f"(median of {PAR_TIMED_STEPS} timed steps, rank 0 / 1) "
                f"step {[round(r[k]['step_ms'], 3) for r in ranks]} ms + "
                f"exchange {[round(r[k]['exchange_ms'], 3) for r in ranks]} "
                f"ms for "
                f"{r0[k]['halo_bytes_per_step']} B (halo_bytes_per_step; "
                f"{r0[k]['halo_rows']} useful rows, {r0[k]['slab_rows']} "
                f"shipped)" for k in ("headline", "config3"))
            + f"; spawn wall {out['spawn_wall_s']:.3f} s")
        init_distributed(world_size=1, rank=0, backend="nccl",
                         device="cuda")
        try:
            mesh1 = make_mesh((1, 1), ("replica", "node"), device="cuda")
            p1 = {}
            for k, g, W, seed in (("headline", ctx["g_h"], HEADLINE_R // 32,
                                   1), ("config3", inp["g_e"],
                                        CONFIG3_R // 32, 3)):
                part1 = graphs.partition_graph(g, 1, seed=0)
                p1[k] = halo_leg(g, part1, W, seed, mesh1, k,
                                 steps=PAR_STEPS, timed=PAR_TIMED_STEPS)
                if not p1[k]["equal"] or p1[k]["launches"]["packed_step"] \
                        != PAR_STEPS:
                    raise AssertionError(f"P=1 {k}: {p1[k]}")
            out["p1"], out["p2"] = p1, {k: r0[k] for k in ("headline",
                                                           "config3")}
            docs = {}
            for label, extra in (("unsharded", []), ("P=1", ["--sharded"])):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(PAR_CONSENSUS_ARGV + extra)
                docs[label] = json.loads(buf.getvalue().strip()
                                         .splitlines()[-1])
                if rc != 0:
                    raise AssertionError(f"consensus {label} exit {rc}")
            c2 = r0["consensus"]
            docs["P=2"] = json.loads(c2["out"].strip().splitlines()[-1])
            if ranks[1]["consensus"]["out"].strip() or c2["rc"] != 0 \
                    or ranks[1]["consensus"]["rc"] != 0:
                raise AssertionError("consensus --sharded: rank 1 printed or "
                                     "a rank failed")
            if not (docs["unsharded"]["rows"] == docs["P=1"]["rows"]
                    == docs["P=2"]["rows"]):
                raise AssertionError("consensus --sharded differs from the "
                                     "unsharded sweep")
            log(f"[55 consensus] {' '.join(PAR_CONSENSUS_ARGV)}: --sharded at "
                f"P=1 (one NCCL rank) and P=2 (two gloo ranks, word slabs "
                f"of {HEADLINE_R // 64} words) equal to the unsharded rows; "
                f"K1/K2' launches on each rank {c2['launches']}")
            out["consensus_launches_p2"] = c2["launches"]
            out["config5"] = phase_config5_lightcone(tmp)
            # the small SA shape: P=2 gather and halo equal to the one-
            # process port; the P=2 preempted run resumed at P=1
            cfg = _sa_config()
            want = simulated_annealing(inp["g_sa"], cfg, s0=inp["s0"],
                                       proposals=inp["prop"],
                                       uniforms=inp["unif"], device="cuda")
            for mode in ("gather", "halo"):
                _same_result(r0[f"sa_{mode}"], want, f"sa_sharded {mode} P=2")
            if any(r["preempt"] != "preempted" for r in ranks):
                raise AssertionError("the P=2 checkpointed run was not "
                                     "preempted")
            t0 = time.perf_counter()
            res = sa_sharded(inp["g_sa"], cfg, mesh=mesh1, s0=inp["s0"],
                             proposals=inp["prop"], uniforms=inp["unif"],
                             chunk_steps=64, checkpoint_path=inp["ckpt"],
                             checkpoint_interval_s=0.0, device="cuda")
            resume_wall = time.perf_counter() - t0
            _same_result({f: getattr(res, f) for f in res._fields}, want,
                         "sa_sharded resumed at P=1")
            log(f"[57 sa_sharded] RRG d=3 n={PAR_SA_N}, R={PAR_SA_R}, "
                f"{PAR_SA_L} injected draws: gather and halo at P=2 equal to "
                f"simulated_annealing (walls "
                f"{r0['sa_gather']['wall_s']:.3f} / "
                f"{r0['sa_halo']['wall_s']:.3f} s); preempted at its 2nd "
                f"chunk boundary at P=2 (halo), resumed at P=1 from rank 0's "
                f"global snapshot: equal to the uninterrupted chain "
                f"({resume_wall:.3f} s)")
            out["sa"] = {"gather_wall_s": r0["sa_gather"]["wall_s"],
                         "halo_wall_s": r0["sa_halo"]["wall_s"],
                         "resume_wall_s": resume_wall}
        finally:
            dist.destroy_process_group()
    # memcheck's halo row (the obs group's memcheck prints it among the
    # others): the widest smoke shard's peak against its model
    dev = torch.device("cuda")
    base = torch.cuda.memory_allocated(dev)
    halo_row = memband._row("halo_shard",
                            memband._measure_halo_shard(dev, 8, 8),
                            memband._halo_smoke_model(8), None)
    if not halo_row.ok or halo_row.measured is None:
        raise AssertionError(f"memcheck halo row: {halo_row}")
    log(f"[58 memcheck] halo_shard: measured peak {halo_row.measured} B "
        f"against the widest shard's model {halo_row.model} B -> frac "
        f"{halo_row.frac:.3f} (band [{halo_row.lo:g}, {halo_row.hi:g}]); "
        f"{base} B held when it started")
    out["memcheck_halo"] = halo_row._asdict()
    return out


def phase_config2_device_init(host_setup: dict) -> dict:
    """``hpr_solve_batch(device_init=True)`` at config 2's width (256 ×
    RRG(10⁵, 3), float32): the on-device initial draw's seconds beside the
    host init's of the same call (phase 15's ``init_draw`` + ``upload``),
    the same draw on a small shape equal on the card and the CPU, then
    ``hpr --device-init`` through the CLI with its K3′ launches counted
    (one per sweep)."""
    from graphdyn_torch.models.hpr import device_init_state

    for dt in (torch.float32, torch.float64):
        a = device_init_state(5, 300, 900, 4, dt, 9, torch.device("cuda"))
        b = device_init_state(5, 300, 900, 4, dt, 9, torch.device("cpu"))
        if not all(torch.equal(x.cpu(), y) for x, y in zip(a, b)):
            raise AssertionError(f"device init: card != CPU ({dt})")
    g = random_regular_graph(CONFIG2_N, CONFIG2_D, seed=0)
    twoE = 2 * g.num_edges
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = device_init_state(CONFIG2_R, g.n, twoE, 4, torch.float32, 0,
                           torch.device("cuda"))
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    chi = st[0]
    row_err = float((chi.sum(dim=(1, 2)) - 1).abs().max())
    del st, chi
    torch.cuda.empty_cache()
    _reset_bdcm_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["hpr", "--batch-replicas", str(CONFIG2_R), "--n",
                       str(CONFIG2_N), "--d", str(CONFIG2_D), "--max-sweeps",
                       str(CONFIG2_SWEEPS), "--device-init", "--device",
                       "cuda"])
    wall = time.perf_counter() - t0
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or doc["solver"] != "hpr_batch":
        raise AssertionError(f"hpr --device-init exit {rc}")
    launches = _bdcm_counts("hpr --device-init (config 2)",
                            _hpr_clock(np.asarray(doc["num_steps"]),
                                       CONFIG2_SWEEPS))
    host_s = host_setup["init_draw"] + host_setup["upload"]
    log(f"[15b config 2] device init (chi {CONFIG2_R * twoE}x4x4, biases, "
        f"seeds; Threefry on the card) {t_dev:.3f} s beside the host init's "
        f"{host_s:.3f} s (numpy draw {host_setup['init_draw']:.3f} s + upload "
        f"{host_setup['upload']:.3f} s) in this call; rows sum to 1 within "
        f"{row_err:.3e}; card == CPU bit for bit on a small shape (f32, f64);"
        f" hpr --device-init: wall {wall:.3f} s, bdcm_sweep launches (one "
        f"per sweep) {launches}")
    return {"device_init_s": t_dev, "host_init_s": host_s,
            "cli_wall_s": wall, "launches": launches, "row_err": row_err}


def _group_soak(ctx: dict) -> dict:
    """The chaos soak's bounded matrix on the card (every workload on
    ``--device cuda``): seed 0 always, further seeds while the run is
    inside SOAK_UNTIL_S seconds."""
    from graphdyn_torch.resilience.soak import SCENARIOS, run_soak

    seeds, walls, failed = [], [], 0
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for seed in range(3):
                if seed and time.perf_counter() - _T0 > SOAK_UNTIL_S:
                    break
                t0 = time.perf_counter()
                rep = run_soak(seeds=[seed], root=os.path.join(tmp, "soak"),
                               device="cuda")
                walls.append(time.perf_counter() - t0)
                seeds.append(seed)
                bad = [(r["scenario"], r["problems"]) for r in rep["runs"]
                       if not r["ok"]]
                failed += len(bad)
                if bad:
                    raise AssertionError(f"soak seed {seed}: {bad}")
        finally:
            os.chdir(cwd)
    log(f"[59 soak] {len(SCENARIOS)} scenarios x seeds {seeds} on the card, "
        f"each bit-exact against its fault-free oracle with a valid journal "
        f"and flight story; seconds per seed {[round(w, 3) for w in walls]}")
    return {"seeds": seeds, "walls_s": walls, "failed": failed}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


#: the phase groups, in the order a full run takes them
GROUPS = ("packed", "fused", "bdcm", "gather", "entropy", "sa", "powerlaw",
          "durable", "obs", "parallel", "soak")
#: the groups whose results the durable group holds its resumed runs to
DURABLE_NEEDS = ("fused", "bdcm", "entropy", "sa")


def _group_packed(ctx: dict) -> dict:
    """The packed step (K1/K2′): the headline and config-3 timings, then
    the main path, counted (headline rollout, config-3 sweep, headline
    point)."""
    g_h, (nbr_h, deg_h) = ctx["g_h"], ctx["tables_h"]
    g_e, n_iso_e, nbr_e, deg_e = ctx["config3"]
    t0 = time.perf_counter()
    sp_h = draw_packed_biased(1, g_h.n, HEADLINE_R // 32, 0.0, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0 + ctx["t_headline_s"]
    head = phase_timing(g_h, nbr_h, deg_h, sp_h, reps=20, plain_reps=3)
    rate = HEADLINE_N * HEADLINE_R / (head["ms"] * 1e-3)
    log(f"[3 headline] RRG d=3 n=10^6 R=16384 (set-up {t_setup:.3f} s): "
        f"kernel {head['ms']} ms/step = {rate:.6e} spin-updates/s; "
        f"packed_rollout host wall {head['host_ms_per_step']} ms/step; plain "
        f"PyTorch {head['plain_ms']} ms/step; bound {head['bound_ms']} ms "
        f"({head['bound_by']}: {head['bytes']} B at {HBM_BYTES_PER_S:.3e} "
        f"B/s); no-reuse traffic {head['no_reuse_bytes']} B = "
        f"{head['no_reuse_ms']} ms; library_ms null (no single PyTorch call "
        f"computes a packed majority step); plan {head['plan']}; "
        f"the step's own gather: row_gather {head['gather_ms']} ms, "
        f"index_select {head['index_select_ms']} ms (bound "
        f"{head['gather_bound_ms']} ms)")
    sp_e = draw_packed_biased(3, g_e.n, CONFIG3_R // 32, 0.0, device="cuda")
    cfg3 = phase_timing(g_e, nbr_e, deg_e, sp_e, reps=200, plain_reps=3)
    log(f"[3 config 3] ER n={g_e.n} c={CONFIG3_C} R={CONFIG3_R}: kernel "
        f"{cfg3['ms']} ms/step; packed_rollout host wall "
        f"{cfg3['host_ms_per_step']} ms/step; plain PyTorch "
        f"{cfg3['plain_ms']} ms/step; bound {cfg3['bound_ms']} ms "
        f"({cfg3['bound_by']}: {cfg3['bytes']} B); no-reuse traffic "
        f"{cfg3['no_reuse_bytes']} B = {cfg3['no_reuse_ms']} ms; plan "
        f"{cfg3['plan']}; the step's own gather: row_gather {cfg3['gather_ms']} ms, index_select "
        f"{cfg3['index_select_ms']} ms")

    packed_cuda.LAUNCHES = 0
    main_h = phase_headline_main_path(g_h, nbr_h, deg_h, sp_h)
    launches_headline = packed_cuda.LAUNCHES
    log(f"[3 headline] main path: packed_rollout, 20 steps, "
        f"{main_h['rollout_ms_per_step']} ms/step by CUDA events, equal to "
        f"the plain version")
    sweep = phase_consensus_sweep(g_e, n_iso_e, nbr_e, deg_e)
    launches_sweep = packed_cuda.LAUNCHES - launches_headline
    point = phase_headline_point(g_h, nbr_h, deg_h)
    launches = packed_cuda.LAUNCHES
    launches_point = launches - launches_headline - launches_sweep
    if min(launches_headline, launches_sweep, launches_point) <= 0:
        raise AssertionError(
            f"the main path did not go through the kernel: launches "
            f"{launches_headline} (headline rollout), {launches_sweep} "
            f"(config-3 sweep), {launches_point} (headline point)")
    log(f"[5 path] packed_step launches on the main path: {launches} = "
        f"{launches_headline} (headline rollout) + {launches_sweep} (config-3 "
        f"sweep) + {launches_point} (headline consensus_point)")
    phase_int8_crosscheck()
    return {"head": head, "rate": rate, "cfg3": cfg3, "launches": launches,
            "sweep": sweep, "point": point}


def _group_fused(ctx: dict) -> dict:
    """The fused annealer (K4′): config 1's main path, counted, its check
    and timing, the CLI, the scale shape and the hubs past dmax 63."""
    main_f = phase_config1_main_path()
    return {"main_f": main_f, "verdicts": phase_config1_check(main_f),
            "cfg1": phase_config1_timing(main_f["graph"]),
            "cli": phase_fused_cli(main_f), "scale": phase_fused_scale(),
            "hubs": phase_fused_hubs()}


def _group_bdcm(ctx: dict) -> dict:
    """The BDCM kernels: the sweep kernel on the entropy shapes, then the
    HPr main path, counted (the HPr shapes' sweep timings run inside
    phases 12 and 15); past T = 4 and past a block's shared memory (C2):
    HPr at T = 5, a T = 6 sweep, the global-lattice path at T = 4, each
    counted; T = 7 refused."""
    out = {"sweep_ent": phase_sweep_entropy(ctx["eref"]),
           "sweep_many": phase_sweep_many_classes(),
           "ref_errs": phase_hpr_ref(), "ref_shape": phase_hpr_ref_timing(),
           "hpr_main": phase_hpr_main(), "chains": phase_hpr_chains(),
           "cfg2": phase_config2_setup_timing(),
           "cfg2_main": phase_config2_main(), "hpr_t5": phase_hpr_t5(),
           "t6": phase_sweep_t6(), "glob": phase_entropy_global()}
    out["cfg2_devinit"] = phase_config2_device_init(out["cfg2"]["setup_s"])
    phase_t7_refused()
    return out


def _group_gather(ctx: dict) -> dict:
    """The row gather (P): its main path (the probe), counted, then P
    against index_select, in turns."""
    return {"probe": phase_gather_probe(),
            "turns": phase_gather_interleaved()}


def _group_entropy(ctx: dict) -> dict:
    """The entropy λ-ladders through the sweep kernel, each run counted."""
    out = {"golden": phase_entropy_golden(ctx["eref"]),
           "union_ref": phase_entropy_union_ref(ctx["eref"]),
           "grouped": phase_entropy_grouped(), "cfg4": phase_config4_main(),
           "congruent": phase_congruent_ensemble(),
           "ent_cli": phase_entropy_cli()}
    log(f"[24 entropy] wall seconds: golden {out['golden']['wall_s']:.3f}, "
        f"config 4 {out['cfg4']['wall_s']:.3f}, congruent "
        f"{out['congruent']['wall_s']:.3f}, CLI "
        f"{out['ent_cli']['wall_s']:.3f}")
    return out


def _group_sa(ctx: dict) -> dict:
    """The SA searches (plain PyTorch on the card): each command's main
    path."""
    sa_parity = ctx["gates"]["sa"]
    out = {"sa_main": phase_sa_main(), "chrom_main": phase_chromatic_main(),
           "temper_main": phase_temper_main()}
    sa_main, chrom_main = out["sa_main"], out["chrom_main"]
    log(f"[31 searches] SA parity walls (card / CPU, s): "
        + ", ".join(f"{k} {v['card_s']:.3f} / {v['cpu_s']:.3f}"
                    for k, v in sa_parity.items())
        + f"; sa main {sa_main['full']['wall_s']:.3f} s full grouped, "
        f"{sa_main['lightcone']['wall_s']:.3f} s light-cone serial "
        f"(busy, graph replay {sa_main['full']['graph_busy_share']:.4f} / "
        f"{sa_main['lightcone']['graph_busy_share']:.4f}); chromatic "
        f"{chrom_main['wall_s']:.3f} s; temper "
        f"{out['temper_main']['wall_s']:.3f} s")
    return out


def _group_powerlaw(ctx: dict) -> dict:
    """The power-law path: the bench shape through bucketed_rollout
    (counted) with the RRG control and the lifted K1/K2′, the stream CLI
    (counted), the solvers' layouts; then B4."""
    out = {"planes": phase_packed_planes(),
           "main": phase_powerlaw_main(ctx.pop("g_pl"), ctx.pop("b_pl")),
           "stream": phase_stream_main(), "layouts": phase_layouts()}
    out["b4"] = phase_b4_labelling(ctx["g_h"], *ctx["tables_h"])
    return out


def _group_durable(ctx: dict) -> dict:
    """Durability: each CLI preempted and resumed, held to its
    uninterrupted twin of the groups above."""
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        return {"sa": phase_sa_durable(ctx["sa"]["sa_main"]["full"]["res"],
                                       tmp),
                "hpr": phase_hpr_durable(ctx["bdcm"]["hpr_main"]["oracles"],
                                         tmp),
                "entropy": phase_entropy_durable(
                    ctx["entropy"]["ent_cli"]["grids"], tmp),
                "stream": phase_stream_durable(tmp),
                "temper": phase_temper_fused_durable(ctx["fused"]["main_f"],
                                                     tmp),
                "supervised": phase_supervised(tmp)}


def _group_obs(ctx: dict) -> dict:
    """Telemetry (A17): the ledger and the trace, the cost of recording,
    memory, the roofline check and the flight post-mortem."""
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        return phase_obs(tmp)


def _group_parallel(ctx: dict) -> dict:
    """Node-axis sharding: the shard-layout K1/K2′ launch, the
    halo rollouts at P=1 and P=2, the sharded consensus, config 5's
    light-cone width, the sharded SA and its resume across P, memcheck's
    halo row."""
    return phase_parallel(ctx)


def run_groups(names) -> dict:
    """The parity gates, then the named groups (and the groups the durable
    group needs), in the order of :data:`GROUPS`. Every kernel is held
    against its plain version first, whatever the groups; a run with every
    group is the whole script. Returns the gates' results under
    ``"gates"`` and each group's under its name."""
    want = set(names)
    if "durable" in want:
        want |= set(DURABLE_NEEDS)
    t0 = time.perf_counter()
    # headline shape: d=3 RRG, n=10^6, R=16384 (W=512); config 3: ER
    # n=10^5, c=6, isolates removed, R=512 (W=16)
    g_h = random_regular_graph(HEADLINE_N, HEADLINE_D, seed=0)
    ctx = {"g_h": g_h, "t_headline_s": time.perf_counter() - t0}
    ctx["tables_h"] = _tables(g_h)
    ctx["config3"] = er_consensus_ensemble(CONFIG3_N, c=CONFIG3_C, seed=0,
                                           device="cuda")
    with open(os.path.join(HERE, "entropy_ref.json")) as f:
        ctx["eref"] = json.load(f)
    t1 = time.perf_counter()
    g_pl = graphs.powerlaw_graph(POWERLAW_N, gamma=2.2, dmin=2, seed=0)
    ctx["g_pl"], ctx["b_pl"] = g_pl, graphs.degree_buckets(g_pl)
    ctx["t_powerlaw_s"] = time.perf_counter() - t1
    gates = ctx["gates"] = {}
    gates["packed_step"] = phase_parity(g_h, ctx["config3"][0])
    gates["fused_chunk"] = phase_fused_parity()
    gates["dp_contract"], gates["dp_contract_timings"] = \
        phase_contract_parity()
    gates["row_gather"] = phase_gather_parity()
    gates["bucketed_step"] = phase_kb_parity(ctx["g_pl"], ctx["b_pl"])
    gates["sa"] = phase_sa_parity()
    log(f"[groups] parity gates held ({time.perf_counter() - t0:.3f} s); "
        f"groups {[g for g in GROUPS if g in want]}")
    if "powerlaw" not in want:
        del ctx["g_pl"], ctx["b_pl"]
    for name in GROUPS:
        if name in want:
            ctx[name] = globals()[f"_group_{name}"](ctx)
    return ctx


def kernels_line(res: dict, built: dict) -> list[dict]:
    """The ``kernels`` rows from a run of every group (:func:`run_groups`)
    and the build (:func:`phase_build`)."""
    gates, packed, fused = res["gates"], res["packed"], res["fused"]
    head, cfg3 = packed["head"], packed["cfg3"]
    main_f, scale, hubs = fused["main_f"], fused["scale"], fused["hubs"]
    cfg1, verdicts = fused["cfg1"], fused["verdicts"]
    bd, ent = res["bdcm"], res["entropy"]
    cfg2, cfg2_main, ref_shape = bd["cfg2"], bd["cfg2_main"], bd["ref_shape"]
    hpr_main, hpr_t5, t6, glob = (bd["hpr_main"], bd["hpr_t5"], bd["t6"],
                                  bd["glob"])
    contract_errs = gates["dp_contract"]
    golden, union_ref, grouped = (ent["golden"], ent["union_ref"],
                                  ent["grouped"])
    cfg4, congruent, ent_cli = ent["cfg4"], ent["congruent"], ent["ent_cli"]
    probe, gather_turns = res["gather"]["probe"], res["gather"]["turns"]
    pl = res["powerlaw"]
    pl_main, durable = pl["main"], res["durable"]
    planes, b4 = pl["planes"], pl["b4"]
    launches, max_abs_err = packed["launches"], gates["packed_step"]
    rate = packed["rate"]
    fused_err, gather_err = gates["fused_chunk"], gates["row_gather"]
    contract_timings, kb_parity = (gates["dp_contract_timings"],
                                   gates["bucketed_step"])
    chrom_main = res["sa"]["chrom_main"]
    chains, ref_errs, sweep_many = bd["chains"], bd["ref_errs"], \
        bd["sweep_many"]
    entropy_launches = {"entropy_sweep_golden_f64": golden["launches"],
                        "entropy_ensemble_union_reduced": union_ref["launches"],
                        "entropy_grid_grouped_vs_serial": grouped["launches"],
                        "entropy_ensemble_union_config4": cfg4["launches"],
                        "entropy_ensemble_rrg": congruent["launches"],
                        "entropy_cli": ent_cli["launches"]}
    turns512 = gather_turns["probe W=512"]
    sweep_shapes = {**bd["sweep_ent"], **bd["sweep_many"],
                    "HPr reference shape f32": ref_shape["float32"]["bdcm_sweep"],
                    "HPr reference shape f64": ref_shape["float64"]["bdcm_sweep"],
                    "HPr config 2": cfg2["bdcm_sweep"],
                    **{f"HPr T=5 {dt}": v["bdcm_sweep"]
                       for dt, v in hpr_t5.items()},
                    **{f"T=6 RRG(1000, 3) {dt}": v for dt, v in t6.items()},
                    **{f"ER(2000, 6) T=4 {dt}": v["bdcm_sweep"]
                       for dt, v in glob.items()}}
    sweep_launches = {"hpr_cli": hpr_main["cli"]["launches"],
                      "hpr_ensemble_g4": hpr_main["group4"]["launches"],
                      "hpr_solve_f64": hpr_main["f64"]["launches"],
                      "hpr_solve_batch_config2": cfg2_main["launches_batch"],
                      "hpr_cli_config2": cfg2_main["launches_cli"],
                      **{f"hpr_cli_t5_{dt}": v["launches"]
                         for dt, v in hpr_t5.items()},
                      **{f"make_sweep_t6_{dt}": v["launches"]
                         for dt, v in t6.items()},
                      **{f"entropy_sweep_global_{dt}": v["launches"]
                         for dt, v in glob.items()},
                      **{f"hpr_cli_resumed_{dt}": v["launches"]
                         for dt, v in durable["hpr"].items()},
                      "hpr_cli_device_init_config2":
                          bd["cfg2_devinit"]["launches"],
                      **entropy_launches}
    par = res["parallel"]
    shard = par["shard_step"]

    return [{
        "name": "packed_step",
        "route": "cuda",
        "source": "graphdyn_torch/csrc/packed_step.cu",
        "replaces": "graphdyn/ops/pallas_packed.py:129 (K1 pallas_packed_step), "
                    "graphdyn/ops/pallas_packed.py:224 (K2 _general_step_ext)",
        "parity": "bit-exact",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a packed majority step",
        "shape": f"RRG d=3 n={HEADLINE_N} W={HEADLINE_R // 32}",
        "spin_updates_per_s": rate,
        "host_ms_per_step": head["host_ms_per_step"],
        "no_reuse_ms": head["no_reuse_ms"],
        "design": "node order, 16-byte vectors, batched loads",
        "plan": head["plan"],
        "gather_ms": head["gather_ms"],
        "index_select_ms": head["index_select_ms"],
        "config3": {k: cfg3[k] for k in ("ms", "plain_ms", "host_ms_per_step",
                                         "bound_ms", "bound_by",
                                         "no_reuse_ms", "plan",
                                         "gather_ms", "index_select_ms")},
        "build_s": built["build_s"],
        "launches_on_chromatic_path": chrom_main["packed_step_launches"],
        "powerlaw_padded": pl_main["padded"],
        "planes_parity": planes,
        "b4_labelling": b4,
        "ptxas": built["packed_step"],
    }, {
        "name": "fused_chunk",
        "route": "cuda",
        "source": "graphdyn_torch/csrc/fused_anneal.cu",
        "replaces": "graphdyn/ops/pallas_anneal.py:433 (K4 fused_chunk_pallas)",
        "parity": "bit-exact",
        "launches": main_f["launches"]["fused_chunk"],
        "max_abs_err": max(fused_err, scale["max_abs_err"]),
        "ms": scale["ms"],
        "plain_ms": scale["plain_ms"],
        "bound_ms": scale["bound_ms"],
        "bound_by": scale["bound_by"],
        "library_ms": None,
        "library_note": "no PyTorch call computes a fused SA class step",
        "unit": "per class step",
        "design": "one pass per class step: ball-local end states in "
                  "registers, lanes over replica pairs, the last block's "
                  "bookkeeping, one grid barrier",
        "shape": f"RRG d={SCALE_D} n={SCALE_N} W={SCALE_R // 32}",
        "bound_terms_ms": {k: scale[k] for k in ("bytes_ms", "int_ms",
                                                  "f32_ms")},
        "grid_blocks": scale["grid_blocks"],
        "phases_us": scale["phases_us"],
        "peak_bytes": scale["peak_bytes"],
        "launch_bytes": scale["launch_bytes"],
        "setup_s": scale["setup_s"],
        "config1": {
            "shape": f"RRG d={CONFIG1['d']} n={CONFIG1['n']} W=1",
            **{k: cfg1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "bytes_ms", "int_ms", "f32_ms",
                                    "phases_us")},
            "wall_s": main_f["walls"],
            "reference": {run: v["how"] for run, v in verdicts.items()},
        },
        "packed_step_launches_on_fused_path":
            main_f["launches"]["packed_step"],
        "past_63": {
            "launches": hubs["launches"],
            **{k: {"n": v["n"], "dmax": v["dmax"], "chi": v["chi"],
                   "instance": v["instance"], "tables_s": v["tables_s"],
                   **{f"W{W}": r for W, r in v["by_W"].items()}}
               for k, v in hubs.items() if k != "launches"}},
        "ptxas": built["fused_chunk"],
    }, {
        "name": "dp_contract",
        "route": "cuda",
        "source": "graphdyn_torch/csrc/bdcm_contract.cu",
        "replaces": "graphdyn/ops/pallas_bdcm.py:200 (K3 dp_contract_grouped)",
        "parity": "rtol 1e-5 (f32), 1e-12 (f64)",
        # off the main paths since the sweep kernel: its counts read at the
        # end of every HPr and entropy window (each checked to be 0)
        "launches": sum(_PER_CLASS_ON_MAIN_PATHS),
        "max_abs_err": max([cfg2["max_abs_err"]]
                           + [e["max_abs_err"] for e in contract_errs.values()]
                           + [ref_shape[k]["max_abs_err"] for k in ref_shape]),
        "max_rel_err": max([cfg2["max_rel_err"]]
                           + [e["max_rel_err"] for e in contract_errs.values()]
                           + [ref_shape[k]["max_rel_err"] for k in ref_shape]),
        "ms": cfg2["ms"],
        "plain_ms": cfg2["plain_ms"],
        "bound_ms": cfg2["bound_ms"],
        "bound_by": cfg2["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the rho-lattice DP "
                        "and the factor contraction",
        "shape": f"config 2: union of {CONFIG2_R} RRG d={CONFIG2_D} "
                 f"n={CONFIG2_N}, f32, one class (d={CONFIG2_D - 1}, T=2)",
        "sweep_ms": cfg2["sweep_ms"],
        "setup_s": cfg2["setup_s"],
        "peak_bytes": cfg2_main["peak_bytes"],
        "reference_shape": {
            dt: {k: v[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "sweep_ms")}
            for dt, v in ref_shape.items()},
        "by_class_shape": contract_timings,
        "entropy": {
            "config4": {k: cfg4[k] for k in (
                "wall_s", "lambdas", "graph_lambda_points_per_s", "sweeps",
                "nonconverged", "peak_bytes", "graphs_s", "member_mean",
                "fp64_wall_s", "busy_share")},
            "config4_profile": {k: cfg4["profile"][k] for k in (
                "device_us", "wall_us", "busy_share", "top")},
            "config4_classes": cfg4["timings"],
            "golden_classes": golden["timings"],
            "golden": {k: golden[k] for k in ("wall_s", "sweeps",
                                              "triples_err", "ref")},
            "union_ref": {k: v for k, v in union_ref.items()
                          if k != "launches"},
            "grouped_walls_s": grouped["walls"],
            "congruent": {k: congruent[k] for k in (
                "wall_s", "lambdas", "graph_lambda_points_per_s", "sweeps",
                "nonconverged")},
            "cli_wall_s": ent_cli["wall_s"],
        },
        "hpr": {"cli": hpr_main["cli"], "group4": hpr_main["group4"],
                "f64": hpr_main["f64"], "chains": chains["how"],
                "hpr_ref_max_rel_err": ref_errs},
        "ptxas": {"float": built["dp_contract_float"],
                  "double": built["dp_contract_double"]},
    }, {
        "name": "bdcm_sweep",
        "route": "cuda",
        "source": "graphdyn_torch/csrc/bdcm_sweep.cu",
        "replaces": "graphdyn/ops/pallas_bdcm.py:200 (K3 dp_contract_grouped, "
                    "pallas_call at :280) with the class loop around it, "
                    "graphdyn/ops/bdcm.py:330-372",
        "parity": "rtol 1e-5 (f32), 1e-12 (f64) per sweep",
        "launches": sum(sweep_launches.values()),
        "max_abs_err": max(v["max_abs_err"] for v in sweep_shapes.values()),
        "max_rel_err": max(v["max_rel_err"] for v in sweep_shapes.values()),
        "ms": cfg2["bdcm_sweep"]["ms"],
        "plain_ms": cfg2["bdcm_sweep"]["plain_ms"],
        "bound_ms": cfg2["bdcm_sweep"]["bound_ms"],
        "bound_by": cfg2["bdcm_sweep"]["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a BDCM sweep",
        "unit": "per sweep",
        "shape": f"config 2: union of {CONFIG2_R} RRG d={CONFIG2_D} "
                 f"n={CONFIG2_N}, f32, one class, node bias",
        "per_class_route_ms": cfg2["bdcm_sweep"]["per_class_ms"],
        "by_shape": {k: {f: v[f] for f in (
            "G", "classes", "paths", "threads", "smem", "ms", "per_class_ms",
            "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "max_rel_err", "per_class_bit_equal", "per_class_max_abs_diff")}
            for k, v in sweep_shapes.items()},
        "launches_by_run": sweep_launches,
        "many_classes_launches": {k: v["launches"]
                                  for k, v in sweep_many.items()},
        "hpr_t5": {dt: {k: v[k] for k in ("cli_sweeps", "cli_wall_s",
                                          "launches", "first_sweeps_err")}
                   for dt, v in hpr_t5.items()},
        "t6_first_sweeps_err": {dt: v["first_sweeps_err"]
                                for dt, v in t6.items()},
        "global_path": {dt: {k: v[k] for k in (
            "classes", "first_sweeps_err", "launches", "wall_s", "sweeps",
            "curve_err")} for dt, v in glob.items()},
        "ptxas": {"float": built["bdcm_sweep_float"],
                  "double": built["bdcm_sweep_double"]},
    }, {
        "name": "row_gather",
        "route": "cuda",
        "source": "graphdyn_torch/csrc/row_gather.cu",
        "replaces": "scripts/pallas_gather_probe.py:63 (P pallas_gather, "
                    "pallas_call at :104)",
        "parity": "bit-exact",
        "launches": probe["launches"],
        "max_abs_err": gather_err["max_abs_err"],
        "ms": turns512["P"]["median_ms"],
        "plain_ms": turns512["index_select"]["median_ms"],
        "bound_ms": turns512["bound_ms"],
        "bound_by": "bytes",
        "library_ms": turns512["index_select"]["median_ms"],
        "library_note": "torch.index_select on the same int32 indices; the "
                        "plain version is that call, so plain_ms is its time",
        "timing": f"median of {GATHER_REPS} repeats each, P and "
                  "index_select in turns",
        "shape": f"probe W=512, n_src=10^6, n_idx={turns512['n_idx']}",
        "all_reads_bound_ms": turns512["all_reads_bound_ms"],
        "plan": turns512["plan"],
        "interleaved": {k: {f: v[f] for f in v if f != "n_src"}
                        for k, v in gather_turns.items()},
        "probe": probe["rows"],
        "port_widths": probe["port"],
        "parity_cases": gather_err["cases"],
        "ptxas": built["row_gather"],
    }, {
        "name": "bucketed_step",
        "route": "cuda",
        "source": "graphdyn_torch/csrc/bucketed_step.cu",
        "replaces": "graphdyn/ops/bucketed.py:182 (_bucketed_rollout_device, "
                    "XLA), graphdyn/ops/streamed.py:295 "
                    "(_stream_chunk_device, XLA); no pl.pallas_call",
        "parity": "bit-exact",
        "launches": pl_main["launches"],
        "launches_stream_resumed": durable["stream"]["launches"],
        "max_abs_err": kb_parity["max_abs_err"],
        "ms": pl_main["ms"],
        "plain_ms": pl_main["plain_ms"],
        "bound_ms": pl_main["bound_ms"],
        "bound_by": pl_main["bound_by"],
        "library_ms": None,
        "library_note": "no PyTorch call computes a packed bucketed step",
        "shape": f"powerlaw_graph({POWERLAW_N}, 2.2, 2, 0), "
                 f"W={POWERLAW_R // 32}, one launch per step over every "
                 "bucket",
        "spin_updates_per_s": pl_main["spin_updates_per_s"],
        "bound_terms": {k: pl_main[k] for k in ("bytes", "ops")},
        "parts": pl_main["parts"],
        "parity_cases": kb_parity["cases"],
        "ptxas": built["bucketed_step"],
    }, {
        "name": "packed_step_shard",
        "route": "cuda",
        "source": "graphdyn_torch/csrc/packed_step.cu",
        "replaces": "graphdyn/ops/pallas_packed.py:224 (K2 _general_step_ext) "
                    "as graphdyn/parallel/halo.py:384-392 runs it per shard "
                    "(the halo shard layout's step)",
        "parity": "bit-exact",
        "launches": sum(par["p2"][k]["launches"]["shard"]
                        for k in ("headline", "config3")),
        "launches_note": "rank 0's shard-layout launches over the P=2 "
                         "headline and config-3 main paths (each rank "
                         "launches as many)",
        "max_abs_err": 0.0,
        "ms": shard["ms"],
        "plain_ms": shard["plain_ms"],
        "bound_ms": shard["bound_ms"],
        "bound_by": shard["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a packed majority "
                        "step",
        "shape": shard["shape"],
        "bound_terms": {k: shard[k] for k in ("bytes", "ops")},
        "parity_cases": shard["cases"],
        "exchange": {k: {f: par["p2"][k][f] for f in (
            "step_ms", "exchange_ms", "halo_bytes_per_step", "edge_cut")}
            for k in ("headline", "config3")},
        "ptxas": built["packed_step"],
    }]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="graphdyn_torch on one GPU: every kernel against its "
                    "plain version and every main path (no argument), or "
                    "the parity gates and the named phase groups")
    ap.add_argument("groups", nargs="*", choices=GROUPS, metavar="GROUP",
                    help=f"run only these groups after the build and the "
                         f"parity gates: {', '.join(GROUPS)}")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available; this script runs "
                 "only on a GPU")
    torch.cuda.set_device(0)
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda})")
    built = phase_build()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    res = run_groups(args.groups or GROUPS)
    if args.groups:
        # a partial run: no kernels line, and a last line that names its
        # groups (a full run's last line is {"ok": true, ...})
        log(json.dumps({"groups": {g: res[g] if g == "obs" else "held"
                                   for g in GROUPS if g in res}},
                       default=str))
        log(f"[10] seconds in all: {time.perf_counter() - t_start:.3f}")
        print(card_line(), flush=True)
        print(json.dumps({"partial": True,
                          "groups": [g for g in GROUPS if g in res],
                          "device": device}), flush=True)
        return 0
    kernels = kernels_line(res, built)
    pl_main = res["powerlaw"]["main"]
    log(json.dumps({"phases": {
        "powerlaw_main": {
            "main_path_ms_per_step": pl_main["main_ms"],
            "main_spin_updates_per_s": pl_main["main_spin_updates_per_s"],
            "host_ms_per_step": pl_main["host_ms_per_step"],
            "rrg_control": pl_main["rrg"],
            "rrg_over_bucketed_x": pl_main["rrg_over_bucketed_x"],
            "rrg_over_bucketed_main_x": pl_main["rrg_over_bucketed_main_x"],
            "table_entries": pl_main["table_entries"],
            "padded_entries": pl_main["padded_entries"],
            "graph_setup_s": res["t_powerlaw_s"]},
        "stream": {str(k): v for k, v in res["powerlaw"]["stream"].items()},
        "layouts": res["powerlaw"]["layouts"], "durable": res["durable"],
        "obs": res["obs"], "parallel": res["parallel"],
        "soak": res["soak"]}}, default=str))
    log(f"[24 gather] row_gather probe {res['gather']['probe']['wall_s']:.3f}"
        f" s")
    log(f"[10] seconds in all: {time.perf_counter() - t_start:.3f} "
        f"(sweep {res['packed']['sweep']['sweep_wall_s']:.3f}, headline point "
        f"{res['packed']['point']['point_wall_s']:.3f}, fused scale set-up "
        f"{sum(res['fused']['scale']['setup_s'].values()):.3f}, config-2 "
        f"set-up {sum(res['bdcm']['cfg2']['setup_s'].values()):.3f})")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
