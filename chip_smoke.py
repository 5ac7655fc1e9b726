#!/usr/bin/env python3
"""Smoke test of graphdyn_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Builds the two CUDA kernels from ``graphdyn_torch/csrc/`` with nvcc
(sm_90a, both compilers started together) and holds each against its plain
PyTorch version bit for bit. Then it drives the port's two main paths
through the entry points a user calls, each with the launch counts set to 0
just before it and read just after:

- the packed rollout at the headline shape (d=3 RRG, n=10⁶, R=16384) and the
  config-3 consensus sweep (ER n=10⁵, c=6, R=512), checked against the JAX
  package's recorded sweep of the same graph (``er_consensus_r05.json``);
- the fused SA annealer (``fused_anneal``) at config 1 (d=3 RRG, n=10⁴,
  R=32), runs (a) and (b) of ``fused_config1_ref.json``, held to that record
  of the JAX package's runs under the near-tie rule, and the ``fused`` CLI
  once at its defaults.

It also times the fused kernel at config 5's single-chip width (d=5 RRG,
n=10⁶, R=1024).

Prints, in order: phase reports, the card's name and power limit (from
nvidia-smi), one JSON line listing the kernels with their measured times, and
as the last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
exit code is not 0 and the last line is not printed. There is no CPU mode:
without a CUDA device the script exits non-zero at once. Imports neither
``jax`` nor the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from graphdyn_torch import graphs
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.graphs import erdos_renyi_graph, random_regular_graph
from graphdyn_torch.models.consensus import (
    consensus_curve,
    consensus_point,
    er_consensus_ensemble,
)
from graphdyn_torch.ops import cuda_build, fused_cuda, packed_cuda
from graphdyn_torch.ops.dynamics import run_dynamics
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
from graphdyn_torch.search.fused import _assemble_fused, fused_anneal
from graphdyn_torch.search.reference import (
    hold_to_record,
    result_record,
    run_record,
)

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# 32-bit non-tensor-core rate (the float32 figure; the step's work is 32-bit
# integer logic, which the table lists no separate rate for)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# 32-bit integer ops: 132 SMs x 64 INT32 lanes x 1.98 GHz (the Hopper white
# paper's per-SM units, at the boost clock that gives the data sheet's 67
# TFLOP/s f32 = 132 x 128 lanes x 2 flops x 1.98 GHz)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

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
# one Threefry-2x32 block: 20 rounds of add, rotate, xor, 5 key injections of
# 2 adds (the key word plus the injection index folds into one constant per
# thread), 2 initial adds; one accurate expf counted as 10 f32 ops
THREEFRY_OPS, EXPF_OPS = 20 * 3 + 5 * 2 + 2, 10


def log(msg: str) -> None:
    print(msg, flush=True)


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


def step_bound(g, W: int, fast: bool) -> dict:
    """The least time one packed step can take on the card: the larger of
    the bytes it must move over HBM bandwidth and its 32-bit logic ops over
    the ALU rate. The bytes are each input read once and each output written
    once: the ``[n+1, W]`` state read and written, the ``Σdeg`` neighbour
    indices the kernel reads (it loops to each node's degree, not dmax), and
    the degrees on the general path. ``no_reuse_bytes`` is what a design
    with no reuse of gathered rows moves instead (every neighbour row and,
    on the general path, the own row fetched from HBM): a model of the
    kernel's traffic, not a bound."""
    n = g.n
    sum_deg = int(g.deg.sum())
    n_own = 0 if fast else n
    state_bytes = 2 * 4 * W * (n + 1)                   # read once, written once
    table_bytes = 4 * sum_deg + (0 if fast else 4 * n)
    no_reuse_bytes = 4 * W * (sum_deg + n_own + n + 1) + table_bytes
    planes = packed_cuda.n_planes(g.dmax)
    # per word: 2 logic ops per plane per addend, ~5 per plane to compare,
    # ~4 to combine
    ops = n * W * (2 * planes * sum_deg / n + 5 * planes + 4)
    bytes_ms = (state_bytes + table_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return {"bytes": state_bytes + table_bytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "no_reuse_bytes": no_reuse_bytes,
            "no_reuse_ms": no_reuse_bytes / HBM_BYTES_PER_S * 1e3}


def phase_build() -> dict:
    """Build both kernel libraries, one nvcc each, started together; load
    them; print each one's ptxas summary and the fused kernel's co-resident
    grid at the two shapes it runs."""
    t0 = time.perf_counter()
    wrappers = {"packed_step": packed_cuda, "fused_chunk": fused_cuda}
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
    for label, dmax, Rp in (("config 1", CONFIG1["d"], CONFIG1["replicas"]),
                            ("scale", SCALE_D, SCALE_R)):
        grid = fused_cuda.grid_info(dmax, Rp)
        out[f"grid_{label.replace(' ', '')}"] = grid
        log(f"[1 build] fused_chunk co-resident grid at {label} (dmax={dmax}, "
            f"Rp={Rp}): {grid['blocks_per_sm']} blocks of 256 per SM x "
            f"{grid['sms']} SMs = {grid['max_blocks']} blocks")
    log(f"[1 build] both libraries built and loaded in {dt:.3f} s")
    return out


def phase_parity(g_h, g_e) -> float:
    """Kernel against plain, bit-exact, over the fast path, the general
    path, W in {1, 16, 512}, 1/2/7 steps, the ghost row, the consensus scan,
    and the main path's two shapes. Returns the max |kernel - plain| over
    the words (0 when every case is bit-identical)."""
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
    seed = 0
    for W in (1, 16, 512):
        for steps in (1, 2, 7):
            for name in ("rrg3", "rrg5"):
                for rule in ("majority", "minority"):
                    seed += 1
                    check(small[name], W, rule, "stay", steps, seed, True)
            for name in ("rrg4", "er_ragged"):
                for rule, tie in RULE_TIES:
                    seed += 1
                    check(small[name], W, rule, tie, steps, seed, False)

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
    stepper, queued back to back), the plain version's time per step (a few
    hundred small PyTorch ops per step at dmax 19, more than the queue holds
    over many steps, so host gaps may remain in it), the host's wall time
    per step of ``packed_rollout`` (Python, checks and launch included), and
    the bound."""
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
    del ext
    packed_rollout(nbr, deg, sp, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed_rollout(nbr, deg, sp, reps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "host_ms_per_step": host_ms,
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
    microseconds per class step of phase A (end-state evaluations of every
    word), B (accepts of the class words) and C (bookkeeping), each
    including the grid barrier that ends it, from the kernel's global-timer
    stamps."""
    trace = torch.zeros((steps, 4), dtype=torch.int64, device="cuda")
    fused_cuda.fused_chunk_cuda(_clone(st0), seed, td, chunk_steps=steps,
                                trace=trace, **static)
    torch.cuda.synchronize()
    t = trace.cpu().double()
    d = (t[:, 1:] - t[:, :-1]) / 1e3
    return {"A_us": float(d[:, 0].mean()), "B_us": float(d[:, 1].mean()),
            "C_us": float(d[:, 2].mean()),
            "step_us": float((t[:, 3] - t[:, 0]).mean() / 1e3)}


def class_step_bound(chrom, W: int) -> dict:
    """The least time one fused class step can take on the card, averaged
    over the χ classes of a sweep. Only the ball B = C ∪ N(C) of the class
    rows C enters a decision, so the count is over B and over the rows D =
    B ∪ N(B) that its two LUT evaluations read, from this graph's colouring
    (``chrom``, the ChromaticTables). For each class the larger of

    - bytes over HBM bandwidth: the state rows of D read once (4·|D|·W), the
      class rows written once (4·|C|·W), the table entries read once
      (neighbours of B 4·Σ_B deg, balls of C 4·Σ_C (deg+1), LUT masks of B
      8·Σ_B (deg+1), the class mask over D 4·|D|) and the six per-replica
      vectors (24·Rp);
    - 32-bit integer ops over the INT32 rate: |C|·Rp/2 Threefry blocks of
      THREEFRY_OPS, the two LUT evaluations' carry-save and select logic per
      word of B (2·(2·deg·NP + (deg+1)·(NP+4))), the ball popcounts per class
      word ((deg+1)·(2+4·NB)), and the per-replica bit extraction (4·NB+6
      per class site and replica);
    - f32 ops over the f32 rate: ΔE, the uniform and expf per class site and
      replica (EXPF_OPS + 6).

    NP = bit_length(dmax), NB = bit_length(dmax+1), Rp = 32·W."""
    n, dmax = chrom.n, chrom.dmax
    nbr = chrom.nbr_ext[:n].astype(np.int64)       # ghost index n pads
    deg = chrom.deg_ext[:n].astype(np.int64)
    Rp = 32 * W
    NP = max(dmax.bit_length(), 1)
    NB = (dmax + 1).bit_length()

    def grow(rows):                     # rows ∪ N(rows), as a node mask
        out = rows.copy()
        idx = nbr[rows].ravel()
        out[idx[idx < n]] = True
        return out

    per = []
    for c in range(chrom.chi):
        in_c = chrom.colors == c
        in_b = grow(in_c)
        in_d = grow(in_b)
        k, n_d = int(in_c.sum()), int(in_d.sum())
        deg_b, deg_c = deg[in_b], deg[in_c]
        nbytes = 4 * n_d * W + 4 * k * W + 4 * int(deg_b.sum()) \
            + 4 * int((deg_c + 1).sum()) + 8 * int((deg_b + 1).sum()) \
            + 4 * n_d + 24 * Rp
        int_ops = k * Rp / 2 * THREEFRY_OPS \
            + W * 2 * int((2 * deg_b * NP + (deg_b + 1) * (NP + 4)).sum()) \
            + W * int((deg_c + 1).sum()) * (2 + 4 * NB) \
            + k * Rp * (4 * NB + 6)
        f32_ops = k * Rp * (EXPF_OPS + 6)
        per.append((nbytes / HBM_BYTES_PER_S * 1e3,
                    int_ops / INT32_OPS_PER_S * 1e3,
                    f32_ops / ALU_OPS_PER_S * 1e3, nbytes, int_ops, f32_ops))
    mean = [sum(p[i] for p in per) / len(per) for i in range(6)]
    bytes_ms, int_ms, f32_ms = mean[:3]
    bound = max(bytes_ms, int_ms, f32_ms)
    return {"bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= max(int_ms, f32_ms)
            else "operations",
            "bytes": mean[3], "int_ops": mean[4], "f32_ops": mean[5],
            "bytes_ms": bytes_ms, "int_ms": int_ms, "f32_ms": f32_ms}


def phase_fused_parity() -> float:
    """The fused kernel against its plain version on the card, bit for bit
    in every FusedState field: RRG d=3 (two rules; odd degree, no ties),
    RRG d=4 and ragged ER (the four (rule, tie) pairs), W in {1, 2, 32},
    chunk_steps in {1, χ, 3χ+1}, stop_on_first on and off, a betas ladder;
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
              (32, (3, 1), False, True, 0.4)]
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
        f"class step, barrier included): {phases}")
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
    2 sweeps by CUDA events; the plain version's over χ steps; kernel ==
    plain over one chunk of χ steps."""
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
    # kernel: warm-up launch, then 2 sweeps in one chunk
    st = _clone(st0)
    fused_cuda.fused_chunk_cuda(st, 0, td, chunk_steps=1, **static)
    times = []
    for _ in range(2):
        st = _clone(st0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_cuda.fused_chunk_cuda(st, 0, td, chunk_steps=2 * chi, **static)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (2 * chi))
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
        f"{bound['f32_ms']} ms); phases over 2 sweeps (us per class step, "
        f"barrier included): {phases}")
    del k, p, st0, td
    torch.cuda.empty_cache()
    return {"ms": ms, "ms_repeats": times, "plain_ms": plain_ms,
            "max_abs_err": err, "setup_s": timers, "chi": chi,
            "grid_blocks": grid, "phases_us": phases, **bound}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available; this script runs "
                 "only on a GPU")
    torch.cuda.set_device(0)
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda})")
    built = phase_build()
    # headline shape: d=3 RRG, n=10^6, R=16384 (W=512); config 3: ER
    # n=10^5, c=6, isolates removed, R=512 (W=16)
    t0 = time.perf_counter()
    g_h = random_regular_graph(HEADLINE_N, HEADLINE_D, seed=0)
    t_graph = time.perf_counter() - t0
    g_e, n_iso_e, nbr_e, deg_e = er_consensus_ensemble(
        CONFIG3_N, c=CONFIG3_C, seed=0, device="cuda")
    max_abs_err = phase_parity(g_h, g_e)

    t0 = time.perf_counter()
    nbr_h, deg_h = _tables(g_h)
    sp_h = draw_packed_biased(1, g_h.n, HEADLINE_R // 32, 0.0, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0 + t_graph
    head = phase_timing(g_h, nbr_h, deg_h, sp_h, reps=20, plain_reps=3)
    rate = HEADLINE_N * HEADLINE_R / (head["ms"] * 1e-3)
    log(f"[3 headline] RRG d=3 n=10^6 R=16384 (set-up {t_setup:.3f} s): "
        f"kernel {head['ms']} ms/step = {rate:.6e} spin-updates/s; "
        f"packed_rollout host wall {head['host_ms_per_step']} ms/step; plain "
        f"PyTorch {head['plain_ms']} ms/step; bound {head['bound_ms']} ms "
        f"({head['bound_by']}: {head['bytes']} B at {HBM_BYTES_PER_S:.3e} "
        f"B/s); no-reuse traffic {head['no_reuse_bytes']} B = "
        f"{head['no_reuse_ms']} ms; library_ms null (no single PyTorch call "
        f"computes a packed majority step)")
    sp_e = draw_packed_biased(3, g_e.n, CONFIG3_R // 32, 0.0, device="cuda")
    cfg3 = phase_timing(g_e, nbr_e, deg_e, sp_e, reps=200, plain_reps=3)
    log(f"[3 config 3] ER n={g_e.n} c={CONFIG3_C} R={CONFIG3_R}: kernel "
        f"{cfg3['ms']} ms/step; packed_rollout host wall "
        f"{cfg3['host_ms_per_step']} ms/step; plain PyTorch "
        f"{cfg3['plain_ms']} ms/step; bound {cfg3['bound_ms']} ms "
        f"({cfg3['bound_by']}: {cfg3['bytes']} B); no-reuse traffic "
        f"{cfg3['no_reuse_bytes']} B = {cfg3['no_reuse_ms']} ms")

    # the main path, counted: headline rollout, config-3 sweep, headline point
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

    # the fused annealer: parity, then its main path, counted
    fused_err = phase_fused_parity()
    main_f = phase_config1_main_path()
    verdicts = phase_config1_check(main_f)
    cfg1 = phase_config1_timing(main_f["graph"])
    phase_fused_cli(main_f)
    scale = phase_fused_scale()

    kernels = [{
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
        "config3": {k: cfg3[k] for k in ("ms", "plain_ms", "host_ms_per_step",
                                         "bound_ms", "bound_by",
                                         "no_reuse_ms")},
        "build_s": built["build_s"],
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
        "shape": f"RRG d={SCALE_D} n={SCALE_N} W={SCALE_R // 32}",
        "bound_terms_ms": {k: scale[k] for k in ("bytes_ms", "int_ms",
                                                  "f32_ms")},
        "grid_blocks": scale["grid_blocks"],
        "phases_us": scale["phases_us"],
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
        "ptxas": built["fused_chunk"],
    }]
    log(f"[10] seconds in all: {time.perf_counter() - t_start:.3f} "
        f"(sweep {sweep['sweep_wall_s']:.3f}, headline point "
        f"{point['point_wall_s']:.3f}, fused scale set-up "
        f"{sum(scale['setup_s'].values()):.3f})")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
