#!/usr/bin/env python3
"""Smoke test of graphdyn_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Builds the packed-step CUDA kernel from ``graphdyn_torch/csrc/`` with nvcc
(sm_90a), holds it against its plain PyTorch version bit for bit, drives the
port's main path — the packed rollout at the headline shape (d=3 RRG,
n=10⁶, R=16384) and the config-3 consensus sweep (ER n=10⁵, c=6, R=512) —
through the entry points a user calls, checks that every step of that path
went through the kernel, and checks the sweep against the JAX package's
recorded sweep of the same graph (``er_consensus_r05.json``).

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

import torch

from graphdyn_torch.graphs import erdos_renyi_graph, random_regular_graph
from graphdyn_torch.models.consensus import (
    consensus_curve,
    consensus_point,
    er_consensus_ensemble,
)
from graphdyn_torch.ops import packed_cuda
from graphdyn_torch.ops.dynamics import run_dynamics
from graphdyn_torch.ops.packed import (
    draw_packed_biased,
    packed_consensus_scan,
    _stepper,
    packed_end_state,
    packed_rollout,
    packed_rollout_plain,
)

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# 32-bit non-tensor-core rate (the float32 figure; the step's work is 32-bit
# integer logic, which the table lists no separate rate for)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

HEADLINE_N, HEADLINE_D, HEADLINE_R = 10**6, 3, 16384
CONFIG3_N, CONFIG3_C, CONFIG3_R = 100_000, 6.0, 512
CONFIG3_M0 = [0.0, 0.01, 0.02, 0.03, 0.05, 0.07, 0.1, 0.15, 0.2, 0.3]
CONFIG3_MAX_STEPS, CONFIG3_CHUNK = 2000, 10
RULE_TIES = [("majority", "stay"), ("majority", "change"),
             ("minority", "stay"), ("minority", "change")]


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


def phase_build() -> tuple[float, dict]:
    t0 = time.perf_counter()
    path = packed_cuda.build()
    packed_cuda._library()
    dt = time.perf_counter() - t0
    ptxas = packed_cuda.ptxas_summary(path)
    log(f"[1 build] {os.path.relpath(path, HERE)} built and loaded in {dt:.3f} s; "
        f"ptxas -v over {ptxas['kernels']} instantiations: "
        f"{ptxas['registers_min']}-{ptxas['registers_max']} registers, "
        f"at most {ptxas['spill_bytes_max']} bytes of spill stores + loads")
    return dt, ptxas


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
    build_s, ptxas = phase_build()
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
        "build_s": build_s,
        "ptxas": ptxas,
    }]
    log(f"[6] seconds in all: {time.perf_counter() - t_start:.3f} "
        f"(sweep {sweep['sweep_wall_s']:.3f}, headline point "
        f"{point['point_wall_s']:.3f})")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
