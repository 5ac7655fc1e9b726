"""Random-row gather probe: ``torch.index_select`` against the hand-written
CUDA row gather (the port of ``scripts/pallas_gather_probe.py``).

    python -m graphdyn_torch.scripts.gather_probe [--widths 128 512 1024]
    python -m graphdyn_torch.scripts.gather_probe --check --device cpu

The packed step and HPr's sweeps spend most of their device time in random
row gathers. The probe asks, on the card, whether such a gather is bound by
the rate of independent accesses (rows/s about constant in the row width W)
or by bandwidth (bytes/s about constant), and whether the explicitly
pipelined kernel (``csrc/row_gather.cu``: several rows in flight per thread,
``--depth``) beats the library gather at the same shape.

For each W it gathers ``n_idx = max(256, (n_idx·128 // W) // 256 · 256)``
rows (the same bytes at every width, the JAX probe's rule) of a random
``[n_src, W]`` source of int32 words, with the same int32 indices for both
implementations, drawn on the device from a seed. It prints one JSON line
per (impl, W): ``impl`` (``torch_index_select`` or ``cuda_row_gather``),
``rows_per_s``, ``GBps`` (gathered bytes per second), ``bound_share`` (the
least time the card could take, reading each distinct source row once,
writing each gathered row once and reading the indices, over the measured
time) and ``matches_torch``. Times
are CUDA events around ``ITERS`` queued calls after a warm-up.

``--check`` runs the JAX probe's small correctness check (a 512×128 source,
1024 indices, depth 4) against numpy; with ``--device cpu`` it runs the
plain version and stops there (the counterpart of the JAX probe's interpret
mode). Rates are measured only on a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from graphdyn_torch.ops.gather import row_gather
from graphdyn_torch.utils.platform import resolve_device

# H100 SXM HBM3 bandwidth (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
ITERS = 10


def probe_n_idx(n_idx: int, W: int) -> int:
    """The JAX probe's constant-bytes rule for the rows gathered at W."""
    return max(256, (n_idx * 128 // W) // 256 * 256)


def gather_bound(n_idx: int, W: int, n_distinct: int) -> dict:
    """The least time a gather of ``n_idx`` rows of ``W`` words, of which
    ``n_distinct`` are distinct source rows, can take on the card: each
    distinct source row read once, each gathered row written once and the
    int32 indices read once, over HBM bandwidth (no arithmetic to speak
    of)."""
    nbytes = (n_distinct + n_idx) * W * 4 + n_idx * 4
    return {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "n_distinct": n_distinct}


def draw(n_src: int, n_idx: int, W: int, seed: int, device):
    """A random int32 ``[n_src, W]`` source (every bit pattern, the top bit
    included) and int32 indices in ``[0, n_src)``, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    src = torch.empty((n_src, W), dtype=torch.int32, device=device)
    src.random_(-2**31, 2**31, generator=gen)
    idx = torch.randint(0, n_src, (n_idx,), dtype=torch.int32, device=device,
                        generator=gen)
    return src, idx


def cuda_ms(fn, reps: int, lead_ms: float = 20.0) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events around ``reps``
    queued calls, after ``lead_ms`` of device sleep so that the host queues
    the calls before the start event runs."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(lead_ms * 2e6))          # cycles, at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(src: torch.Tensor, idx: torch.Tensor, *, depth: int | None,
            iters: int = ITERS) -> list[dict]:
    """Time ``index_select`` and the kernel on the same CUDA inputs; one
    dict per implementation (see the module docstring)."""
    n_idx, W = idx.shape[0], src.shape[1]
    want = src.index_select(0, idx)
    got = row_gather(src, idx, kernel="cuda", depth=depth)
    match = bool(torch.equal(got, want))
    del got
    bound = gather_bound(n_idx, W, int(torch.unique(idx).numel()))
    from graphdyn_torch.ops import gather_cuda

    plan_depth = gather_cuda.launch_plan(W, True)["depth"]
    rows = []
    for impl, fn in (
        ("torch_index_select", lambda: src.index_select(0, idx)),
        ("cuda_row_gather",
         lambda: row_gather(src, idx, kernel="cuda", depth=depth)),
    ):
        fn()                                        # warm-up
        torch.cuda.synchronize()
        ms = cuda_ms(fn, iters)
        rows.append({
            "impl": impl, "W": W, "n_src": src.shape[0], "n_idx": n_idx,
            **({"depth": depth or plan_depth} if impl == "cuda_row_gather"
               else {}),
            "ms": ms, "rows_per_s": n_idx / (ms * 1e-3),
            "GBps": n_idx * W * 4 / (ms * 1e-3) / 1e9,
            "n_distinct": bound["n_distinct"], "bound_ms": bound["bound_ms"],
            "bound_share": bound["bound_ms"] / ms,
            "matches_torch": match,
        })
    return rows


def check(device, depth: int = 4) -> None:
    """The JAX probe's small check: a 512×128 source of uint32 words, 1024
    indices, against numpy's gather bit for bit."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, 2**32, size=(512, 128), dtype=np.uint32)
    idx = rng.integers(0, 512, size=1024).astype(np.int32)
    out = row_gather(torch.from_numpy(src.view(np.int32)).to(device),
                     torch.from_numpy(idx).to(device), depth=depth)
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32), src[idx])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.scripts.gather_probe",
        description="random-row gather: torch.index_select vs the CUDA "
                    "row-gather kernel")
    ap.add_argument("--n-src", type=int, default=1_000_000)
    ap.add_argument("--n-idx", type=int, default=3 * 1_000_000)
    ap.add_argument("--widths", type=int, nargs="+", default=[128, 512, 1024])
    ap.add_argument("--depth", type=int, default=None,
                    help="rows in flight per thread (default: the kernel's "
                         "plan for the row width)")
    ap.add_argument("--check", action="store_true",
                    help="small-shape correctness check (the plain version "
                         "on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the check "
                         "only)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    if args.check or dev.type == "cpu":
        check(dev)
        print(json.dumps({"check": "ok", "device": str(dev)}), flush=True)
        if dev.type == "cpu":
            return 0
    for W in args.widths:
        n_idx = probe_n_idx(args.n_idx, W)
        src, idx = draw(args.n_src, n_idx, W, seed=W, device=dev)
        for row in measure(src, idx, depth=args.depth):
            print(json.dumps({**row, "device": torch.cuda.get_device_name(dev)}),
                  flush=True)
        del src, idx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
