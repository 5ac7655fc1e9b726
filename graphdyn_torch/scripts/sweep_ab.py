"""The BDCM sweep kernel (K3′) of two checkouts timed in turns on one card.

    python -m graphdyn_torch.scripts.sweep_ab OTHER_CHECKOUT [--pairs 2]

Runs, in fresh processes and in the order other, this, this, other (one
pair per ``--pairs``), ``chip_smoke.py``'s own K3′ phases in each checkout:
``phase_sweep_many_classes`` (the 80-class tree), ``phase_sweep_entropy``
(config 4's union as run and padded, the congruent ensemble, the golden
instance, the 8-cell grid), ``phase_hpr_ref_timing`` (the HPr reference
shape) and ``phase_config2_setup_timing`` (HPr config 2), and, in a
checkout whose ``chip_smoke.py`` has them, ``phase_hpr_t5`` (HPr at T = 5)
and ``phase_sweep_t6`` (a T = 6 sweep). Each process builds its checkout's
BDCM libraries into that checkout's ``build/``; the compiler's report of
each instantiation of the sweep kernel (registers, spill bytes, stack
frame) is printed per side. Prints one line per (run, shape): K3′ and the
per-class route in ms per sweep, as the phases measure them, then the
median of each side per shape. Comparing two commits only makes sense
within one call on one card. ``--pairs 2`` runs each side twice. Run it
for any change to ``csrc/bdcm_dp.cuh`` or ``csrc/bdcm_sweep.cu``, with the
parent commit unpacked (``git archive``) into a git-ignored directory."""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from statistics import median

CODE = r'''
import json
import chip_smoke as c
from graphdyn_torch.ops import bdcm_cuda, bdcm_sweep
print("library", bdcm_sweep.build(), flush=True)
bdcm_cuda.build()
c.phase_sweep_many_classes()
c.phase_sweep_entropy(json.load(open("entropy_ref.json")))
c.phase_hpr_ref_timing()
c.phase_config2_setup_timing()
for name in ("phase_hpr_t5", "phase_sweep_t6"):
    if hasattr(c, name):
        getattr(c, name)()
'''
LINE = re.compile(r"\[sweep\] (.*?) \((?:float32|float64), G=.*kernel "
                  r"([0-9.e-]+) ms/sweep, per-class route ([0-9.e-]+)")
KERNEL = re.compile(r"bdcm_sweep_kernelI([fd])Li(\d+)E(?:Li(\d)E)?")
# the paths an instantiation compiles in (bit 0 register, bit 1 block, bit
# 2 global); None: a source with one instantiation per T, every path in it
PATH_SETS = {None: "every path", "1": "register", "2": "block",
             "3": "register, block", "6": "block, global",
             "7": "register, block, global"}


def ptxas(lib: str) -> list[str]:
    """One line per instantiation of the sweep kernel from the compiler's
    report kept beside the library (``<lib>.log``): its float type, T and
    the paths compiled in, with registers, spill bytes (stores + loads) and
    stack frame."""
    with open(f"{lib}.log") as f:
        blocks = f.read().split("Compiling entry function '")[1:]
    out = []
    for b in blocks:
        m = KERNEL.search(b.split("'", 1)[0])
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", b)
        sp = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", b)
        ftype = "float" if m.group(1) == "f" else "double"
        out.append(f"bdcm_sweep_kernel<{ftype}, T={m.group(2)}, "
                   f"{PATH_SETS[m.group(3)]}>: "
                   f"{regs.group(1) if regs else '?'} registers, "
                   f"{int(sp.group(2)) + int(sp.group(3)) if sp else '?'} "
                   f"spill bytes, {sp.group(1) if sp else '?'} B stack frame")
    return sorted(out)


def run(checkout: str) -> tuple[dict, list]:
    """The K3′ and per-class route times of one process in ``checkout``:
    ``({shape: (kernel_ms, per_class_ms)}, other lines to print)``."""
    p = subprocess.run([sys.executable, "-c", CODE], cwd=checkout,
                       capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": checkout})
    if p.returncode:
        raise RuntimeError(f"{checkout}: exit {p.returncode}\n"
                           f"{p.stderr[-3000:]}")
    times, notes = {}, []
    for line in p.stdout.splitlines():
        m = LINE.match(line)
        if m:
            times[m.group(1)] = (float(m.group(2)), float(m.group(3)))
        elif line.startswith("library "):
            notes += ptxas(os.path.join(checkout, line.split(" ", 1)[1]))
    return times, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.scripts.sweep_ab",
        description="K3' of two checkouts timed in turns on one card")
    ap.add_argument("other", help="the other checkout (e.g. the parent "
                                  "commit unpacked with git archive)")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sides = {"other": os.path.abspath(args.other), "this": here}
    order = [("other", "this", "this", "other")[i % 4]
             for i in range(2 * args.pairs)]
    got = {"other": [], "this": []}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for i, side in enumerate(order):
        times, notes = run(sides[side])
        got[side].append(times)
        if i < 2:                       # the first run of each side
            for note in notes:
                print(f"{side}: {note}", flush=True)
        for shape, (k, pc) in times.items():
            print(f"{side}: {shape}: K3' {k} ms/sweep (per-class route "
                  f"{pc})", flush=True)
    for shape in got["this"][0]:
        med = {s: median(t[shape][0] for t in got[s]) for s in got
               if shape in got[s][0]}
        pc = median(t[shape][1] for t in got["this"])
        if "other" in med:
            print(f"median {shape}: other {med['other']}, this "
                  f"{med['this']} ms/sweep "
                  f"({med['this'] / med['other'] - 1:+.4f})", flush=True)
        else:
            print(f"median {shape}: this {med['this']} ms/sweep, per-class "
                  f"route {pc} (not in the other checkout)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
