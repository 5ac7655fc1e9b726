"""The port's linter (``graphdyn_torch.analysis.graftlint``): the disable
parser and the API-agnostic rules (GD007 persistence, GD011 bare timing,
GD016 byte arithmetic, GD017 ghost-padded tables) give the same ``(code,
line)`` findings as ``graphdyn.analysis.graftlint`` on the same sources (at
the same path inside each package); the port's rules fire and stay silent
on fixtures of their own, one fixture per rule; the port lints clean, and
every disable in it carries a reason."""

import os
import re
import subprocess
import sys
import textwrap

import pytest

from graphdyn.analysis import graftlint as jl
from graphdyn_torch.analysis import graftlint as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _src(text: str) -> str:
    return textwrap.dedent(text).lstrip("\n")


def _port(rel: str, text: str) -> list[tuple[str, int]]:
    return [(f.code, f.line) for f in
            tl.lint_sources([(f"graphdyn_torch/{rel}", _src(text))])]


def _jax(rel: str, text: str) -> list[tuple[str, int]]:
    return [(f.code, f.line) for f in
            jl.lint_sources([(f"graphdyn/{rel}", _src(text))])]


DISABLE_SOURCES = [
    "x = 1  # graftlint: disable=GD004  a reason\n",
    "# graftlint: disable-next-line=GD001,GD003 two codes, a reason\nx = 1\n",
    "# graftlint: disable-file=all  whole file\n",
    "x = 1  # graftlint: disable=gd007 lower case\n",
    "x = 1  # graftlint: disable=GD004 host staging, GD016 and more\n",
    "x = 1  # graftlint: disable=NOTACODE\n",
]


@pytest.mark.parametrize("k", range(len(DISABLE_SOURCES)))
def test_disable_parser_matches_the_jax_package(k):
    src = DISABLE_SOURCES[k]
    assert tl._parse_disables(src) == jl._parse_disables(src)


# (path inside the package, source): the JAX rules with API-agnostic
# counterparts, each fixture firing and silent cases together
SHARED = {
    "gd007": ("models/persist.py", """
        import numpy as np

        def save(path, tmp_path, a):
            np.savez(path, a=a)
            np.savez(tmp_path, a=a)
            with open(path, "w") as f:
                f.write("x")
            with open(path) as f:
                f.read()
            with open(tmp_path + ".part", "wb") as f:
                f.write(b"")
            open(path, mode="a")
        """),
    "gd011": ("pipeline/timing.py", """
        import time
        from time import perf_counter

        def run():
            t0 = time.time()
            t1 = perf_counter()
            t2 = time.monotonic()
            t3 = time.time(5)
            return t0, t1, t2, t3
        """),
    "gd016": ("ops/model.py", """
        def nbytes(n, W, d, arrays):
            a = 4 * n * W
            b = 8 * n
            c = 2 * n * W
            d2 = sum(x.nbytes for x in arrays)
            e = arrays[0].nbytes + arrays[1].nbytes
            return a + b + c + d2 + e + 4 * n * W * d
        """),
    "gd017": ("ops/table.py", """
        import numpy as np

        def table(n, dmax):
            a = np.full((n, dmax), n, np.int32)
            b = np.full((1, dmax), n, np.int32)
            c = np.full((n, dmax), -1, np.int32)
            d = np.full(n, n)
            return a, b, c, d
        """),
    "disabled": ("models/quiet.py", """
        import time

        def run(path):
            # graftlint: disable-next-line=GD011  timed on purpose
            t0 = time.time()
            open(path, "w")  # graftlint: disable=GD007  a reason
            return t0
        """),
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_rules_match_the_jax_package(name):
    rel, text = SHARED[name]
    got = _port(rel, text)
    want = _jax(rel, text)
    keep = {"GD007", "GD011", "GD016", "GD017"}
    assert got == [f for f in want if f[0] in keep]
    if name != "disabled":
        assert got                       # the fixture does fire


# one fixture per port rule: (path, source, the findings expected)
PORT_RULES = {
    "GD001-3 device body": ("models/graphed.py", """
        import numpy as np
        import torch

        def body(st, steps: int, flag=False):
            x = np.zeros(3)
            if st.sum() > 0:
                pass
            if st is None or flag or st.dtype == torch.float32:
                pass
            y = st.item()
            z = int(steps)
            return st

        def capture(st):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = body(st, 3)
            return out
        """, [("GD001", 5), ("GD002", 6), ("GD003", 10)]),
    "GD003 chunk loop": ("pipeline/drive.py", """
        import numpy as np
        import torch

        def drive(state, chunks):
            for k in range(chunks):
                state = advance_chunk(state)
                go = bool(state.active.any())
                live = int(state.active.sum())
                t = int(np.sum(state.host_t))
                h = state.t.cpu()
                torch.cuda.synchronize()
            for k in range(chunks):
                x = state.t.cpu()
            return state
        """, [("GD003", 7), ("GD003", 8), ("GD003", 10), ("GD003", 11)]),
    "GD004": ("ops/dtypes.py", """
        import torch

        def f(n, dt):
            a = torch.zeros(n)
            b = torch.zeros(n, dtype=torch.int32)
            c = torch.arange(n)
            d = torch.ones(3).double()
            e = torch.full((n,), 0.0, dtype=torch.float64)
            ok = dt == torch.float64 or dt in (torch.float32, torch.double)
            return a, b, c, d, e, ok
        """, [("GD004", 4), ("GD004", 6), ("GD004", 7), ("GD004", 7),
              ("GD004", 8)]),
    "GD004 outside ops": ("models/dtypes.py", """
        import torch

        def f(n):
            return torch.zeros(n, dtype=torch.float64)
        """, []),
    "GD008": ("models/ship.py", """
        import numpy as np
        import torch

        def drive(tables, dev):
            out = []
            for t in tables:
                out.append(torch.as_tensor(t).to(dev))
                out.append(torch.from_numpy(t).cuda())
                out.append(torch.as_tensor(t, device=dev))
            stacked = torch.from_numpy(np.stack(tables)).to(dev)
            return out, stacked
        """, [("GD008", 7), ("GD008", 8)]),
    "GD009": ("ops/batch.py", """
        import torch
        from graphdyn_torch.ops import packed_cuda

        def step(x):
            return packed_cuda.packed_step(x)

        def wrapper(x):
            return step(x)

        def plain(x):
            return x + 1

        def run(xs):
            a = torch.vmap(wrapper)(xs)
            b = torch.func.vmap(plain)(xs)
            c = torch.vmap(lambda x: packed_cuda.packed_step(x))(xs)
            return a, b, c
        """, [("GD009", 14), ("GD009", 16)]),
    "GD010 alias": ("pipeline/alias.py", """
        import numpy as np
        import torch

        def drive(n):
            buf = np.zeros(n)
            t = torch.from_numpy(buf)
            buf[0] = 1.0
            keep = np.zeros(n)
            u = torch.as_tensor(keep)
            flags = np.zeros(n, bool)
            v = torch.as_tensor(flags, dtype=torch.float32)
            flags.fill(True)
            return t, u, v
        """, [("GD010", 6)]),
    "GD010 async copy": ("ops/stage.py", """
        import torch

        def stage(slab, dev, ev):
            d = slab.to(dev, non_blocking=True)
            slab[0] = 1
            return d

        def stage_waited(slab, dev, ev):
            d = slab.to(dev, non_blocking=True)
            ev.record()
            ev.synchronize()
            slab[0] = 1
            return d

        def stage_copy(dst, slab):
            dst.copy_(slab, non_blocking=True)
            slab.fill_(0)
        """, [("GD010", 4), ("GD010", 16)]),
    "GD012": ("models/prof.py", """
        import torch
        from torch.profiler import profile

        def run():
            with torch.profiler.profile() as p:
                with torch.profiler.record_function("x"):
                    torch.cuda.nvtx.range_push("y")
            return p
        """, [("GD012", 2), ("GD012", 5), ("GD012", 6), ("GD012", 7)]),
    "GD012 in obs": ("obs/prof.py", """
        import torch

        def run():
            with torch.profiler.profile() as p:
                pass
            return p
        """, []),
    "GD013": ("parallel/gather.py", """
        import torch.distributed as dist
        from graphdyn_torch.parallel.mesh import all_gather_tiled

        def step(s, mesh):
            full = all_gather_tiled(s, mesh, "node", dim=1)
            dist.all_gather_into_tensor(full, s)
            dist.batch_isend_irecv([])
            return full
        """, [("GD013", 5), ("GD013", 6)]),
    "GD014": ("search/ladder.py", """
        import numpy as np

        def drive(state, n):
            while True:
                if not bool(state.active.any()):
                    break
                x = state.t.item()
                y = np.asarray(state.s)
                z = int(state.sweeps)
                w = int(3)
            return state
        """, [("GD014", 7), ("GD014", 8), ("GD014", 9)]),
    "GD015": ("models/anneal.py", """
        import torch

        def drive(st, steps):
            for t in range(steps):
                st = step(st)
                a = st.m.item()
                b = bool(torch.any(st.active))
                c = float(st.host_m)
                torch.cuda.synchronize()
            return st
        """, [("GD003", 6), ("GD003", 7), ("GD003", 9), ("GD015", 6),
              ("GD015", 7), ("GD015", 9)]),
    "GD018": ("ops/shifts.py", """
        def bits(w, k, j):
            a = (w >> k) & 1
            b = ((w << 3) | (w >> 29)) & 0xFFFFFFFF
            c = w >> k
            d = (w >> 8).float()
            e = (0xFFFF & (w * (j >> 16)))
            return a, b, c, d, e
        """, [("GD018", 4), ("GD018", 5)]),
    "GD018 outside ops": ("models/shifts.py", """
        def bits(w, k):
            return w >> k
        """, []),
    "GD019": ("ops/kern_cuda.py", """
        from graphdyn_torch.ops import cuda_build

        SOURCE = "fused_anneal.cu"
        NVCC_FLAGS = cuda_build.BASE_FLAGS

        def build():
            return cuda_build.build(SOURCE, NVCC_FLAGS)

        def build_ok():
            return cuda_build.build(SOURCE, NVCC_FLAGS + ("--fmad=false",))

        def other():
            return cuda_build.load("row_gather.cu", cuda_build.BASE_FLAGS)
        """, [("GD019", 4), ("GD019", 7)]),
    "GD019 with the flag": ("ops/kern2_cuda.py", """
        from graphdyn_torch.ops import cuda_build

        SOURCE = "fused_anneal.cu"
        NVCC_FLAGS = cuda_build.BASE_FLAGS + ("--fmad=false",)

        def build():
            return cuda_build.build(SOURCE, NVCC_FLAGS)
        """, []),
}


@pytest.mark.parametrize("name", sorted(PORT_RULES))
def test_port_rule_fixture(name):
    rel, text, want = PORT_RULES[name]
    assert sorted(_port(rel, text)) == sorted(want)


def test_fmad_sources_are_declared_by_cuda_build():
    from graphdyn_torch.ops import cuda_build, fused_cuda

    assert tl._declared_fmad_sources([]) == cuda_build.FMAD_FALSE_SOURCES
    assert fused_cuda.SOURCE in cuda_build.FMAD_FALSE_SOURCES
    assert "--fmad=false" in fused_cuda.NVCC_FLAGS


def test_rule_table_names_every_counterpart():
    # GD005 and GD006 have no counterpart (the module docstring says why)
    assert set(tl.RULES) | {"GD005", "GD006"} == \
        set(jl.RULES) | {"GD018", "GD019"}
    assert not set(tl.RULES) & {"GD005", "GD006"}


def test_the_port_lints_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch.analysis", "graphdyn_torch/",
         "--format", "json"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert proc.stdout.strip() == "[]"


def test_every_disable_in_the_port_carries_a_reason():
    pat = re.compile(r"#\s*(graftlint|graftrace):\s*"
                     r"(disable|disable-next-line|disable-file)=(.*)$")
    bare = []
    for root, _, files in os.walk(os.path.join(REPO, "graphdyn_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path, encoding="utf-8") as fh:
                for i, line in enumerate(fh, 1):
                    m = pat.search(line)
                    if not m or "<reason>" in line:
                        continue
                    # the code list, then at least a few words of reason
                    rest = re.sub(r"^[A-Za-z0-9,]+", "", m.group(3).strip())
                    if len(rest.split()) < 3:
                        bare.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert bare == []


def test_cli_exit_code_counts_findings(tmp_path):
    bad = tmp_path / "graphdyn_torch" / "ops" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\nx = torch.zeros(3)\ny = torch.arange(4)\n")
    assert tl.main([str(bad)]) == 2
    assert tl.main([str(bad), "--format", "json"]) == 2
