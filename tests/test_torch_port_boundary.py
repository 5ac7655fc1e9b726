"""The port's boundary: it never imports jax or the JAX package, its entry
points never run on the CPU unless asked, and the CUDA path raises instead of
falling back to the plain version."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphdyn_torch import graphs as tg
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.config import EntropyConfig, HPRConfig
from graphdyn_torch.models import consensus as tc
from graphdyn_torch.models import entropy as tem
from graphdyn_torch.models import hpr as th
from graphdyn_torch.models import sa as tsa
from graphdyn_torch.ops import bdcm as tb
from graphdyn_torch.ops import bdcm_cuda
from graphdyn_torch.ops import bucketed as tbk
from graphdyn_torch.ops import bucketed_cuda
from graphdyn_torch.ops import streamed as tss
from graphdyn_torch.ops import dynamics as td
from graphdyn_torch.ops import fused as tfu
from graphdyn_torch.ops import fused_cuda
from graphdyn_torch.ops import gather_cuda
from graphdyn_torch.ops import lightcone as tl
from graphdyn_torch.ops import packed as tp
from graphdyn_torch.ops import packed_cuda
from graphdyn_torch.search import chromatic as tsc
from graphdyn_torch.search import fused as tsf
from graphdyn_torch.pipeline import sa_group as tsg
from graphdyn_torch.search import tempering as tst
from graphdyn_torch.parallel import halo as tph
from graphdyn_torch.parallel import mesh as tpm
from graphdyn_torch.parallel import sharded as tpsh
from graphdyn_torch.parallel import stream as tpst
from graphdyn_torch.parallel.sa_sharded import sa_sharded as t_sa_sharded
from graphdyn_torch.resilience import soak as tsoak
from graphdyn_torch.utils.platform import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SOURCES = sorted(
    os.path.relpath(os.path.join(root, f), REPO)
    for root, _, files in os.walk(os.path.join(REPO, "graphdyn_torch"))
    for f in files if f.endswith(".py")
) + ["chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "graphdyn"}


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import graphdyn_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    graphdyn_torch.__path__, 'graphdyn_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'graphdyn'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for name in ("graphdyn_torch.ops.packed", "graphdyn_torch.ops.packed_cuda",
                 "graphdyn_torch.models.consensus", "graphdyn_torch.cli",
                 "graphdyn_torch.interop", "graphdyn_torch.observe",
                 "graphdyn_torch.ops.lut", "graphdyn_torch.ops.chromatic",
                 "graphdyn_torch.ops.fused", "graphdyn_torch.ops.fused_cuda",
                 "graphdyn_torch.ops.cuda_build",
                 "graphdyn_torch.ops.bucketed",
                 "graphdyn_torch.search.fused",
                 "graphdyn_torch.search.reference",
                 "graphdyn_torch.attractors", "graphdyn_torch.ops.bdcm",
                 "graphdyn_torch.ops.bdcm_cuda", "graphdyn_torch.pipeline",
                 "graphdyn_torch.pipeline.groups",
                 "graphdyn_torch.pipeline.prefetch",
                 "graphdyn_torch.pipeline.hpr_group",
                 "graphdyn_torch.models.hpr",
                 "graphdyn_torch.models.hpr_reference",
                 "graphdyn_torch.ops.gather", "graphdyn_torch.ops.gather_cuda",
                 "graphdyn_torch.scripts.gather_probe",
                 "graphdyn_torch.pipeline.entropy_group",
                 "graphdyn_torch.models.entropy",
                 "graphdyn_torch.models.entropy_reference",
                 "graphdyn_torch.plotting",
                 "graphdyn_torch.models.sa", "graphdyn_torch.ops.lightcone",
                 "graphdyn_torch.pipeline.sa_group",
                 "graphdyn_torch.search.chromatic",
                 "graphdyn_torch.search.tempering",
                 "graphdyn_torch.ops.bucketed_cuda",
                 "graphdyn_torch.ops.streamed",
                 "graphdyn_torch._native", "graphdyn_torch._native.build",
                 "graphdyn_torch.resilience",
                 "graphdyn_torch.resilience.faults",
                 "graphdyn_torch.resilience.retry",
                 "graphdyn_torch.resilience.shutdown",
                 "graphdyn_torch.resilience.supervisor",
                 "graphdyn_torch.resilience.store",
                 "graphdyn_torch.resilience.hooks",
                 "graphdyn_torch.utils.io",
                 "graphdyn_torch.obs", "graphdyn_torch.obs.recorder",
                 "graphdyn_torch.obs.flight", "graphdyn_torch.obs.trace",
                 "graphdyn_torch.obs.report", "graphdyn_torch.obs.memband",
                 "graphdyn_torch.obs.roofline", "graphdyn_torch.obs.trend",
                 "graphdyn_torch.obs.__main__",
                 "graphdyn_torch.utils.profiling",
                 "graphdyn_torch.utils.validate",
                 "graphdyn_torch.parallel", "graphdyn_torch.parallel.mesh",
                 "graphdyn_torch.parallel.sharded",
                 "graphdyn_torch.parallel.halo",
                 "graphdyn_torch.parallel.sa_sharded",
                 "graphdyn_torch.parallel.stream",
                 "graphdyn_torch.scripts.halo_ranks",
                 "graphdyn_torch.resilience.soak",
                 "graphdyn_torch.serve", "graphdyn_torch.serve.spool",
                 "graphdyn_torch.serve.admission",
                 "graphdyn_torch.serve.bucketing",
                 "graphdyn_torch.serve.worker",
                 "graphdyn_torch.serve.lifecycle",
                 "graphdyn_torch.serve.api",
                 "graphdyn_torch.serve.__main__",
                 *ANALYSIS_MODULES):
        assert name in out["modules"]


ANALYSIS_MODULES = (
    "graphdyn_torch.analysis", "graphdyn_torch.analysis.__main__",
    "graphdyn_torch.analysis.contracts", "graphdyn_torch.analysis.graftlint",
    "graphdyn_torch.analysis.sanitize", "graphdyn_torch.analysis.racecheck",
    "graphdyn_torch.analysis.graftcheck",
    "graphdyn_torch.analysis.graftcost")


@pytest.fixture(scope="module")
def analysis_imports():
    """Each analysis module imported in turn by one fresh interpreter: the
    forbidden modules present after each import."""
    code = (
        "import importlib, json, sys\n"
        f"names = {list(ANALYSIS_MODULES)!r}\n"
        "out = {}\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "    out[name] = sorted(m for m in sys.modules\n"
        "        if m.split('.')[0] in ('jax', 'jaxlib', 'graphdyn'))\n"
        "print(json.dumps(out))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ANALYSIS_MODULES)
def test_analysis_module_imports_neither_jax_nor_graphdyn(name,
                                                          analysis_imports):
    assert analysis_imports[name] == []


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_source_imports_no_jax_or_graphdyn(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]] if node.level == 0 else []
        else:
            continue
        assert not FORBIDDEN.intersection(roots), f"{path}:{node.lineno}"


def _small_graph():
    return tg.random_regular_graph(20, 3, seed=0)


class _OneMesh:
    """A 1 × 1 replica × node mesh seen from its one rank (no process
    group is made: the entry point must refuse before it would need one)."""

    mesh_dim_names = ("replica", "node")
    shape = (1, 1)

    def get_local_rank(self, name):
        return 0


def _spins():
    return np.ones((2, 20), np.int8)


_DRAW = tp.draw_packed_biased   # the test below stubs the module's name
ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(),
    "run_dynamics": lambda: td.run_dynamics(_small_graph(), _spins(), 1),
    "end_state": lambda: td.end_state(_small_graph(), _spins(), 1, 1),
    "packed_end_state": lambda: tp.packed_end_state(_small_graph(), _spins(), 1),
    "draw_packed_biased": lambda: _DRAW(0, 20, 1, 0.1),
    "er_consensus_ensemble": lambda: tc.er_consensus_ensemble(50),
    "rrg_consensus_ensemble": lambda: tc.rrg_consensus_ensemble(50),
    "consensus_point": lambda: tc.consensus_point(_small_graph(), 32, 0.1, 10),
    "consensus_curve": lambda: tc.consensus_curve(_small_graph(), 32, [0.1], 10),
    "consensus_curve_ensemble":
        lambda: tc.consensus_curve_ensemble(50, 32, [0.1], 10),
    "consensus_doc": lambda: tc.consensus_doc(_small_graph(), 0, []),
    "consensus_ensemble_doc": lambda: tc.consensus_ensemble_doc(50, [], []),
    "fused_anneal": lambda: tsf.fused_anneal(
        _small_graph(), SAConfig(dynamics=DynamicsConfig(p=1, c=1)),
        n_replicas=2, max_sweeps=2),
    "hpr_solve": lambda: th.hpr_solve(_small_graph(), HPRConfig(max_sweeps=2)),
    "hpr_solve_batch": lambda: th.hpr_solve_batch(
        _small_graph(), HPRConfig(max_sweeps=2), n_replicas=2),
    "hpr_ensemble": lambda: th.hpr_ensemble(20, 3, HPRConfig(max_sweeps=2)),
    "make_sweep": lambda: tb.make_sweep(tb.BDCMData(_small_graph()), damp=0.4),
    "make_marginals": lambda: tb.make_marginals(tb.BDCMData(_small_graph())),
    "entropy_sweep": lambda: tem.entropy_sweep(_small_graph()),
    "entropy_ensemble": lambda: tem.entropy_ensemble([_small_graph()] * 2),
    "entropy_ensemble_union": lambda: tem.entropy_ensemble_union(
        [_small_graph()] * 2),
    "entropy_grid": lambda: tem.entropy_grid(20, [1.5]),
    "make_fixed_point": lambda: tb.make_fixed_point(
        tb.BDCMData(_small_graph()), EntropyConfig()),
    "make_free_entropy": lambda: tb.make_free_entropy(
        tb.BDCMData(_small_graph()), n_total=20, n_iso=0),
    "simulated_annealing": lambda: tsa.simulated_annealing(
        _small_graph(), SAConfig(), n_replicas=2, max_steps=2),
    "sa_ensemble": lambda: tsa.sa_ensemble(20, 3, SAConfig(), n_stat=2,
                                           max_steps=2),
    "chromatic_anneal": lambda: tsc.chromatic_anneal(
        _small_graph(), SAConfig(dynamics=DynamicsConfig(p=1, c=1)),
        n_replicas=2, max_sweeps=2),
    "temper_search": lambda: tst.temper_search(
        _small_graph(), SAConfig(dynamics=DynamicsConfig(p=1, c=1)),
        n_lanes=2, max_steps=2),
    "run_sa_group": lambda: tsg.run_sa_group(
        [_small_graph()], [tsa.prepare_sa_inputs(
            _small_graph(), SAConfig(), n_replicas=1, seed=0, max_steps=2)],
        [0], SAConfig()),
    "build_lightcone_tables": lambda: tl.build_lightcone_tables(
        _small_graph(), 2),
    "build_lightcone_tables_device": lambda: tl.build_lightcone_tables_device(
        _small_graph(), 2),
    "resolve_lightcone_tables": lambda: tl.resolve_lightcone_tables(
        _small_graph(), 2),
    "streamed_rollout": lambda: tss.streamed_rollout(
        _small_graph(), np.zeros((20, 1), np.uint32), 1, n_chunks=2),
    "simulated_annealing_bucketed": lambda: tsa.simulated_annealing(
        _small_graph(), SAConfig(), n_replicas=2, max_steps=2,
        layout="bucketed"),
    "simulated_annealing_streamed": lambda: tsa.simulated_annealing(
        _small_graph(), SAConfig(), n_replicas=2, max_steps=2,
        layout="streamed"),
    "hpr_solve_batch_device_init": lambda: th.hpr_solve_batch(
        _small_graph(), HPRConfig(max_sweeps=2), n_replicas=2,
        device_init=True),
    "init_distributed": lambda: tpm.init_distributed(world_size=1, rank=0),
    "make_mesh": lambda: tpm.make_mesh((1,), ("node",)),
    "device_pool": lambda: tpm.device_pool(2),
    "sa_sharded": lambda: t_sa_sharded(_small_graph(), mesh=_OneMesh(),
                                         n_replicas=2, max_steps=2),
    "HaloProgram": lambda: tph.HaloProgram(
        _small_graph(), tg.partition_graph(_small_graph(), 1), steps=1),
    "run_soak": lambda: tsoak.run_soak(scenarios=["torn_write"], seeds=[0]),
    "sharded_streamed_rollout": lambda: tpst.sharded_streamed_rollout(
        _small_graph(), np.zeros((20, 1), np.uint32), 1, n_shards=1,
        n_chunks=2),
    "make_sharded_sweep": lambda: tpsh.make_sharded_sweep(
        tb.BDCMData(_small_graph()), _OneMesh(), damp=0.5),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_device_refuses_on_cuda_less_host(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    drawn = []
    monkeypatch.setattr(tp, "draw_packed_biased",
                        lambda *a, **k: drawn.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
    assert drawn == []


@pytest.mark.parametrize("argv", [
    ["consensus", "--n", "50", "--max-steps", "10"],
    ["fused", "--n", "50", "--max-sweeps", "2"],
    ["hpr", "--n", "50", "--max-sweeps", "2"],
    ["hpr", "--n", "50", "--max-sweeps", "2", "--batch-replicas", "2"],
    ["entropy", "--n", "50", "--lmbd-max", "0.1"],
    ["entropy", "--n", "50", "--lmbd-max", "0.1", "--union", "2"],
    ["sa", "--n", "50", "--d", "3", "--n-stat", "2", "--max-steps", "2"],
    ["chromatic", "--n", "50", "--max-sweeps", "2"],
    ["temper", "--n", "50", "--lanes", "2", "--max-steps", "2"],
    ["stream", "--n", "50", "--steps", "1"],
    ["sa", "--n", "50", "--d", "3", "--n-stat", "2", "--max-steps", "2",
     "--layout", "streamed"],
    ["consensus", "--n", "50", "--max-steps", "10", "--sharded"],
    ["hpr", "--n", "50", "--max-sweeps", "2", "--batch-replicas", "2",
     "--device-init"],
    ["sa", "--n", "50", "--d", "3", "--max-steps", "2", "--sharded"],
], ids=["consensus", "fused", "hpr", "hpr_batch", "entropy", "entropy_union",
        "sa", "chromatic", "temper", "stream", "sa_streamed",
        "consensus_sharded", "hpr_device_init", "sa_sharded"])
def test_cli_without_device_refuses_on_cuda_less_host(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert proc.stdout == ""


SERVE_ENTRY_POINTS = {
    "Worker": lambda root: __import__(
        "graphdyn_torch.serve.worker", fromlist=["Worker"]).Worker(
        __import__("graphdyn_torch.serve.spool",
                   fromlist=["Spool"]).Spool(root)),
    "run_service": lambda root: __import__(
        "graphdyn_torch.serve.lifecycle", fromlist=["run_service"]
    ).run_service(root, idle_exit_s=0.0),
    "BucketCache.warm": lambda root: __import__(
        "graphdyn_torch.serve.bucketing", fromlist=["BucketCache"]
    ).BucketCache().warm([{"n": 24, "d": 3, "graph_seed": 0, "seed": 0,
                           "rule": "majority", "tie": "stay",
                           "replicas": 32, "chunk_sweeps": 2}]),
}


@pytest.mark.parametrize("name", list(SERVE_ENTRY_POINTS))
def test_serve_entry_point_refuses_on_cuda_less_host(name, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path / "spool")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SERVE_ENTRY_POINTS[name](root)


def test_serve_cli_run_refuses_and_client_actions_need_no_device(tmp_path):
    """``serve run`` defaults to the card and refuses without one; submit,
    status and queue touch no device: CUDA stays uninitialised."""
    root = str(tmp_path / "spool")
    code = (
        "import json, sys, torch\n"
        "from graphdyn_torch.serve import api\n"
        f"jid = api.submit({root!r}, {{'n': 24}}, 'alice')\n"
        f"st = api.status({root!r}, jid)\n"
        f"q = api.queue({root!r})\n"
        "print(json.dumps({'init': torch.cuda.is_initialized(),\n"
        "                  'state': st['state'], 'q': q}))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["init"] is False
    assert out["state"] == "pending" and out["q"]["pending"] == 1
    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "-m", "graphdyn_torch", "serve", "run", "--root",
         root, "--idle-exit", "0"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr and proc.stdout == ""


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("wrapper", [packed_cuda, fused_cuda, bdcm_cuda,
                                     gather_cuda, bucketed_cuda],
                         ids=["packed_step", "fused_chunk", "dp_contract",
                              "row_gather", "bucketed_step"])
def test_kernel_build_raises_without_nvcc(wrapper, monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(wrapper, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wrapper.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wrapper._library()


def test_kernel_wrapper_refuses_cpu_tensors_and_cpu_path_never_launches():
    g = _small_graph()
    nbr, deg = torch.from_numpy(g.nbr), torch.from_numpy(g.deg)
    ext = torch.zeros(g.n + 1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not CUDA"):
        packed_cuda.packed_step(nbr, deg, ext, ext.clone(), minority=False,
                                change=False)
    before = packed_cuda.LAUNCHES
    tp.packed_rollout(nbr, deg, ext[:-1], 3)
    assert packed_cuda.LAUNCHES == before
    # the shard-layout launch refuses CPU tensors; its CPU step is the plain
    # twin and never launches
    with pytest.raises(ValueError, match="not CUDA"):
        packed_cuda.packed_step_rows(nbr, deg, ext, ext.clone(), n_update=g.n,
                                     minority=False, change=False)
    step = tph.ShardStep(nbr, deg, n_update=g.n, rule="majority", tie="stay")
    step(ext, ext.clone())
    assert packed_cuda.LAUNCHES == before
    assert packed_cuda.SHARD_LAUNCHES == 0


def test_bucketed_wrapper_refuses_cpu_tensors_and_cpu_path_never_launches():
    g = tg.powerlaw_graph(200, gamma=2.3, dmin=2, seed=1)
    b = tg.degree_buckets(g)
    segs = [(nb, dg, None, r0) for nb, dg, r0 in
            tbk.device_buckets(b, torch.device("cpu"))]
    ext = torch.zeros(g.n + 1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not CUDA"):
        bucketed_cuda.bucketed_step(segs, ext, ext.clone(), rule="majority",
                                    tie="stay", ghost_row=g.n)
    before = bucketed_cuda.LAUNCHES
    tbk.bucketed_rollout(b, ext[:-1], 3)
    tbk.bucketed_rollout_global(g, ext[:-1], 3)
    tss.streamed_rollout(g, ext[:-1], 2, n_chunks=2, device="cpu")
    assert bucketed_cuda.LAUNCHES == before


def _fused_cpu_inputs():
    cfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
    st, tables, static, _, _, _, _ = tsf._assemble_fused(
        _small_graph(), cfg, n_replicas=8, seed=0, m_target=1.0, betas=None,
        tables=None, device=torch.device("cpu"))
    return st, tables, static


def test_fused_wrapper_refuses_cpu_tensors_and_cpu_path_never_launches():
    st, tables, static = _fused_cpu_inputs()
    kw = dict(chunk_steps=3, stop_on_first=False, **static)
    with pytest.raises(ValueError, match="not CUDA"):
        fused_cuda.fused_chunk_cuda(st, 0, tables, **kw)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfu.fused_chunk(st, 0, tables, kernel="cuda", **kw)
    with pytest.raises(ValueError, match="kernel"):
        tfu.fused_chunk(st, 0, tables, kernel="pallas", **kw)
    before = fused_cuda.LAUNCHES
    out = tfu.fused_chunk(st, 0, tables, kernel="auto", **kw)
    assert int(out.steps) == 3 and int(st.steps) == 0   # plain: not in place
    res = tsf.fused_anneal(_small_graph(),
                           SAConfig(dynamics=DynamicsConfig(p=1, c=1)),
                           n_replicas=4, max_sweeps=3, device="cpu")
    assert res.kernel_used == "plain"
    assert fused_cuda.LAUNCHES == before


def test_fused_kernel_cuda_refused_on_cpu_device():
    cfg = SAConfig(dynamics=DynamicsConfig(p=1, c=1))
    with pytest.raises(ValueError, match="device='cuda'"):
        tsf.fused_anneal(_small_graph(), cfg, n_replicas=2, kernel="cuda",
                         device="cpu")


def _contract_cpu_inputs(d=3, T=2, G=2, Ed=5):
    K, M = 2**T, (d + 1) ** T
    gen = torch.Generator().manual_seed(0)
    return (torch.rand((G, Ed, d, K, K), generator=gen),
            torch.rand((K, K, M), generator=gen),
            torch.rand((G, Ed, K, K), generator=gen))


def test_bdcm_wrapper_refuses_cpu_tensors_and_cpu_path_never_launches():
    ci, a, co = _contract_cpu_inputs()
    kw = dict(d=3, T=2, damp=0.4)
    with pytest.raises(ValueError, match="not CUDA"):
        bdcm_cuda.dp_contract_cuda(ci, a, co, **kw)
    with pytest.raises(ValueError, match="CUDA BDCM kernel"):
        tb.dp_contract_grouped(ci, a, co, kernel="cuda", **kw)
    with pytest.raises(ValueError, match="kernel"):
        tb.dp_contract_grouped(ci, a, co, kernel="pallas", **kw)
    with pytest.raises(ValueError, match="CUDA BDCM kernel"):
        th.hpr_solve(_small_graph(), HPRConfig(max_sweeps=2), kernel="cuda",
                     device="cpu")
    before = bdcm_cuda.LAUNCHES
    out = tb.dp_contract_grouped(ci, a, co, kernel="auto", **kw)
    assert out.shape == co.shape
    res = th.hpr_solve(_small_graph(), HPRConfig(max_sweeps=3), device="cpu")
    assert res.num_steps >= 1
    th.hpr_solve_batch(_small_graph(), HPRConfig(max_sweeps=3), n_replicas=2,
                       device="cpu")
    assert bdcm_cuda.LAUNCHES == before


def test_bdcm_gate_refused_class_raises_under_cuda_and_counts_under_auto():
    """The gate admits every class with 1 <= T <= 6 in both dtypes, up to
    degrees whose factor the card cannot hold: the reference regime
    (T <= 4, d <= 8), the lattices beyond a block's shared memory on the
    global path, and T = 5, 6. On a CUDA device a class it refuses (T = 7,
    d = 0, a factor too large, float16) raises under kernel='auto' as under
    'cuda': nothing runs on the plain version there, so there is no count
    of plain classes to keep. The mode resolution needs no card: it reads
    only the device type."""
    f32, f64 = torch.float32, torch.float64
    for dt in (f32, f64):
        for T in range(1, 7):
            for d in range(1, 11):
                assert bdcm_cuda.bdcm_kernel_supported(d, T, dt), (d, T, dt)
    for d, T, dt in ((40, 2, f32), (119, 2, f64), (12, 4, f32), (9, 4, f64),
                     (1, 5, f32), (120, 2, f64), (10, 4, f64), (13, 4, f32),
                     (20, 5, f64), (12, 6, f32)):
        assert bdcm_cuda.bdcm_kernel_supported(d, T, dt)
    assert [bdcm_cuda.launch_plan(d, T, f32)["path"]
            for d, T in ((2, 2), (3, 2), (8, 1), (5, 2), (3, 3), (8, 4),
                         (13, 4), (3, 5), (2, 6), (5, 6))] == \
        ["register"] * 3 + ["block"] * 3 + ["global", "block", "block",
                                            "global"]
    for d, T, dt in ((1, 7, f32), (0, 2, f32), (13, 6, f32), (11, 6, f64),
                     (3, 2, torch.float16)):
        assert not bdcm_cuda.bdcm_kernel_supported(d, T, dt)
        for kernel in ("cuda", "auto"):
            with pytest.raises(ValueError, match="refuses"):
                tb.class_mode(d, T, dt, kernel, "cuda")
    assert tb.resolve_modes([3, 40], T=2, dtype=f32, kernel="auto",
                            device="cuda") == ("cuda", "cuda")
    assert tb.resolve_modes([3], T=2, dtype=f32, kernel="auto",
                            device="cpu") == ("plain",)
    assert not hasattr(bdcm_cuda, "PLAIN_CLASSES")
    with pytest.raises(ValueError, match="not"):
        bdcm_cuda.check_launch(*_contract_cpu_inputs(), d=3, T=2)
