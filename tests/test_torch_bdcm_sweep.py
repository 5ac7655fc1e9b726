"""The one-launch BDCM sweep kernel's plain twin and launch plan
(``graphdyn_torch/ops/bdcm_sweep.py``), on the CPU.

- The kernel's decomposition (:func:`bdcm_sweep.sweep_plain`: rows read by
  class id, the bias read through the source node, the mask, the rows in no
  class copied through) against the port's plain ``_sweep_core`` bit for
  bit on every real row, and against the JAX package's XLA sweep
  (``make_sweep(use_pallas=False)``) at f32 rtol 1e-5 / f64 rtol 1e-12: on
  RRG(60, 4) in the HPr variant with a node bias, on a padded ER union in
  the entropy variant with a class of d ≥ 5, and on a G=3 stacked grid of
  ER cells with a per-group factor (each cell against its own JAX sweep).
- The launch plan: the class order, each class's path, the block size and
  the largest shared memory, the refusals, the int32 tables equal to the
  int64 ones, the class ids and the rows in no class.

The CUDA kernel itself runs only on a GPU; ``chip_smoke.py`` holds it
against ``sweep_plain`` and the plain ``_sweep_core`` there.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.ops import bdcm as jb
from graphdyn_torch import interop
from graphdyn_torch.config import EntropyConfig
from graphdyn_torch.graphs import graph_from_edges
from graphdyn_torch.ops import bdcm as tb
from graphdyn_torch.ops import bdcm_cuda
from graphdyn_torch.ops import bdcm_sweep as bs
from graphdyn_torch.pipeline.entropy_group import EntropyCellExec

TOL = {"float32": dict(rtol=1e-5, atol=1e-7),
       "float64": dict(rtol=1e-12, atol=1e-15)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _port(g_j):
    return interop.graph_from_arrays(g_j.nbr, g_j.deg, g_j.edges)


def _er_union_j(count=3, n=80, c=5.0):
    """A union of ER graphs with degree up to ~12: edge classes d ≥ 5."""
    gs = [jg.remove_isolates(jg.erdos_renyi_graph(n, c / (n - 1), seed=s))[0]
          for s in range(count)]
    return jg.disjoint_union(gs)[0]


def _plan_of(sweep, G, rows, data):
    """The kernel's plan built from a plain sweep's int64 tables."""
    st, _, valid = sweep.args
    spec = sweep.spec
    return bs.build_plan(st.classes, G=G, rows=rows, T=spec.T,
                         dtype=data.dtype, padded=spec.padded,
                         masked=spec.mask_invalid_src, valid=valid,
                         src=st.src)


def _ext(chi, data):
    K = data.K
    if not data.padded:
        return chi
    return torch.cat([chi, torch.full((1, K, K), 1.0 / (K * K),
                                      dtype=chi.dtype)])


CASES = ["rrg60_hpr", "er_union_padded_entropy"]


def _case(name):
    if name == "rrg60_hpr":
        g_j = jg.random_regular_graph(60, 4, seed=2)
        return g_j, None, dict(damp=0.4, eps_clamp=0.0, mask_invalid_src=False,
                               with_bias=True), 25.0
    return _er_union_j(), 16, dict(damp=0.1, eps_clamp=1e-12,
                                   mask_invalid_src=True), 0.8


@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("name", CASES)
def test_sweep_plain_twin_equals_plain_route_and_xla(name, dt, x64):
    """One sweep: the twin == the plain ``_sweep_core`` bit for bit on the
    real rows (the ghost row is sliced off by every caller), and both
    within the stated tolerance of the JAX package's XLA sweep."""
    g_j, bucket, kw, lmbd = _case(name)
    dj = jb.BDCMData(g_j, class_bucket=bucket, dtype=jnp.dtype(dt))
    dtp = tb.BDCMData(_port(g_j), class_bucket=bucket, dtype=dt)
    if name == "er_union_padded_entropy":
        assert max(c.d for c in dtp.edge_classes) >= 5
        assert any(bdcm_cuda.launch_plan(c.d, dtp.T, dtp.dtype)["path"]
                   == "block" for c in dtp.edge_classes)
    chi = dtp.init_messages(5)
    sweep = tb.make_sweep(dtp, device="cpu", **kw)
    rows = dtp.num_directed + (1 if dtp.padded else 0)
    plan = _plan_of(sweep, 1, rows, dtp)
    _, As, valid = sweep.args
    a_t = tb.tilted_factors(As, torch.as_tensor(dtp.x0, dtype=dtp.dtype),
                            lmbd)
    args_j = [jnp.asarray(chi.numpy()), jnp.asarray(lmbd, jnp.dtype(dt))]
    if kw.get("with_bias"):
        rng = np.random.default_rng(7)
        biases = rng.random((dtp.n, 2)).astype(dtp.np_dtype)
        sel = dtp.x0 == 1
        src = dtp.tables.src
        be = np.where(sel[None], biases[src, 0, None], biases[src, 1, None])
        args_j.append(jnp.asarray(be.astype(dtp.np_dtype)))
        bias = bs.NodeBias(torch.from_numpy(biases))
        via_nodes = sweep(chi, lmbd, biases=torch.from_numpy(biases))
        via_edges = sweep(chi, lmbd, torch.from_numpy(be))
        assert torch.equal(via_nodes, via_edges)
    else:
        bias = None
    want = np.asarray(jb.make_sweep(dj, use_pallas=False, **kw)(*args_j))
    ce = _ext(chi, dtp)[None]
    route = tb._sweep_core(ce, a_t, bias, valid, sweep.args[0], sweep.spec)
    twin = bs.sweep_plain(ce, a_t, bias, plan, damp=kw["damp"],
                          eps_clamp=kw["eps_clamp"])
    n_real = dtp.num_directed
    assert torch.equal(twin[0, :n_real], route[0, :n_real])
    if dtp.padded:
        assert torch.equal(twin[0, n_real:], ce[0, n_real:])
    np.testing.assert_allclose(twin[0, :n_real].numpy(), want, **TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_sweep_plain_twin_stacked_grid_per_group_factor(dt, x64):
    """A G=3 stack of ragged ER cells, each at its own λ (the per-group
    factor): the twin == ``EntropyCellExec``'s plain sweep bit for bit, and
    each cell's rows within tolerance of the JAX sweep of that cell alone."""
    cfg = EntropyConfig(dtype=dt, eps_clamp=1e-12)
    gjs = [jg.remove_isolates(jg.erdos_renyi_graph(n, 2.5 / (n - 1), seed=s))[0]
           for n, s in ((50, 1), (70, 2), (60, 3))]
    datas = [tb.BDCMData(_port(g), class_bucket=8, dtype=dt) for g in gjs]
    ex = EntropyCellExec([(d, d.n, 0) for d in datas], cfg, kernel="plain",
                         device="cpu")
    lmbds = [0.2, 0.9, 1.7]
    chis = [d.init_messages(11 + k) for k, d in enumerate(datas)]
    chi = ex.stack_chi(chis)
    a_t = ex.factors(lmbds)
    assert a_t[0].ndim == 4 and a_t[0].shape[0] == 3
    plan = bs.build_plan(ex.tables.classes, G=3, rows=ex.rows, T=ex.spec.T,
                         dtype=ex.dtype, padded=True, masked=True,
                         valid=ex.valid)
    route = ex.sweep(chi, a_t)
    twin = bs.sweep_plain(chi, a_t, None, plan, damp=cfg.damp,
                          eps_clamp=cfg.eps_clamp)
    for g, d in enumerate(datas):
        e2 = d.num_directed
        assert torch.equal(twin[g, :e2], route[g, :e2])
        dj = jb.BDCMData(gjs[g], dtype=jnp.dtype(dt))
        want = jb.make_sweep(dj, damp=cfg.damp, eps_clamp=cfg.eps_clamp,
                             mask_invalid_src=True, use_pallas=False)(
            jnp.asarray(chis[g].numpy()), jnp.asarray(lmbds[g], jnp.dtype(dt)))
        np.testing.assert_allclose(twin[g, :e2].numpy(), np.asarray(want),
                                   **TOL[dt])


def test_sweep_plan_tables_order_paths_and_memory():
    """The plan of a padded ER union: classes in ``spec.class_ds`` order,
    each class's path from ``launch_plan``, one block size, the largest
    shared memory over the classes, the int32 tables equal to the int64
    ones, class ids on the real members' rows and every other row passed
    through."""
    dtp = tb.BDCMData(_port(_er_union_j()), class_bucket=16)
    sweep = tb.make_sweep(dtp, damp=0.1, device="cpu")
    rows = dtp.num_directed + 1
    plan = _plan_of(sweep, 1, rows, dtp)
    spec, T = sweep.spec, dtp.T
    assert plan.class_ds == spec.class_ds == tuple(sorted(spec.class_ds))
    assert plan.paths == tuple(bdcm_cuda.launch_plan(d, T, dtp.dtype)["path"]
                               for d in spec.class_ds)
    assert {"register", "block"} <= set(plan.paths)
    assert plan.threads == 256
    K = dtp.K

    def smem(d, path):
        M = (d + 1) ** T
        if path == "register":
            stride = d * K * K
            while stride % 32 != K % 32:
                stride += 1
            return (256 // K * stride + K * K * M) * 4
        return (2 * M + K * K + 8 * K + 3 * K) * 4

    assert plan.smem == max(smem(d, p) for d, p in zip(plan.class_ds,
                                                       plan.paths))
    cid = plan.cid.long()
    owned = torch.zeros(rows, dtype=torch.bool)
    for c, ((idx, ie), i32, e32) in enumerate(zip(sweep.args[0].classes,
                                                   plan.idx, plan.in_edges)):
        assert i32.dtype == e32.dtype == torch.int32
        assert torch.equal(i32.long(), idx.reshape(-1))
        assert torch.equal(e32.long(), ie.reshape(e32.shape))
        real = idx.reshape(-1)[idx.reshape(-1) != rows - 1]
        assert bool((cid[real] == c).all())
        owned[real] = True
    assert int(cid[rows - 1]) == bs.NO_CLASS
    assert torch.equal(torch.sort(plan.pass_rows.long())[0],
                       torch.nonzero(~owned).reshape(-1))
    assert plan.pass_rows.numel() == dtp.leaf_idx.size + 1


def test_sweep_plan_refusals():
    """A class the kernel refuses (T = 7; a factor the card cannot hold),
    too many classes, a row in two classes and an id outside the rows
    raise; there is no fallback. The two shapes refused before the
    global-lattice path, (d=3, T=5) in f32 and (d=500, T=2) in f64, are
    admitted: the first on the block path, the second on the global
    path."""
    with pytest.raises(ValueError, match="refuses.*T <= 6"):
        bs.launch_shape((3,), 7, torch.float32)
    with pytest.raises(ValueError, match="refuses.*cannot be allocated"):
        bs.launch_shape((2, 20), 6, torch.float32)
    assert bs.launch_shape((3,), 5, torch.float32)[0] == ("block",)
    assert bs.launch_shape((500,), 2, torch.float64)[0] == ("global",)
    with pytest.raises(ValueError, match="at most"):
        bs.launch_shape((1,) * (bs.MAX_CLASSES + 1), 1, torch.float32)
    idx = torch.tensor([[0, 1]])
    ie = torch.tensor([[[2], [3]]])
    kw = dict(G=1, rows=4, T=1, dtype=torch.float32, padded=False,
              masked=False, valid=torch.ones(2))
    bs.build_plan([(idx, ie)], **kw)
    with pytest.raises(ValueError, match="two edge classes"):
        bs.build_plan([(idx, ie), (torch.tensor([[1]]), torch.tensor([[[0]]]))],
                      **kw)
    with pytest.raises(ValueError, match="outside"):
        bs.build_plan([(idx, torch.tensor([[[2], [4]]]))], **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 6])
def test_sweep_limit_is_the_class_count_only(T, dtype):
    """What the one-launch sweep refuses beyond the per-class kernel's gate:
    more than ``MAX_CLASSES`` edge classes, and nothing else. Every class
    the per-class gate admits fits the sweep's one block size beside a
    class of d = 1; the class table lives in device memory, so the limit is
    the int16 class id's (32767 classes, the no-class id above them):
    several hundred classes run, 32768 raise."""
    admitted = [d for d in range(1, 400)
                if bdcm_cuda.bdcm_kernel_supported(d, T, dtype)]
    # every degree up to the first whose factor the card cannot hold
    assert admitted == list(range(1, len(admitted) + 1))
    assert len(admitted) >= (10 if T == 6 else 20)
    for d in admitted:
        paths, threads, smem = bs.launch_shape((1, d), T, dtype)
        assert smem <= bdcm_cuda.SMEM_MAX and threads <= bdcm_cuda.THREADS
    assert bs.MAX_CLASSES == bs.NO_CLASS == 2**15 - 1
    many = tuple(admitted[i % len(admitted)] for i in range(500))
    paths, _, _ = bs.launch_shape(many, T, dtype)
    assert len(paths) == 500
    with pytest.raises(ValueError, match=f"at most {bs.MAX_CLASSES} edge "
                                         f"classes, got {bs.MAX_CLASSES + 1}"):
        bs.launch_shape((1,) * (bs.MAX_CLASSES + 1), T, dtype)


def _caterpillar(degrees):
    """A tree of hubs in a path, hub k of degree ``degrees[k]`` (leaves make
    up the rest): one edge class per hub degree, d = degree − 1."""
    H = len(degrees)
    edges = [(k, k + 1) for k in range(H - 1)]
    n = H
    for k, D in enumerate(degrees):
        for _ in range(D - (k > 0) - (k < H - 1)):
            edges.append((k, n))
            n += 1
    return graph_from_edges(n, np.array(edges))


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_sweep_plan_and_twin_beyond_64_classes(dt):
    """A sweep of 66 edge classes (hub degrees 2..67, T = 1): the plan's
    int16 class ids, its 66 class descriptors (the words the kernel reads
    from device memory), and the twin equal to the plain route bit for bit
    on every row a class owns."""
    data = tb.BDCMData(_caterpillar(range(2, 68)), p=0, c=1, dtype=dt)
    sweep = tb.make_sweep(data, damp=0.1, device="cpu")
    plan = _plan_of(sweep, 1, data.num_directed, data)
    assert plan.class_ds == tuple(range(1, 67))
    assert plan.cid.dtype == torch.int16
    _, As, valid = sweep.args
    a_t = tb.tilted_factors(As, torch.as_tensor(data.x0, dtype=data.dtype),
                            0.5)
    desc = bs.class_descriptors(a_t, plan)
    assert desc.shape == (66, bs.DESC_WORDS)
    assert desc[:, 3].tolist() == list(plan.Ed)
    assert desc[:, 5].tolist() == list(plan.class_ds)
    assert desc[:, 6].tolist() == [bdcm_cuda.PATHS[p] for p in plan.paths]
    assert desc[:, 2].tolist() == [a.data_ptr() for a in a_t]
    chi = data.init_messages(3)[None]
    kw = dict(damp=0.1, eps_clamp=0.0)
    twin = bs.sweep_plain(chi, a_t, None, plan, **kw)
    route = tb._sweep_core(chi, a_t, None, valid, sweep.args[0], sweep.spec)
    owned = plan.cid.long() != bs.NO_CLASS
    K = data.K
    assert torch.equal(twin.reshape(-1, K, K)[owned],
                       route.reshape(-1, K, K)[owned])


def test_sweep_cuda_refuses_cpu_tensors():
    """The wrapper launches or raises: a CPU chi is refused, never run on
    the plain version."""
    dtp = tb.BDCMData(_port(jg.random_regular_graph(20, 3, seed=1)))
    sweep = tb.make_sweep(dtp, damp=0.4, device="cpu")
    plan = _plan_of(sweep, 1, dtp.num_directed, dtp)
    _, As, _ = sweep.args
    with pytest.raises(ValueError, match="not CUDA"):
        bs.sweep_cuda(dtp.init_messages(0)[None], As, None, plan, damp=0.4,
                      eps_clamp=0.0)


def test_sweep_bias_forms_read_the_same_weights():
    """The kernel's two bias reads: per-row weights at column k (no source
    table, so the kernel reads the identity column and the wrapper passes
    no column bits), node biases at column 0 where x_k(0) = +1 (else 1)
    through the source table, bit k of the columns the wrapper passes (one
    bit per trajectory, so K = 64 fits). The columns the wrapper passes for
    each, and the twin on the two forms of the same weights, bit for
    bit."""
    g_j = jg.random_regular_graph(30, 3, seed=4)
    dtp = tb.BDCMData(_port(g_j))
    sweep = tb.make_sweep(dtp, damp=0.4, mask_invalid_src=False,
                          with_bias=True, device="cpu")
    plan = _plan_of(sweep, 1, dtp.num_directed, dtp)
    K = dtp.K
    biases = torch.from_numpy(np.random.default_rng(2).random((dtp.n, 2))
                              .astype(np.float32))
    src = torch.as_tensor(dtp.tables.src).long()
    per_row = torch.where(torch.as_tensor(dtp.x0 == 1), biases[src, 0, None],
                          biases[src, 1, None])[None].contiguous()
    _, s_node, stride_node, cols_node = bs.bias_args(bs.NodeBias(biases), plan)
    _, s_row, stride_row, cols_row = bs.bias_args(per_row, plan)
    assert (stride_node, stride_row) == (2, K) and s_row is None
    assert torch.equal(s_node.long(), src)
    assert cols_row == 0
    assert [(cols_node >> k) & 1 for k in range(K)] == \
        [0 if x == 1 else 1 for x in dtp.x0]
    assert cols_node < 2**K
    _, As, _ = sweep.args
    a_t = tb.tilted_factors(As, torch.as_tensor(dtp.x0, dtype=dtp.dtype), 3.0)
    chi = dtp.init_messages(1)[None]
    kw = dict(damp=0.4, eps_clamp=0.0)
    assert torch.equal(bs.sweep_plain(chi, a_t, bs.NodeBias(biases), plan, **kw),
                       bs.sweep_plain(chi, a_t, per_row, plan, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_plan_global_exactly_past_the_block_path(dtype):
    """``launch_plan`` takes the global-lattice path exactly where the block
    path's two lattice rows and the edge's shared elements no longer fit a
    block's shared memory (and the class is neither a register class nor
    refused), with 2M elements of workspace per resident block; the other
    paths need no workspace."""
    esize = 8 if dtype == torch.float64 else 4
    seen = set()
    for T in range(1, 7):
        for d in range(1, 60):
            plan = bdcm_cuda.launch_plan(d, T, dtype)
            K, M = 2**T, (d + 1) ** T
            seen.add(plan["path"])
            if plan["path"] == "register":
                assert T <= 4 and M <= 32 and d <= 8
                continue
            threads = min(256, -(-M // 32) * 32)
            block = (2 * M + K * K + threads // 32 * K + 2 * 256 + K) * esize
            assert plan["factor"] == K * K * M * esize
            if block <= bdcm_cuda.SMEM_MAX:
                assert plan == {"path": "block", "threads": threads,
                                "smem": block, "workspace": 0,
                                "factor": K * K * M * esize}
            elif plan["path"] == "global":
                assert plan["threads"] == 256
                assert plan["smem"] == (K * K + 8 * K + 2 * 256 + K) * esize
                assert plan["workspace"] == 2 * M * esize
                assert plan["factor"] + plan["workspace"] <= \
                    bdcm_cuda.DEVICE_BYTES
            else:
                assert plan["path"] == "refused"
                assert plan["factor"] + 2 * M * esize > bdcm_cuda.DEVICE_BYTES
    assert seen == {"register", "block", "global", "refused"}
    # the first global classes at T = 4 (ROADMAP C2's table)
    first = 13 if dtype == torch.float32 else 10
    assert bdcm_cuda.launch_plan(first - 1, 4, dtype)["path"] == "block"
    assert bdcm_cuda.launch_plan(first, 4, dtype)["path"] == "global"


def test_launch_shape_mixes_the_three_paths_and_the_workspace():
    """One sweep mixes register, block and global classes in one launch
    (one block size, the largest shared memory over the classes); the
    workspace per slot is the widest global class's 2M elements: at d = 18,
    T = 4, float32, M = 19^4 = 130,321, 1,042,568 bytes; the slots are
    min(members, 2 per SM, budget / slot), at least 1."""
    f32 = torch.float32
    paths, threads, smem = bs.launch_shape((1, 5, 13, 18), 4, f32)
    assert paths == ("register", "block", "global", "global")
    assert threads == 256
    assert smem == max(bs.class_smem(d, 4, p, 256, f32)
                       for d, p in zip((1, 5, 13, 18), paths))
    assert bs.class_smem(18, 4, "global", 256, f32) == \
        (256 + 128 + 2 * 256 + 16) * 4
    assert bdcm_cuda.launch_plan(18, 4, f32)["workspace"] == 2 * 19**4 * 4 \
        == 1_042_568
    ws = bdcm_cuda.launch_plan(18, 4, f32)["workspace"]
    assert bdcm_cuda.workspace_slots(ws, 10_000, 132) == 264
    assert bdcm_cuda.workspace_slots(ws, 18, 132) == 18
    assert bdcm_cuda.workspace_slots(0, 18, 132) == 0
    assert bdcm_cuda.workspace_slots(bdcm_cuda.WS_BUDGET * 3, 5, 132) == 1
    # a sweep's plan: a hub of degree 19 beside degree-2 and degree-6 nodes
    edges = [(0, k) for k in range(1, 20)] + [(k, k + 1) for k in range(1, 19)]
    edges += [(20, k) for k in (1, 3, 5, 7, 9, 11)]
    g = graph_from_edges(21, np.array(edges))
    dtp = tb.BDCMData(g, p=3, c=1)
    sweep = tb.make_sweep(dtp, damp=0.1, device="cpu")
    plan = _plan_of(sweep, 1, dtp.num_directed, dtp)
    assert "global" in plan.paths and "block" in plan.paths
    d_hub = max(plan.class_ds)
    assert d_hub == 18
    assert plan.ws_bytes == 2 * 19**4 * 4
    assert plan.ws_members == 19             # the hub's out-edges


def test_refusals_above_T6_and_in_the_c_entries():
    """T = 7 is refused by the gate with its reason (the per-class wrapper's
    check raises before any launch), and both C entries refuse a T they
    have no instantiation for instead of running another T's: the sweep
    kernel's ``kernel_for`` returns null past T = 6 and the entry checks
    ``T > kMaxT``; the per-class kernel's ``dispatch`` returns
    cudaErrorInvalidValue for any other T."""
    for dt in (torch.float32, torch.float64):
        assert bdcm_cuda.launch_plan(1, 7, dt)["path"] == "refused"
        assert "T <= 6" in bdcm_cuda.refusal_reason(1, 7, dt)
        with pytest.raises(ValueError, match="refuses"):
            tb.class_mode(1, 7, dt, "auto", "cuda")
    csrc = os.path.join(os.path.dirname(bs.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "bdcm_sweep.cu")) as f:
        sweep = f.read()
    with open(os.path.join(csrc, "bdcm_contract.cu")) as f:
        contract = f.read()
    with open(os.path.join(csrc, "bdcm_dp.cuh")) as f:
        dp = f.read()
    assert "constexpr int kMaxT = 6;" in dp
    body = sweep[sweep.index("KernelFn kernel_for(int T, int need)"):]
    body = body[:body.index("\n}\n")]
    assert [f"case {t}: return variant<F, {t}>(need);" in body
            for t in range(1, 8)] == [True] * 6 + [False]
    # each path is compiled only into the instantiations whose set holds
    # it, and a sweep runs the smallest set that holds its classes' paths
    var = sweep[sweep.index("KernelFn variant(int need)"):]
    var = var[:var.index("\n}\n")]
    assert [f"return bdcm_sweep_kernel<F, T, {m}>;" in var
            for m in range(1, 8)] == [True, True, True, False, False, True,
                                      True]
    for bit, phase in ((1, "reg_dispatch<F, T>"),
                       (2, "lattice_phase<F, T, false>"),
                       (4, "lattice_phase<F, T, true>")):
        at = sweep.index(f"if constexpr ((kPaths & {bit}) != 0)")
        assert phase in sweep[at:at + 160]
    assert "default: return nullptr;" in body
    assert "T > kMaxT" in sweep and "if (!fn) return (int)cudaErrorInvalidValue;" in sweep
    assert "T > kMaxT" in contract
    disp = contract[contract.index("cudaError_t dispatch("):]
    for launch in ("launch_block", "launch_global"):
        assert [f"case {t}: return {launch}<F, {t}>(L);" in disp
                for t in range(1, 8)] == [True] * 6 + [False]
    assert disp.count("default: return cudaErrorInvalidValue;") == 3
