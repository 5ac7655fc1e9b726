"""The port's ensemble meshes on spawned gloo ranks (one spawn of 4 ranks
for the module; P = 2 runs on a 2 × 2 mesh), each held bit for bit to the
port's unsharded run and to the JAX package's mesh version on its 8-device
CPU mesh, on the same inputs. The JAX package draws from ``jax.random``
and the port from its own counter streams, so the cases held to the JAX
package replay the JAX draws in the port (HPr's per-sweep uniforms through
``uniforms=``, the SA chains' and the ladder's proposals, uniforms and
swap uniforms through ``torch_ranks.replayed_sa_draws``/``replayed_swaps``
and ``temper_search(proposals=, uniforms=)``); one case per driver runs on
the port's own stream and is held to the port's unsharded run:

- ``hpr_solve_batch(mesh=)`` on the replica axis at two R (one padded), in
  float64, and a run preempted on one mesh shape and resumed on another,
  after ``tests/test_hpr.py:215``; every chain ends at consensus or the
  timeout sentinel, as the JAX package's mesh test asserts. No field needs
  a tolerance: ``s`` and ``num_steps`` are integers, ``mag_reached`` and
  ``m_final`` follow from ``s``;
- the entropy cell group on the cell axis (``EntropyCellExec(mesh=)``),
  after ``tests/test_pipeline.py:422``, and within the port's f32 ladder
  tolerance (atol 1e-4) of the JAX package's cell mesh;
- ``sa_ensemble_grouped(mesh=)`` on the group axis, after ``:331``, and a
  run preempted at a repetition boundary and resumed on another mesh;
- ``temper_search(mesh=)`` on the lane axis at P ∈ {2, 4}, with a graph
  size the shard count does not divide, with ``stop_on_first`` (a shard
  replays its chunk up to another shard's first passage), and a ladder
  preempted at one lane-shard count and requeued at another, after
  ``tests/test_search.py:139-174``;
- the refusals (lanes, groups and cells that do not split; the HPr chunk
  program's ``Rtot``)."""

import contextlib
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from graphdyn import graphs as jg
from graphdyn.config import (
    DynamicsConfig as JDyn,
    HPRConfig as JHPRConfig,
    SAConfig as JSA,
)
from graphdyn.parallel.mesh import device_pool, make_mesh as jax_mesh
from graphdyn_torch import graphs as tg
from graphdyn_torch.config import (
    DynamicsConfig,
    EntropyConfig,
    HPRConfig,
    SAConfig,
)

import torch_ranks

HPR_G = dict(n=30, d=3, seed=1)
#: sweeps of the HPr runs (some chains reach the timeout sentinel)
HPR_RUN = dict(max_sweeps=300)
#: the SA groups' step budget, their stream seed and largest n_stat
SAG_STEPS, SAG_SEED, SAG_STAT = 2000, 7, 8
TEMPER = dict(n=96, gs=0, lanes=8, seed=2, max_steps=4000,
              swap_interval=111)
TEMPER_ODD = dict(n=95, d=4, gs=1, lanes=4, seed=0, max_steps=3000,
                  swap_interval=137)


@contextlib.contextmanager
def _x64():
    """float64 on the JAX side, switched back afterwards."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------------------
# the JAX package's draws and mesh runs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _hpr_stream(R):
    """The JAX batch's float64 uniforms ``[sweeps, R, n]``: chain ``r``
    starts from ``split(PRNGKey(0), R)[r]`` and each sweep splits its key
    and draws from the second half (``graphdyn/models/hpr.py``)."""
    n, sweeps = HPR_G["n"], HPR_RUN["max_sweeps"] + 2

    def body(k, _):
        ks = jax.vmap(jax.random.split)(k)
        return ks[:, 0], jax.vmap(
            lambda kk: jax.random.uniform(kk, (n,), jnp.float64))(ks[:, 1])

    with _x64():
        keys = jax.random.split(jax.random.PRNGKey(0), R)
        return np.asarray(jax.jit(
            lambda k: jax.lax.scan(body, k, None, length=sweeps)[1])(keys))


@functools.lru_cache(maxsize=None)
def _jax_hpr(R, P):
    from graphdyn.models.hpr import hpr_solve_batch

    g = jg.random_regular_graph(HPR_G["n"], HPR_G["d"], seed=HPR_G["seed"])
    with _x64():
        res = hpr_solve_batch(
            g, JHPRConfig(dtype="float64", **HPR_RUN), n_replicas=R, seed=0,
            mesh=jax_mesh((P,), ("replica",), devices=device_pool(P)),
            kernel="xla")
    return {f: np.asarray(getattr(res, f)) for f in HPR_FIELDS}


@functools.lru_cache(maxsize=None)
def _sa_draws(K, n, seed, steps):
    """The JAX package's SA draws of keys ``PRNGKey(seed + k)``, k < K, at
    steps 0..steps−1: ``(seed, proposals int32[K, steps], uniforms
    f32[K, steps])``."""
    from graphdyn.models.sa import draw_sa_proposal

    keys = jax.vmap(jax.random.PRNGKey)(
        np.arange(K, dtype=np.uint32) + np.uint32(seed))

    def at(t):
        return draw_sa_proposal(keys, jnp.full((K,), t, jnp.int32), None,
                                None, injected=False, stream_len=1, n=n,
                                dt=jnp.float32)

    i, u = jax.jit(jax.vmap(at))(jnp.arange(steps, dtype=jnp.int32))
    return seed, np.ascontiguousarray(np.asarray(i).T), \
        np.ascontiguousarray(np.asarray(u).T)


@functools.lru_cache(maxsize=None)
def _swap_draws(K, seed, rounds):
    """The JAX ladder's swap uniforms ``f32[rounds, K]``."""
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                             np.uint32(0x53574150))
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, np.uint32(r)), (K,), jnp.float32))
        for r in range(rounds)])


def _temper_streams(lanes, n, seed, max_steps, swap_interval, **_):
    """A ladder case's JAX streams, as the worker takes them."""
    _, I, U = _sa_draws(lanes, n, seed, max_steps + 1)
    return dict(I=I, U=U,
                SW=_swap_draws(lanes, seed, max_steps // swap_interval + 2))


def _cases():
    sag = dict(draws=_sa_draws(SAG_STAT, 30, SAG_SEED, SAG_STEPS + 1))
    hpr = dict(dtype="float64", **HPR_RUN)
    temper = dict(TEMPER, **_temper_streams(**TEMPER))
    cases = [
        dict(key="hpr-8-2", what="hpr", R=8, P=2, U=_hpr_stream(8), **hpr),
        dict(key="hpr-8-4", what="hpr", R=8, P=4, U=_hpr_stream(8), **hpr),
        dict(key="hpr-5-4", what="hpr", R=5, P=4, U=_hpr_stream(5), **hpr),
        dict(key="hpr-resume", what="hpr", R=8, chunk=40,
             legs=[(4, 2), (2, None)], U=_hpr_stream(8), **hpr),
        dict(key="hpr-own-8-4", what="hpr", R=8, P=4, **HPR_RUN),
        dict(key="cells-2", what="cells", P=2),
        dict(key="cells-4", what="cells", P=4),
        dict(key="sag-2", what="sa_group", P=2, n=30, n_stat=8, group=4,
             max_steps=SAG_STEPS, **sag),
        dict(key="sag-4", what="sa_group", P=4, n=30, n_stat=6, group=4,
             max_steps=SAG_STEPS, **sag),
        dict(key="sag-resume", what="sa_group", n=30, n_stat=8, group=4,
             max_steps=SAG_STEPS, site="rep.boundary",
             legs=[(4, 2), (2, None)], **sag),
        dict(key="sag-own-2", what="sa_group", P=2, n=30, n_stat=8, group=4,
             max_steps=SAG_STEPS),
        dict(key="temper-2", what="temper", P=2, **temper),
        dict(key="temper-4", what="temper", P=4, **temper),
        dict(key="temper-odd", what="temper", P=2, **TEMPER_ODD,
             **_temper_streams(**TEMPER_ODD)),
        dict(key="temper-first", what="temper", P=4, stop_on_first=True,
             **temper),
        dict(key="temper-requeue", what="temper",
             legs=[(4, 2), (2, None)], **temper),
        dict(key="temper-own-4", what="temper", P=4, **TEMPER),
    ]
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank spawn; while its ranks run, this process runs the JAX
    package's mesh versions the tests compare with (cached)."""
    from concurrent.futures import ThreadPoolExecutor

    root = str(tmp_path_factory.mktemp("ensemble_mesh"))
    cases = _cases()
    with ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(torch_ranks.run_ranks, "ensemble_mesh_worker", 4,
                            root, cases, root)
        for _, R, P in HPR_MESHES:
            _jax_hpr(R, P)
        for _, n_stat, P in SAG_MESHES:
            _jax_sag(n_stat, P)
        for _, P, odd, first in TEMPER_MESHES:
            _jax_temper(P, odd=odd, stop_on_first=first)
        return spawn.result()


def _same(got: dict, want: dict, fields=None):
    for f in fields or want:
        a, b = got[f], want[f]
        if isinstance(b, list):
            assert len(a) == len(b), f
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f)
        elif isinstance(b, (float, int)) and f.endswith("_s"):
            continue                       # wall seconds
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)


def _every_rank(res, key):
    for r in res[1:]:
        if isinstance(r[key], dict):
            _same(r[key], res[0][key])
    return res[0][key]


# ---------------------------------------------------------------------------
# HPr's replica mesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _hpr_unsharded(R, replay=True):
    """The port's unsharded run: float64 under the JAX package's uniforms,
    or (``replay=False``) float32 on the port's own stream."""
    from graphdyn_torch.models.hpr import hpr_solve_batch

    g = tg.random_regular_graph(HPR_G["n"], HPR_G["d"], seed=HPR_G["seed"])
    if not replay:
        return hpr_solve_batch(g, HPRConfig(**HPR_RUN), n_replicas=R,
                               seed=0, device="cpu")._asdict()
    U = _hpr_stream(R)
    return hpr_solve_batch(g, HPRConfig(dtype="float64", **HPR_RUN),
                           n_replicas=R, seed=0, uniforms=lambda t: U[t],
                           device="cpu")._asdict()


HPR_FIELDS = ("s", "mag_reached", "num_steps", "m_final")
HPR_MESHES = [("hpr-8-2", 8, 2), ("hpr-8-4", 8, 4), ("hpr-5-4", 5, 4)]


@pytest.mark.parametrize("key,R", [(k, R) for k, R, _ in HPR_MESHES])
def test_hpr_replica_mesh_equals_unsharded(ranks, key, R):
    got = _every_rank(ranks, key)
    _same(got, _hpr_unsharded(R), HPR_FIELDS)
    assert got["s"].shape == (R, HPR_G["n"])
    assert np.all((got["m_final"] == 1.0) | (got["m_final"] == 2.0))


@pytest.mark.parametrize("key,R,P", HPR_MESHES)
def test_hpr_replica_mesh_equals_the_jax_mesh(ranks, key, R, P):
    want = _jax_hpr(R, P)
    assert np.any(want["m_final"] == 1.0)       # a chain reaches consensus
    _same(_every_rank(ranks, key), want, HPR_FIELDS)


def test_hpr_replica_mesh_own_stream_equals_unsharded(ranks):
    _same(_every_rank(ranks, "hpr-own-8-4"), _hpr_unsharded(8, replay=False),
          HPR_FIELDS)


def test_hpr_mesh_resume_on_another_shape(ranks):
    for r in ranks:
        legs = r["hpr-resume"]
        assert [s for s, _ in legs] == ["preempted", "done"]
        _same(legs[1][1], _hpr_unsharded(8), HPR_FIELDS)
        _same(legs[1][1], _jax_hpr(8, 2), HPR_FIELDS)


# ---------------------------------------------------------------------------
# the entropy cell mesh
# ---------------------------------------------------------------------------


def _cells(gmod, bdcm):
    cells, chis = [], []
    for sd in range(4):
        g = gmod.erdos_renyi_graph(40, (1.0 + 0.3 * sd) / 39, seed=sd)
        sub, n_iso = gmod.remove_isolates(g)
        data = bdcm(sub, p=1, c=1, class_bucket=32)
        cells.append((data, g.n, n_iso))
        chis.append(np.asarray(data.init_messages(sd)))
    return cells, chis


@pytest.mark.parametrize("P", [2, 4])
def test_cell_mesh_equals_unsharded_and_holds_to_jax(ranks, P):
    import graphdyn.graphs as jg
    from graphdyn.config import EntropyConfig as JEntropyConfig
    from graphdyn.ops.bdcm import BDCMData as JBDCMData
    from graphdyn.parallel.mesh import device_pool, make_mesh
    from graphdyn.pipeline import entropy_group as jeg
    from graphdyn_torch.ops.bdcm import BDCMData
    from graphdyn_torch.pipeline.entropy_group import (
        EntropyCellExec,
        run_cell_ladder,
    )

    got = _every_rank(ranks, f"cells-{P}")
    cfg = EntropyConfig(lmbd_max=0.2, lmbd_step=0.1)
    lambdas = np.array([0.0, 0.1, 0.2])
    cells, chis = _cells(tg, BDCMData)
    base = run_cell_ladder(EntropyCellExec(cells, cfg, group_size=4,
                                           device="cpu"), chis, lambdas,
                           eps=cfg.eps, ent_floor=cfg.ent_floor)._asdict()
    _same(got, base)
    jcfg = JEntropyConfig(lmbd_max=0.2, lmbd_step=0.1)
    jcells, jchis = _cells(jg, JBDCMData)
    mesh = make_mesh((2,), ("cell",), devices=device_pool(2))
    jres = jeg.run_cell_ladder(
        jeg.EntropyCellExec(jcells, jcfg, group_size=4, mesh=mesh), jchis,
        lambdas, eps=jcfg.eps, ent_floor=jcfg.ent_floor)
    for g in range(4):
        np.testing.assert_array_equal(got["lambdas"][g], jres.lambdas[g])
        assert np.all(np.abs(got["sweeps"][g] - jres.sweeps[g]) <= 1)
        np.testing.assert_allclose(got["ent1"][g], jres.ent1[g], rtol=0,
                                   atol=1e-4)
    np.testing.assert_array_equal(got["nonconverged"], jres.nonconverged)


# ---------------------------------------------------------------------------
# the SA group mesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sag_unsharded(n_stat, replay=True):
    """The port's unsharded run, under the JAX package's draws or
    (``replay=False``) on the port's own stream."""
    from graphdyn_torch.pipeline.sa_group import sa_ensemble_grouped

    draws = _sa_draws(SAG_STAT, 30, SAG_SEED, SAG_STEPS + 1) if replay \
        else None
    with torch_ranks.replayed_sa_draws(draws):
        return sa_ensemble_grouped(
            30, 3, SAConfig(dynamics=DynamicsConfig(p=1, c=1)),
            n_stat=n_stat, seed=SAG_SEED, max_steps=SAG_STEPS, group_size=4,
            chunk_steps=256, device="cpu")._asdict()


@functools.lru_cache(maxsize=None)
def _jax_sag(n_stat, P):
    from graphdyn.pipeline.sa_group import sa_ensemble_grouped

    res = sa_ensemble_grouped(
        30, 3, JSA(dynamics=JDyn(p=1, c=1)), n_stat=n_stat, seed=SAG_SEED,
        max_steps=SAG_STEPS, group_size=4, chunk_steps=SAG_STEPS + 1,
        mesh=jax_mesh((P,), ("group",), devices=device_pool(P)))
    return {f: np.asarray(v) for f, v in res._asdict().items()}


SAG_MESHES = [("sag-2", 8, 2), ("sag-4", 6, 4)]


@pytest.mark.parametrize("key,n_stat", [(k, m) for k, m, _ in SAG_MESHES])
def test_sa_group_mesh_equals_unsharded(ranks, key, n_stat):
    _same(_every_rank(ranks, key), _sag_unsharded(n_stat))


@pytest.mark.parametrize("key,n_stat,P", SAG_MESHES)
def test_sa_group_mesh_equals_the_jax_mesh(ranks, key, n_stat, P):
    _same(_every_rank(ranks, key), _jax_sag(n_stat, P))


def test_sa_group_mesh_own_stream_equals_unsharded(ranks):
    _same(_every_rank(ranks, "sag-own-2"), _sag_unsharded(8, replay=False))


def test_sa_group_mesh_resume_on_another_shape(ranks):
    for r in ranks:
        legs = r["sag-resume"]
        assert [s for s, _ in legs] == ["preempted", "done"]
        _same(legs[1][1], _sag_unsharded(8))
        _same(legs[1][1], _jax_sag(8, 2))


# ---------------------------------------------------------------------------
# the lane-sharded ladder
# ---------------------------------------------------------------------------


def _temper_kw(lanes, seed, max_steps, swap_interval, stop_on_first=False,
               **_):
    return dict(n_lanes=lanes, seed=seed, max_steps=max_steps,
                swap_interval=swap_interval, m_target=0.95,
                stop_on_first=stop_on_first)


@functools.lru_cache(maxsize=None)
def _temper_unsharded(replay=True, odd=False, stop_on_first=False):
    """The port's unsharded ladder, under the JAX package's draws or
    (``replay=False``) on the port's own streams."""
    from graphdyn_torch.search.tempering import temper_search

    c = TEMPER_ODD if odd else TEMPER
    g = tg.random_regular_graph(c["n"], c.get("d", 3), seed=c["gs"])
    st = _temper_streams(**c) if replay else {}
    with torch_ranks.replayed_swaps(st.get("SW")):
        return temper_search(
            g, SAConfig(dynamics=DynamicsConfig(p=1, c=1)),
            proposals=st.get("I"), uniforms=st.get("U"), device="cpu",
            **_temper_kw(stop_on_first=stop_on_first, **c))._asdict()


@functools.lru_cache(maxsize=None)
def _jax_temper(P, odd=False, stop_on_first=False):
    from graphdyn.search.tempering import temper_search

    c = TEMPER_ODD if odd else TEMPER
    res = temper_search(
        jg.random_regular_graph(c["n"], c.get("d", 3), seed=c["gs"]),
        JSA(dynamics=JDyn(p=1, c=1)),
        mesh=jax_mesh((P,), ("lane",), devices=device_pool(P)),
        **_temper_kw(stop_on_first=stop_on_first, **c))
    return res._asdict()


@pytest.mark.parametrize("key", ["temper-2", "temper-4"])
def test_temper_lane_shard_bit_parity(ranks, key):
    got = _every_rank(ranks, key)
    _same(got, _temper_unsharded())
    assert got["swap_attempts"] > 0


def test_temper_lane_shards_with_indivisible_n(ranks):
    _same(_every_rank(ranks, "temper-odd"), _temper_unsharded(odd=True))


def test_temper_lane_shards_stop_on_first(ranks):
    _same(_every_rank(ranks, "temper-first"),
          _temper_unsharded(stop_on_first=True))


def test_temper_requeue_with_shard_change(ranks):
    want = _temper_unsharded()
    for r in ranks:
        legs = r["temper-requeue"]
        assert [s for s, _ in legs] == ["preempted", "done"]
        _same(legs[1][1], want)


TEMPER_MESHES = [("temper-2", 2, False, False), ("temper-4", 4, False, False),
                 ("temper-odd", 2, True, False),
                 ("temper-first", 4, False, True)]


@pytest.mark.parametrize("key,P,odd,first", TEMPER_MESHES)
def test_temper_lane_mesh_equals_the_jax_mesh(ranks, key, P, odd, first):
    want = _jax_temper(P, odd=odd, stop_on_first=first)
    _same(_every_rank(ranks, key), want)
    if first:
        assert want["steps_to_target"] > 0


def test_temper_requeue_with_shard_change_equals_the_jax_mesh(ranks):
    want = _jax_temper(2)
    for r in ranks:
        _same(r["temper-requeue"][1][1], want)


def test_temper_lane_mesh_own_stream_equals_unsharded(ranks):
    got = _every_rank(ranks, "temper-own-4")
    _same(got, _temper_unsharded(replay=False))
    assert got["swap_attempts"] > 0


# ---------------------------------------------------------------------------
# refusals (one process: before any collective)
# ---------------------------------------------------------------------------


class _Mesh:
    """Rank 0's view of a three-rank mesh along ``axis``."""

    def __init__(self, axis):
        self.mesh_dim_names = (axis,)
        self.shape = (3,)

    def get_local_rank(self, name):
        return 0


def test_mesh_refusals():
    from graphdyn_torch.models.hpr import hpr_solve_batch, make_hpr_batch_chunk
    from graphdyn_torch.ops.bdcm import BDCMData
    from graphdyn_torch.pipeline.entropy_group import EntropyCellExec
    from graphdyn_torch.pipeline.sa_group import sa_ensemble_grouped
    from graphdyn_torch.search.tempering import temper_search

    g = tg.random_regular_graph(30, 3, seed=1)
    with pytest.raises(ValueError, match="not divisible by 3"):
        make_hpr_batch_chunk(g, HPRConfig(), 4, mesh=_Mesh("replica"),
                             device="cpu")
    with pytest.raises(ValueError, match="incompatible with mesh="):
        hpr_solve_batch(g, n_replicas=3, mesh=_Mesh("replica"),
                        device_init=True, device="cpu")
    cells, _ = _cells(tg, BDCMData)
    with pytest.raises(ValueError, match="not divisible"):
        EntropyCellExec(cells, EntropyConfig(), group_size=4,
                        mesh=_Mesh("cell"), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        sa_ensemble_grouped(30, 3, n_stat=4, group_size=4,
                            mesh=_Mesh("group"), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        temper_search(g, SAConfig(), n_lanes=4, mesh=_Mesh("lane"),
                      device="cpu")
