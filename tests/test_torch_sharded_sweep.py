"""The port's edge-sharded BDCM sweep and fixed point
(``graphdyn_torch.parallel.sharded``) and the entropy meshes
(``entropy_ensemble_union(mesh=)`` on the edge axis, ``entropy_ensemble(
mesh=)`` on the graph axis), on spawned gloo ranks (one spawn of 4 ranks
for the module; P = 2 runs on a 2 × 2 mesh).

- ``make_sharded_sweep`` (f32 on a regular RRG and a ragged ER whose class
  sizes the shard counts do not divide; f64) and ``make_sharded_fixed_point``
  at P ∈ {2, 4}: bit for bit equal to the port's unsharded sweep and fixed
  point (the plain class update's rows do not depend on the slice), and
  within the JAX test's tolerances (f32 rtol 2e-5 / atol 1e-7, f64 rtol
  1e-12 / atol 1e-14) of the JAX package's sharded sweep on its 8-device
  CPU mesh. While recording, the sharded fixed point emits one
  ``parallel.sharded.contract`` and one ``parallel.sharded.gather`` span a
  class and sweep.
- The two entropy meshes against the port's unsharded ladders (bit for
  bit) and the JAX package's mesh ladders (``tests/test_parallel.py:
  148-172``: equal λ, sweeps within one). A whole f32 ladder of up to 300
  sweeps a λ does not stay within the one-sweep tolerance between the two
  packages' class updates (the port's unsharded ladder is 1.2e-4 relative
  off the JAX package's on one of 12 entries), so the ladders' observables
  are held at the port's f32 ladder tolerance, atol 1e-4
  (``tests/test_torch_entropy_group.py``). The divisibility refusal, and
  a mesh union given both checkpoint forms (the mesh ladders' checkpoints
  are held in ``tests/test_torch_mesh_ckpt.py``)."""

import os

import numpy as np
import pytest
import torch

from graphdyn import graphs as jg
from graphdyn.config import EntropyConfig as JEntropyConfig
from graphdyn.ops.bdcm import BDCMData as JBDCMData
from graphdyn.parallel.mesh import device_pool
from graphdyn.parallel.mesh import make_mesh as j_make_mesh
from graphdyn.parallel.sharded import make_sharded_sweep as j_sharded_sweep
from graphdyn_torch.config import EntropyConfig
from graphdyn_torch.models.entropy import (
    entropy_ensemble,
    entropy_ensemble_union,
)
from graphdyn_torch.ops.bdcm import (
    CHUNK_SWEEPS,
    BDCMData,
    make_fixed_point,
    make_sweep,
)

import torch_ranks

TOL = {"float32": dict(rtol=2e-5, atol=1e-7),
       "float64": dict(rtol=1e-12, atol=1e-14)}
SWEEPS = {"rrg": 4, "er": 4, "er64": 1}
DTYPE = {"rrg": "float32", "er": "float32", "er64": "float64"}


def _jgraph(kind):
    if kind == "rrg":
        return jg.random_regular_graph(200, 4, seed=2)
    if kind == "er":
        return jg.erdos_renyi_graph(300, 3.0 / 299, seed=2)
    return jg.erdos_renyi_graph(200, 2.5 / 199, seed=3)


def _cases(root):
    cases = [dict(key="fp-spans-2", what="fp_spans", graph="er", P=2,
                  dtype="float32", sweeps=CHUNK_SWEEPS,
                  ledger=os.path.join(root, "fp-spans"))]
    for P in (2, 4):
        for kind in SWEEPS:
            cases.append(dict(key=f"sweep-{kind}-{P}", what="sweep",
                              graph=kind, P=P, dtype=DTYPE[kind],
                              sweeps=SWEEPS[kind]))
        cases += [
            dict(key=f"fp-{P}", what="fixed_point", graph="er", P=P,
                 dtype="float32", sweeps=40),
            dict(key=f"fp64-{P}", what="fixed_point", graph="er64", P=P,
                 dtype="float64", sweeps=40),
            dict(key=f"union-{P}", what="union", P=P),
            dict(key=f"congruent-{P}", what="congruent", P=P),
        ]
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_sweep"))
    return torch_ranks.run_ranks("bdcm_mesh_worker", 4, root, _cases(root))


def _every_rank(res, key):
    first = res[0][key]
    for r in res[1:]:
        a, b = r[key], first
        if isinstance(a, dict):
            for f in a:
                np.testing.assert_array_equal(np.asarray(a[f]),
                                              np.asarray(b[f]), err_msg=f)
        elif isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
        else:
            np.testing.assert_array_equal(a, b)
    return first


def _with_x64(dtype, fn):
    import jax

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kind", list(SWEEPS))
def test_sharded_sweep_matches_unsharded_and_jax(ranks, kind, P):
    import jax.numpy as jnp

    got = _every_rank(ranks, f"sweep-{kind}-{P}")
    dt = DTYPE[kind]
    data = BDCMData(torch_ranks.bdcm_graphs(kind), p=1, c=1, dtype=dt)
    sw = make_sweep(data, damp=0.2, device="cpu")
    chi = data.init_messages(seed=4)
    lam = torch.tensor(0.7, dtype=data.dtype)
    for _ in range(SWEEPS[kind]):
        chi = sw(chi, lam)
    np.testing.assert_array_equal(got, chi.numpy())

    def jax_side():
        jdata = JBDCMData(_jgraph(kind), p=1, c=1,
                          dtype=jnp.float64 if dt == "float64"
                          else jnp.float32)
        emesh = j_make_mesh((8,), ("edge",), devices=device_pool(8))
        jsw = j_sharded_sweep(jdata, emesh, damp=0.2)
        c = jdata.init_messages(seed=4)
        lm = jnp.float64(0.7) if dt == "float64" else jnp.float32(0.7)
        for _ in range(SWEEPS[kind]):
            c = jsw(c, lm)
        return np.asarray(c)

    np.testing.assert_allclose(got, _with_x64(dt, jax_side), **TOL[dt])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("which", ["fp", "fp64"])
def test_sharded_fixed_point_matches_unsharded(ranks, which, P):
    chi, t, delta = _every_rank(ranks, f"{which}-{P}")
    kind = "er" if which == "fp" else "er64"
    data = BDCMData(torch_ranks.bdcm_graphs(kind), p=1, c=1,
                    dtype=DTYPE[kind])
    cfg = EntropyConfig(max_sweeps=40, eps=1e-7)
    ref, t_ref, d_ref = make_fixed_point(data, cfg, device="cpu")(
        data.init_messages(seed=4), 0.5)
    np.testing.assert_array_equal(chi, ref.numpy())
    assert (t, delta) == (t_ref, d_ref)


def test_sharded_fixed_point_records_a_span_per_class_and_sweep(ranks):
    """While recording, each class's update and its gather run in their
    own spans (one of each per class and sweep, on every rank: a fixed
    point of one chunk of ``CHUNK_SWEEPS`` sweeps), and the recorded run is
    the unrecorded unsharded fixed point's."""
    got = _every_rank(ranks, "fp-spans-2")
    assert got["t"] == CHUNK_SWEEPS
    assert got["contract"] == got["gather"] \
        == CHUNK_SWEEPS * got["classes"] > 0
    data = BDCMData(torch_ranks.bdcm_graphs("er"), p=1, c=1,
                    dtype="float32")
    ref, t_ref, _ = make_fixed_point(
        data, EntropyConfig(max_sweeps=CHUNK_SWEEPS, eps=0.0),
        device="cpu")(data.init_messages(seed=4), 0.5)
    np.testing.assert_array_equal(got["chi"], ref.numpy())
    assert got["t"] == t_ref


def _same_ladder(got, want, exact: bool):
    np.testing.assert_array_equal(got["lambdas"], want["lambdas"])
    if exact:
        for f in ("ent", "m_init", "ent1", "sweeps", "chi"):
            np.testing.assert_array_equal(np.asarray(got[f]),
                                          np.asarray(want[f]), err_msg=f)
        assert got["nonconverged"] == want["nonconverged"]
        return
    assert np.all(np.abs(np.asarray(got["sweeps"])
                         - np.asarray(want["sweeps"])) <= 1)
    for f in ("ent", "m_init", "ent1"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-4,
                                   err_msg=f)


@pytest.mark.parametrize("P", [2, 4])
def test_union_entropy_mesh_matches_unsharded_and_jax(ranks, P):
    from graphdyn.models.entropy import entropy_ensemble_union as j_union

    got = _every_rank(ranks, f"union-{P}")
    cfg = EntropyConfig(lmbd_max=1.0, lmbd_step=0.5, max_sweeps=300)
    base = entropy_ensemble_union(torch_ranks.bdcm_graphs("union"), cfg,
                                  seed=0, device="cpu")._asdict()
    _same_ladder(got, base, exact=True)
    np.testing.assert_array_equal(got["edge_gid"], base["edge_gid"])
    jcfg = JEntropyConfig(lmbd_max=1.0, lmbd_step=0.5, max_sweeps=300)
    emesh = j_make_mesh((8,), ("edge",), devices=device_pool(8))
    jres = j_union([jg.erdos_renyi_graph(60, 1.8 / 59, seed=k)
                    for k in range(4)], jcfg, seed=0, mesh=emesh)
    _same_ladder(got, jres._asdict(), exact=False)


@pytest.mark.parametrize("P", [2, 4])
def test_congruent_entropy_mesh_matches_unsharded_and_jax(ranks, P):
    from graphdyn.models.entropy import entropy_ensemble as j_ensemble

    got = _every_rank(ranks, f"congruent-{P}")
    cfg = EntropyConfig(lmbd_max=1.0, lmbd_step=0.5, max_sweeps=300)
    base = entropy_ensemble(torch_ranks.bdcm_graphs("congruent"), cfg,
                            seed=0, device="cpu")._asdict()
    _same_ladder(got, base, exact=True)
    jcfg = JEntropyConfig(lmbd_max=1.0, lmbd_step=0.5, max_sweeps=300)
    gmesh = j_make_mesh((8,), ("graph",), devices=device_pool(8))
    jres = j_ensemble([jg.random_regular_graph(24, 3, seed=k)
                       for k in range(8)], jcfg, seed=0, mesh=gmesh)
    _same_ladder(got, jres._asdict(), exact=False)


class _Mesh:
    """Rank 0's view of a three-rank mesh (no process group: the
    refusals come before any collective)."""

    def __init__(self, axis):
        self.mesh_dim_names = (axis,)
        self.shape = (3,)

    def get_local_rank(self, name):
        return 0


def test_mesh_refusals(tmp_path):
    cfg = EntropyConfig(lmbd_max=0.5, lmbd_step=0.5, max_sweeps=10)
    graphs = torch_ranks.bdcm_graphs("congruent")
    with pytest.raises(ValueError, match="divisible"):
        entropy_ensemble(graphs, cfg, mesh=_Mesh("graph"), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        entropy_ensemble_union(torch_ranks.bdcm_graphs("union"), cfg,
                               mesh=_Mesh("edge"), device="cpu",
                               checkpoint_path=str(tmp_path / "ck"),
                               checkpointer=object())
