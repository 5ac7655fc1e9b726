"""Checkpoints of the port's mesh ladders (``entropy_ensemble_union(mesh=)``
on the edge axis, ``entropy_ensemble(mesh=)`` on the graph axis), on two
spawned gloo ranks (one spawn for the module).

Each ladder runs at P = 2 with ``checkpoint_path``, is preempted after its
first λ (the ``lambda.boundary`` fault site, every rank), and resumes from
rank 0's global snapshot at P = 2 (the same spawn) and at P = 1 (this
process, from a copy of the snapshot). Both resumed ladders equal the
port's uninterrupted unsharded ladder bit for bit, and the JAX package's
uninterrupted single-process mesh ladder (its 8-device CPU mesh) within
the f32 rtol 2e-5 that the mesh BDCM floats are held to
(``tests/test_torch_sharded_sweep.py``) plus an absolute 1e-6, with the
same λ and sweeps within one: the port's uninterrupted f32 union ladder is
itself 3.8e-7 (1.2e-4 relative) off the JAX package's on one of its 12
entries, the whole-ladder drift that ``test_torch_sharded_sweep.py`` holds
at atol 1e-4. A shutdown request that reaches rank 1 alone stops both ranks at the
same λ with a snapshot, and the resumed ladder equals the uninterrupted one.
"""

import glob
import os

import numpy as np
import pytest
import torch

from graphdyn import graphs as jg
from graphdyn.config import EntropyConfig as JEntropyConfig
from graphdyn.parallel.mesh import device_pool
from graphdyn.parallel.mesh import make_mesh as j_make_mesh

import torch_ranks

LADDER_FIELDS = ("lambdas", "ent", "m_init", "ent1", "sweeps", "nonconverged")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs small tensors here: one intra-op thread per test
    process avoids oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_ckpt"))
    return root, torch_ranks.run_ranks("mesh_ckpt_worker", 2, root, root)


@pytest.fixture(scope="module")
def jax_ladders():
    """The JAX package's uninterrupted single-process mesh ladders."""
    from graphdyn.models.entropy import entropy_ensemble as j_ensemble
    from graphdyn.models.entropy import entropy_ensemble_union as j_union

    cfg = JEntropyConfig(**torch_ranks.MESH_CKPT_CFG)
    union = j_union([jg.erdos_renyi_graph(60, 1.8 / 59, seed=k)
                     for k in range(4)], cfg, seed=0,
                    mesh=j_make_mesh((8,), ("edge",),
                                     devices=device_pool(8)))
    congruent = j_ensemble([jg.random_regular_graph(24, 3, seed=k)
                            for k in range(8)], cfg, seed=0,
                           mesh=j_make_mesh((8,), ("graph",),
                                            devices=device_pool(8)))
    return {"union": union._asdict(), "congruent": congruent._asdict()}


def _same(got, want):
    for f in LADDER_FIELDS + ("chi",):
        np.testing.assert_array_equal(np.asarray(got[f]),
                                      np.asarray(want[f]), err_msg=f)


def _near_jax(got, want):
    np.testing.assert_allclose(got["lambdas"], want["lambdas"])
    assert np.all(np.abs(np.asarray(got["sweeps"])
                         - np.asarray(want["sweeps"])) <= 1)
    for f in ("ent", "m_init", "ent1"):
        np.testing.assert_allclose(got[f], want[f], rtol=2e-5, atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("what", ["union", "congruent"])
def test_mesh_ladder_resumes_at_p2_and_p1(ranks, jax_ladders, what):
    root, res = ranks
    base = torch_ranks.mesh_ladder(what)
    for r in res:
        leg = r[what]
        assert leg["cut"] is not None and "lambda.boundary" in leg["cut"]
        assert leg["left"] == []          # removed on completion
        _same(leg["resumed"], base)
    assert np.asarray(base["lambdas"]).size > torch_ranks.MESH_CKPT_AT
    ck = os.path.join(root, f"{what}-ck-p1")
    assert glob.glob(ck + ".*npz")
    one = torch_ranks.mesh_ladder(what, checkpoint_path=ck,
                                  checkpoint_interval_s=0.0)
    _same(one, base)
    assert not glob.glob(ck + ".*npz")
    _near_jax(one, jax_ladders[what])
    _near_jax(res[0][what]["resumed"], jax_ladders[what])


@pytest.mark.parametrize("what", ["union", "congruent"])
def test_shutdown_on_one_rank_stops_every_rank(ranks, what):
    _, res = ranks
    base = torch_ranks.mesh_ladder(what)
    assert [r[what]["stopped"] for r in res] == ["lambda", "lambda"]
    for r in res:
        _same(r[what]["sig_resumed"], base)
