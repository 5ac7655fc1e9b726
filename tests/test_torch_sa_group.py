"""The port's grouped SA ensemble (``graphdyn_torch/pipeline/sa_group.py``):
element for element equal to the serial repetition loop for group sizes 1,
2 and 3 with n_stat=5 (a non-divisor and a padded tail), the JAX package's
graphs and npz keys, and the refusals. The chains themselves are held to
the JAX package in ``tests/test_torch_sa.py``; here the ensemble driver is
held to itself and to the reference's graphs."""

import numpy as np
import pytest
import torch

from graphdyn.config import DynamicsConfig as JDyn, SAConfig as JSA
from graphdyn.models import sa as jsa
from graphdyn_torch.config import DynamicsConfig, SAConfig
from graphdyn_torch.graphs import random_regular_graph
from graphdyn_torch.models import sa as tsa
from graphdyn_torch.pipeline import sa_group

N, D, N_STAT, BUDGET = 24, 3, 5, 2000
CFG = SAConfig(dynamics=DynamicsConfig(p=2, c=1))


@pytest.fixture(scope="module")
def serial():
    return tsa.sa_ensemble(N, D, CFG, n_stat=N_STAT, seed=3,
                           max_steps=BUDGET, group_size=0, device="cpu")


@pytest.mark.parametrize("group_size", [1, 2, 3])
def test_grouped_equals_serial(serial, group_size):
    # chains of different lengths, all reaching consensus inside the budget
    assert len(set(serial.num_steps.tolist())) == N_STAT
    assert np.all(serial.m_final == 1.0)
    got = tsa.sa_ensemble(N, D, CFG, n_stat=N_STAT, seed=3, max_steps=BUDGET,
                          group_size=group_size, prefetch=group_size - 1,
                          device="cpu")
    for name in serial._fields:
        a, b = getattr(got, name), getattr(serial, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_serial_repetition_is_the_single_chain(serial):
    g = random_regular_graph(N, D, seed=3 + 2)
    res = tsa.simulated_annealing(g, CFG, n_replicas=1, seed=3 + 2,
                                  max_steps=BUDGET, device="cpu")
    np.testing.assert_array_equal(serial.conf[2], res.s[0])
    assert serial.num_steps[2] == res.num_steps[0]
    assert serial.m_final[2] == res.m_final[0]
    assert serial.mag_reached[2] == res.mag_reached[0]


def test_graphs_and_npz_keys_are_the_references(serial, tmp_path):
    jcfg = JSA(dynamics=JDyn(p=2, c=1))
    want = jsa.sa_ensemble(N, D, jcfg, n_stat=2, seed=3, max_steps=20,
                           backend="jax", save_path=str(tmp_path / "j"))
    np.testing.assert_array_equal(serial.graphs[:2], want.graphs)
    assert serial._fields == want._fields
    tsa.sa_ensemble(N, D, CFG, n_stat=2, seed=3, max_steps=20,
                    save_path=str(tmp_path / "t"), device="cpu")
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        np.testing.assert_array_equal(j["graphs"], t["graphs"])


def test_run_sa_group_pads_the_tail_with_frozen_rows():
    graphs = [random_regular_graph(N, D, seed=k) for k in (7, 8)]
    preps = [tsa.prepare_sa_inputs(g, CFG, n_replicas=1, seed=k,
                                   max_steps=BUDGET)
             for g, k in zip(graphs, (7, 8))]
    seen = []
    res = sa_group.run_sa_group(graphs, preps, [7, 8], CFG, group_size=4,
                                chunk_steps=64, device="cpu",
                                on_chunk=lambda st: seen.append(st))
    assert res.s.shape == (2, N)
    last = seen[-1]
    assert last.s.shape == (4, N)
    assert not bool(last.active[2:].any())
    assert torch.all(last.t[2:] == 0)             # pad rows never stepped
    for j, (g, k) in enumerate(zip(graphs, (7, 8))):
        one = tsa.simulated_annealing(g, CFG, n_replicas=1, seed=k,
                                      max_steps=BUDGET, device="cpu")
        np.testing.assert_array_equal(res.s[j], one.s[0])
        assert res.num_steps[j] == one.num_steps[0]
    with pytest.raises(ValueError, match="group_size"):
        sa_group.run_sa_group(graphs, preps, [7, 8], CFG, group_size=1,
                              device="cpu")


def test_grouping_refusals():
    with pytest.raises(ValueError, match="group_size"):
        tsa.sa_ensemble(N, D, CFG, n_stat=2, group_size=2,
                        rollout_mode="lightcone", device="cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        sa_group.sa_ensemble_grouped(N, D, CFG, n_stat=2,
                                     checkpoint_path="x", device="cpu")
