"""Shared helpers of the ``tests/test_torch_serve*.py`` files: one spool of
jobs served by the JAX package's worker and by the port's (on the CPU), and
the comparison of what each left behind.

- Records compare field by field but for ``result`` (each spool's own
  path), which must name the same file in its own spool.
- Journal events compare by op and fields, less the clock and the pid.
- Results: bucketed and streamed jobs bit for bit; fused jobs bit for bit,
  or under the fused slice's near-tie rule (``graphdyn_torch.search.
  reference.hold_to_record``) against the JAX package's chain stepped one
  class step at a time, where a float decision sits within 2 ulp of its
  threshold.
"""

from __future__ import annotations

import os

import numpy as np

#: the admission budget both packages price against in these tests
BUDGET = 1 << 30

SMALL = {"n": 24, "d": 3, "max_sweeps": 16, "chunk_sweeps": 8}


def journal_events(root: str) -> list[dict]:
    """The spool journal's events (schema-valid, checked), less the clock
    and the pid."""
    from graphdyn_torch.resilience.store import JOURNAL_NAME, validate_journal

    events, problems = validate_journal(os.path.join(root, JOURNAL_NAME))
    assert not problems, problems
    return [{k: v for k, v in e.items() if k not in ("t_unix", "pid", "ev")}
            for e in events if e.get("ev") == "journal"]


def same_records(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert os.path.basename(a["result"]) == os.path.basename(b["result"])
        assert {k: v for k, v in a.items() if k != "result"} == \
            {k: v for k, v in b.items() if k != "result"}, (a, b)


def _jax_fused_record(spec: dict):
    """The JAX package's direct run of a fused job (tables seeded by the
    graph, as the service builds them) with its per-class-step digests."""
    import jax.numpy as jnp

    from graphdyn import graphs as jg
    from graphdyn.config import DynamicsConfig as JDyn, SAConfig as JSA
    from graphdyn.ops import pallas_anneal as jpa
    from graphdyn.search import fused as jsf
    from graphdyn_torch import interop
    from graphdyn_torch.search.reference import result_record, state_digest

    g = jg.random_regular_graph(int(spec["n"]), int(spec["d"]),
                                seed=int(spec["graph_seed"]))
    cfg = JSA(dynamics=JDyn(p=1, c=1, rule=spec["rule"], tie=spec["tie"]))
    tables = jpa.build_fused_tables(g, cfg, seed=int(spec["graph_seed"]))
    R, seed = int(spec["replicas"]), int(spec["seed"])
    kw = dict(m_target=float(spec["m_target"]),
              max_sweeps=int(spec["max_sweeps"]),
              chunk_sweeps=int(spec["chunk_sweeps"]))
    res = jsf.fused_anneal(g, cfg, n_replicas=R, seed=seed, kernel="xla",
                           tables=tables, **kw)
    state, tdev, static, _, _, _, _ = jsf._assemble_fused(
        g, cfg, n_replicas=R, seed=seed, m_target=kw["m_target"],
        betas=None, tables=tables)
    initial = state_digest(interop.fused_state_from_jax(state))
    digests = []
    for _ in range(res.device_steps):
        state = jpa.fused_chunk_xla(state, jnp.uint32(seed), *tdev,
                                    chunk_steps=1, stop_on_first=False,
                                    **static)
        digests.append(state_digest(interop.fused_state_from_jax(state)))
    return res, {"result": result_record(res), "initial_digest": initial,
                 "step_digests": digests}


def hold_fused(spec: dict, got: dict, want: dict) -> str:
    """Hold a fused job's port result ``got`` to the JAX package's ``want``
    (the two served npz dicts): ``"bit-exact"``, or ``"near-tie"`` after
    checking that each equals its own package's direct run and that the
    port's chain passes the near-tie rule against the JAX chain."""
    assert set(got) == set(want)
    if all(np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype
           for k in want):
        return "bit-exact"
    import torch

    from graphdyn_torch.graphs import random_regular_graph
    from graphdyn_torch.ops import fused as tf
    from graphdyn_torch.search import fused as tsf
    from graphdyn_torch.search.reference import hold_to_record, result_record
    from graphdyn_torch.serve.bucketing import _sa_config

    jres, ref = _jax_fused_record(spec)
    for k in want:
        np.testing.assert_array_equal(want[k], np.asarray(
            {"conf": jres.s}.get(k, getattr(jres, k, None))), err_msg=k)
    g = random_regular_graph(int(spec["n"]), int(spec["d"]),
                             seed=int(spec["graph_seed"]))
    cfg = _sa_config(spec)
    tables = tf.build_fused_tables(g, cfg, seed=int(spec["graph_seed"]))
    R, seed = int(spec["replicas"]), int(spec["seed"])
    res = tsf.fused_anneal(g, cfg, n_replicas=R, seed=seed,
                           m_target=float(spec["m_target"]),
                           max_sweeps=int(spec["max_sweeps"]),
                           chunk_sweeps=int(spec["chunk_sweeps"]),
                           tables=tables, device="cpu")
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(
            {"conf": res.s}.get(k, getattr(res, k, None))), err_msg=k)
    state0, td, static, _, _, _, _ = tsf._assemble_fused(
        g, cfg, n_replicas=R, seed=seed, m_target=float(spec["m_target"]),
        betas=None, tables=tables, device=torch.device("cpu"))

    def step(st):
        return tf.fused_chunk_plain(st, seed, td, chunk_steps=1, **static)

    verdict = hold_to_record(result_record(res), ref, step, state0, seed, td,
                             **static)
    assert verdict["how"] in ("bit-exact", "near-tie"), verdict
    return verdict["how"]


def hold_results(recs_t: list[dict], recs_j: list[dict]) -> dict:
    """Hold every done job's port result to the JAX package's: fused jobs
    by :func:`hold_fused`, the others bit for bit. Returns job id → how."""
    from graphdyn_torch.utils.io import load_results_npz

    out = {}
    for rt, rj in zip(recs_t, recs_j):
        assert rt["state"] == rj["state"], (rt, rj)
        if rt["state"] != "done":
            continue
        got, want = load_results_npz(rt["result"]), \
            load_results_npz(rj["result"])
        if rt["spec"]["solver"] == "fused":
            out[rt["id"]] = hold_fused(rt["spec"], got, want)
            continue
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        out[rt["id"]] = "bit-exact"
    return out
