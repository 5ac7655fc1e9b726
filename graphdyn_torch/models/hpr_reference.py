"""Holding one HPr chain against another under the near-tie rule.

Two computations of the same chain (the CUDA kernel and the plain version,
or the port and the JAX package) round differently in the last bits, and an
HPr chain amplifies a last-bit difference once it flips a decision: whether
``marg[−] ≥ marg[+]`` and whether ``u < 1 − (1+t)^(−γ)``. The chains should
agree; where they first differ, at sweep t, the rule is:

1. replay sweep t from the agreeing state at t−1 with the plain version in
   float64 (:func:`near_tie_replay`);
2. the divergence passes only if every node whose replayed decision differs
   from the other chain's has a near tie — ``|marg₁ − marg₀| ≤ 4 ulp ·
   max(marg₀, marg₁)`` or ``|u − thr| ≤ 4 ulp`` (ulp of the chain's dtype)
   — and inverting those decisions reproduces the other chain's biases and
   ``s`` at t;
3. the comparison stops at t.

Any other difference is a fault (``AssertionError``).
"""

from __future__ import annotations

import numpy as np
import torch

NEAR_TIE_ULPS = 4


def near_tie_replay(replay_ex, st_prev, u, biases_other, s_other, *,
                    eps_dtype) -> dict:
    """Replay the sweep after ``st_prev`` (a port ``_HPRGroupState`` of the
    chain both runs agreed on) with ``replay_ex`` (a float64 plain
    ``HPRGroupExec`` of the same graphs) and the uniforms ``u`` [G, n] of
    that sweep; hold the result to the other chain's ``biases_other``
    [G, n, 2] and ``s_other`` [G, n] (numpy). ``eps_dtype`` is the chain's
    dtype, whose ulp defines a near tie. Returns the verdict, or raises."""
    f64 = torch.float64
    st64 = st_prev._replace(chi=st_prev.chi.to(f64),
                            biases=st_prev.biases.to(f64))
    u64 = torch.as_tensor(np.asarray(u), dtype=f64, device=st64.chi.device)
    terms = replay_ex.sweep_terms(st64, u64)
    marg = terms["marg"].cpu().numpy()
    uu = u64.cpu().numpy()
    thr = terms["thr"]
    biases_prev = st64.biases.cpu().numpy()
    eps = float(np.finfo(np.dtype(eps_dtype)).eps)
    minus = marg[..., 1] >= marg[..., 0]
    update = uu < thr
    near_m = np.abs(marg[..., 1] - marg[..., 0]) <= \
        NEAR_TIE_ULPS * eps * np.maximum(marg[..., 0], marg[..., 1])
    near_u = np.abs(uu - thr) <= NEAR_TIE_ULPS * eps * max(thr, 1e-300)
    pm_minus = replay_ex.pm_minus.cpu().numpy()
    pm_plus = replay_ex.pm_plus.cpu().numpy()
    other = np.asarray(biases_other, np.float64)

    def apply(minus_, update_):
        new = np.where(minus_[..., None], pm_minus, pm_plus)
        b = np.where(update_[..., None], new, biases_prev)
        return b, np.where(b[..., 0] > b[..., 1], 1, -1).astype(np.int8)

    b_rep, _ = apply(minus, update)
    # the replay's biases are f64; compare in the other chain's dtype
    differ = np.any(b_rep.astype(other.dtype) != other, axis=-1) \
        if other.dtype != np.float64 else np.any(b_rep != other, axis=-1)
    nodes = np.argwhere(differ)
    if not (near_m[differ] | near_u[differ]).all():
        bad = [tuple(int(i) for i in x) for x in nodes[~(near_m | near_u)[differ]]]
        raise AssertionError(f"HPr chains differ at sweep {st_prev.t} at nodes "
                             f"{bad[:8]} with no near tie: a fault")
    # invert the near-tie decisions of the differing nodes
    flip_m = differ & near_m
    flip_u = differ & near_u & ~near_m
    b_inv, s_inv = apply(minus ^ flip_m, update ^ flip_u)
    same_b = (b_inv.astype(other.dtype) == other).all()
    if not (same_b and np.array_equal(s_inv, np.asarray(s_other))):
        raise AssertionError(
            f"HPr chains differ at sweep {st_prev.t}: inverting the near-tie "
            f"decisions at {[tuple(int(i) for i in x) for x in nodes[:8]]} "
            "does not reproduce the other chain")
    return {"how": "near-tie", "sweep": int(st_prev.t),
            "nodes": [tuple(int(i) for i in x) for x in nodes],
            "marg_ties": int(flip_m.sum()), "u_ties": int(flip_u.sum())}


def walk_to_divergence(advance_a, advance_b, fields_a, fields_b, st_a, st_b,
                       t_end: int):
    """Advance two runs of a chain one sweep at a time from agreeing states
    until their ``(biases, s, active)`` differ or the sweep clock reaches
    ``t_end``; ``fields_*(st) -> (t, biases, s, active)`` as numpy. Returns
    ``(st_a_prev, st_a, st_b)`` at the first differing sweep, or None."""
    prev = st_a
    while fields_a(st_a)[0] < t_end:
        fa, fb = fields_a(st_a), fields_b(st_b)
        if not (np.array_equal(fa[1], fb[1]) and np.array_equal(fa[2], fb[2])
                and np.array_equal(fa[3], fb[3])):
            return prev, st_a, st_b
        if not fa[3].any():
            return None
        prev = st_a
        st_a, st_b = advance_a(st_a), advance_b(st_b)
    fa, fb = fields_a(st_a), fields_b(st_b)
    same = all(np.array_equal(x, y) for x, y in zip(fa[1:], fb[1:]))
    return None if same else (prev, st_a, st_b)


def port_fields(st):
    """``(t, biases, s, active)`` of a port ``_HPRGroupState`` as numpy."""
    return (st.t, st.biases.cpu().numpy(), st.s.cpu().numpy(),
            st.active.cpu().numpy())


# ---------------------------------------------------------------------------
# the stream-free record at the reference shape (hpr_ref.json)
# ---------------------------------------------------------------------------

#: the record's graph, init seed and sweeps: RRG(10⁴, 4, seed 0), the
#: default HPRConfig, hpr_solve's numpy init with seed 0, 3 bias-weighted
#: sweeps with the initial biases held fixed (no reinforcement)
REF_GRAPH = {"n": 10_000, "d": 4, "seed": 0}
REF_INIT_SEED = 0
REF_SWEEPS = (1, 3)
REF_IDS_SEED = 2024
REF_N_IDS = 128


def ref_ids(num_directed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The 128 fixed directed-edge ids and node ids the record samples."""
    rng = np.random.default_rng(REF_IDS_SEED)
    return (np.sort(rng.choice(num_directed, REF_N_IDS, replace=False)),
            np.sort(rng.choice(n, REF_N_IDS, replace=False)))


def ref_summary(chi: np.ndarray, marg: np.ndarray, edge_ids, node_ids) -> dict:
    """One sweep's entry of the record: chi at the fixed edges, the
    marginals at the fixed nodes, and Σchi, Σchi², Σmarg[:, 0] in float64."""
    chi64 = np.asarray(chi, np.float64)
    marg64 = np.asarray(marg, np.float64)
    return {"chi": chi64[edge_ids].reshape(len(edge_ids), -1).tolist(),
            "marg": marg64[node_ids].tolist(),
            "sum_chi": float(chi64.sum()),
            "sum_chi2": float((chi64 * chi64).sum()),
            "sum_marg0": float(marg64[:, 0].sum())}


def ref_init(n: int, num_directed: int, K: int, np_dtype):
    """hpr_solve's numpy init with :data:`REF_INIT_SEED`
    (:func:`graphdyn_torch.pipeline.hpr_group.host_init`): ``(chi, biases,
    s0)``."""
    from graphdyn_torch.pipeline.hpr_group import host_init

    return host_init(np.random.default_rng(REF_INIT_SEED), num_directed, K, n,
                     np_dtype)


def port_ref_record(dtype: str, *, kernel: str = "auto", device=None) -> dict:
    """The port's run of the record (one dtype): the reference graph and
    init, 3 bias-weighted sweeps through ``make_sweep`` (HPr variant) on
    ``device`` with ``kernel``, summarised after sweeps 1 and 3."""
    from graphdyn_torch.config import HPRConfig
    from graphdyn_torch.graphs import build_edge_tables, random_regular_graph
    from graphdyn_torch.models.hpr import _prep

    g = random_regular_graph(REF_GRAPH["n"], REF_GRAPH["d"],
                             seed=REF_GRAPH["seed"])
    setup = _prep(g, HPRConfig(dtype=dtype), tables=build_edge_tables(g),
                  kernel=kernel, device=device)
    data, dev = setup.data, setup.device
    chi, biases, _ = ref_init(g.n, data.num_directed, data.K, data.np_dtype)
    edge_ids, node_ids = ref_ids(data.num_directed, g.n)
    chi = torch.from_numpy(chi).to(dev)
    bias_edge = setup.bias_to_edge(torch.from_numpy(biases).to(dev))
    out = {}
    for k in range(1, max(REF_SWEEPS) + 1):
        chi = setup.sweep(chi, setup.lmbd, bias_edge)
        if k in REF_SWEEPS:
            out[str(k)] = ref_summary(chi.cpu().numpy(),
                                      setup.marginals(chi).cpu().numpy(),
                                      edge_ids, node_ids)
    return out


def hold_to_ref_record(got: dict, want: dict, rtol: float, atol: float) -> float:
    """Hold a record entry (one dtype) to another at ``rtol``/``atol``;
    returns the max relative error over every number, or raises."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        for key in ("chi", "marg", "sum_chi", "sum_chi2", "sum_marg0"):
            a, b = np.asarray(g[key], np.float64), np.asarray(w[key], np.float64)
            if not np.allclose(a, b, rtol=rtol, atol=atol):
                raise AssertionError(
                    f"record sweep {k} {key}: max |diff| "
                    f"{float(np.abs(a - b).max())} outside rtol {rtol}")
            worst = max(worst, float((np.abs(a - b) / np.maximum(
                np.abs(b), 1e-300)).max()))
    return worst
