"""Holding a fused chain against a recorded run of the JAX package.

A fused chain is integer arithmetic except for one float decision per
(site, replica), ``u < exp(−ΔE)``. The port computes ``ΔE`` in the
reference's order of operations, but ``exp`` is the platform's: XLA's CPU
``exp``, torch's CPU ``exp`` and CUDA's ``expf`` can differ in the last bit.
A decision can therefore differ only where ``u`` lies within an ulp or two
of ``exp(−ΔE)``. The near-tie rule makes that precise:

1. find the first class step ``t`` whose state digest differs from the
   recorded one (:func:`first_divergence`);
2. replay step ``t`` from the agreeing state at ``t − 1`` with the plain
   version, computing ``u`` and ``exp(−ΔE)`` in float64 for every class
   site and active replica (:func:`near_tie_replay`);
3. the divergence passes only if some decision has ``|u − exp(−ΔE)| ≤ 2``
   f32 ulp and inverting near-tie decisions reproduces the recorded state
   at ``t``; the comparison stops there.

Any other difference is a fault. A state digest is the first 16 hex digits
of the sha256 of the state's fields in the reference's dtypes
(:func:`state_digest`), so a record written from the JAX package's state
and one written from the port's compare directly.
"""

from __future__ import annotations

import hashlib
import itertools

import numpy as np
import torch

from graphdyn_torch.interop import fused_state_to_numpy
from graphdyn_torch.ops.fused import (
    FusedDeviceTables,
    FusedState,
    _class_rows,
    _fused_class_step,
    class_decisions,
)
from graphdyn_torch.ops.lut import lut_one_step

#: the fields of a ``FusedResult``'s record that must equal the reference's
RESULT_KEYS = ("chi", "s_sha256", "m_end", "steps_to_target",
               "sweeps_to_target", "sweeps", "device_steps", "accepted")
NEAR_TIE_ULPS = 2


def state_digest(state: FusedState) -> str:
    """sha256 (16 hex digits) of every field of ``state``: uint32 words,
    int32 sums, f32 drives, int32 first passages, uint8 flags, int32
    counters, in that order."""
    f = fused_state_to_numpy(state)
    h = hashlib.sha256()
    for key in ("sp_ext", "sum_end", "a", "b", "t_target"):
        h.update(np.ascontiguousarray(f[key]).tobytes())
    h.update(f["active"].astype(np.uint8).tobytes())
    h.update(np.array([f["steps"], f["accepted"]], np.int32).tobytes())
    return h.hexdigest()[:16]


def run_record(state: FusedState, class_sizes) -> dict:
    """The comparable record of a final state: χ, the class sizes, the
    sha256 of the final words, and the per-replica vectors and counters
    exactly (f32 values are exact as JSON floats)."""
    f = fused_state_to_numpy(state)
    return {
        "chi": int(len(class_sizes)),
        "class_sizes": [int(x) for x in class_sizes],
        "words_sha256": hashlib.sha256(f["sp_ext"].tobytes()).hexdigest(),
        "sum_end": f["sum_end"].tolist(),
        "a": [float(x) for x in f["a"]],
        "b": [float(x) for x in f["b"]],
        "t_target": f["t_target"].tolist(),
        "accepted": int(f["accepted"]),
        "steps": int(f["steps"]),
    }


def result_record(res) -> dict:
    """The comparable record of a ``FusedResult`` (either package's): the
    sha256 of the final int8 configurations and every per-replica and
    scalar field exactly."""
    return {
        "chi": int(res.chi),
        "s_sha256": hashlib.sha256(
            np.ascontiguousarray(res.s, np.int8).tobytes()).hexdigest(),
        "m_end": [float(x) for x in res.m_end],
        "steps_to_target": [int(x) for x in res.steps_to_target],
        "sweeps_to_target": [float(x) for x in res.sweeps_to_target],
        "sweeps": int(res.sweeps),
        "device_steps": int(res.device_steps),
        "accepted": int(res.accepted),
    }


def first_divergence(step_fn, state0: FusedState, initial_digest: str,
                     step_digests):
    """Advance ``state0`` one class step at a time with ``step_fn(state) ->
    state`` (which must not write its argument) and compare each digest with
    the record. Returns ``None`` when every step agrees, else ``(t,
    state_before)``: the first class step ``t`` (1-based) whose state
    differs and the agreeing state before it. Raises if the initial states
    differ: that is not a near tie."""
    if state_digest(state0) != initial_digest:
        raise AssertionError("initial fused state differs from the record")
    st = state0
    for t, want in enumerate(step_digests, start=1):
        nxt = step_fn(st)
        if state_digest(nxt) != want:
            return t, st
        st = nxt
    return None


def near_tie_replay(state_before: FusedState, seed,
                    tables: FusedDeviceTables, want_digest: str, *, n: int,
                    dmax: int, chi: int, target_sum: int,
                    max_subset: int = 6) -> dict:
    """Replay the class step after ``state_before`` with the plain version
    and test whether the recorded state (``want_digest``) is this step with
    near-tie decisions inverted. Returns ``{"step", "candidates",
    "inverted", "passed"}``; ``candidates`` lists ``(node, replica, u,
    exp(−ΔE))`` of the decisions within :data:`NEAR_TIE_ULPS` f32 ulp."""
    st = state_before
    c = int(st.steps) % chi
    rows = _class_rows(tables, c)
    end = lut_one_step(st.sp_ext, tables.nbr_ext, tables.lut_masks,
                       n=n, dmax=dmax)
    end_all = lut_one_step(st.sp_ext ^ tables.masks_ext[c][:, None],
                           tables.nbr_ext, tables.lut_masks, n=n, dmax=dmax)
    _, u, delta_e, _ = class_decisions(st, seed, tables, rows, end, end_all,
                                       n=n)
    u64 = u.cpu().numpy().astype(np.float64)
    e64 = np.exp(-delta_e.cpu().numpy().astype(np.float64))
    ulp = np.spacing(e64.astype(np.float32)).astype(np.float64)
    near = (np.abs(u64 - e64) <= NEAR_TIE_ULPS * ulp) \
        & st.active.cpu().numpy()[None, :]
    idx = np.argwhere(near)
    rows_h = rows.cpu().numpy()
    cands = [(int(rows_h[i]), int(r), float(u64[i, r]), float(e64[i, r]))
             for i, r in idx]
    out = {"step": int(st.steps) + 1, "candidates": cands, "inverted": [],
           "passed": False}
    if not len(idx):
        return out
    if len(idx) <= max_subset:
        subsets = (s for k in range(1, len(idx) + 1)
                   for s in itertools.combinations(range(len(idx)), k))
    else:
        subsets = iter([tuple(range(len(idx)))])
    for subset in subsets:
        invert = torch.zeros(u.shape, dtype=torch.bool)
        for j in subset:
            invert[tuple(idx[j])] = True
        got = _fused_class_step(st, seed, tables, n=n, dmax=dmax, chi=chi,
                                target_sum=target_sum,
                                invert=invert.to(u.device))
        if state_digest(got) == want_digest:
            out["inverted"] = [cands[j] for j in subset]
            out["passed"] = True
            break
    return out


def hold_to_record(record: dict, ref: dict, step_fn, state0: FusedState,
                   seed, tables: FusedDeviceTables, **static) -> dict:
    """Hold one run's result (:func:`result_record`) to the recorded run
    ``ref`` (its ``"result"``, ``"initial_digest"`` and ``"step_digests"``)
    under the near-tie rule. Returns ``{"how": "bit-exact"}`` when every
    field agrees; otherwise locates the first divergent class step by
    stepping ``state0`` with ``step_fn`` and replays it (``{"how":
    "near-tie", ...}``). Raises on a fault."""
    bad = [k for k in RESULT_KEYS if record[k] != ref["result"][k]]
    if not bad:
        return {"how": "bit-exact"}
    hit = first_divergence(step_fn, state0, ref["initial_digest"],
                           ref["step_digests"])
    if hit is None:
        raise AssertionError(
            f"final record differs in {bad} but every step digest agrees")
    t, before = hit
    replay = near_tie_replay(before, seed, tables, ref["step_digests"][t - 1],
                             **static)
    if not replay["passed"]:
        raise AssertionError(
            f"fused chain diverges from the reference at class step {t} "
            f"(fields {bad}) and no near-tie inversion reproduces it: "
            f"{replay}")
    return {"how": "near-tie", **replay}
