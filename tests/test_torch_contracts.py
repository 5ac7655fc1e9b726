"""The port's ``@contract`` (``graphdyn_torch.analysis.contracts``) against
the JAX package's (``graphdyn.analysis.contracts``): the spec parser gives
the same parse for the same specs, the check accepts and rejects the same
inputs (numpy-built, as jax arrays on one side and torch tensors on the
other; the JAX spec's ``uint32`` packed words are the port's ``int32``),
and the decorated entry points of both packages raise on the same wrong
arguments. The check reads tensor metadata only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphdyn.analysis import contracts as jc
from graphdyn import graphs as jg
from graphdyn.ops import dynamics as jd
from graphdyn.ops import packed as jp
from graphdyn_torch import graphs as tg
from graphdyn_torch.analysis import contracts as tc
from graphdyn_torch.ops import bdcm as tb
from graphdyn_torch.ops import dynamics as td
from graphdyn_torch.ops import packed as tp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


SPECS = ["int8[r,n]", "int32[n,d]", "f32", "float32|float64[e,k,k]",
         "float32|float64[]", "*[_,3]", "*", "u32[n,w]", "i8 | i32 [ a , b ]",
         "bool[n]", "int32[]", "f64[2,_,x]"]
BAD_SPECS = ["int8[r,,n]", "int8[r-1]", "[n]", "int8[n", "9bad[n]"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parser_matches_the_jax_package(spec):
    assert tc._parse_spec(spec) == jc._parse_spec(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_specs_refused_by_both(spec):
    for mod in (tc, jc):
        with pytest.raises(ValueError):
            mod._parse_spec(spec)


# (specs, argument arrays as numpy): each case is checked by both packages
CASES = [
    ({"s": "int8[r,n]", "nbr": "int32[n,d]"},
     {"s": np.zeros((4, 6), np.int8), "nbr": np.zeros((6, 3), np.int32)}),
    ({"s": "int8[r,n]", "nbr": "int32[n,d]"},
     {"s": np.zeros((4, 6), np.int8), "nbr": np.zeros((5, 3), np.int32)}),
    ({"s": "int8[r,n]"}, {"s": np.zeros((4, 6), np.int32)}),
    ({"s": "int8[r,n]"}, {"s": np.zeros((6,), np.int8)}),
    ({"x": "f32[3,_]"}, {"x": np.zeros((3, 9), np.float32)}),
    ({"x": "f32[3,_]"}, {"x": np.zeros((2, 9), np.float32)}),
    ({"x": "float32|float64[]"}, {"x": np.float32(1.5)}),
    ({"x": "float32|float64[]"}, {"x": 0.5}),
    ({"x": "int32[]"}, {"x": 0.5}),
    ({"x": "int8[n]"}, {"x": 3}),
    ({"x": "*[_,2]"}, {"x": np.zeros((5, 2), np.int16)}),
    ({"x": "*[_,2]"}, {"x": np.zeros((5, 3), np.int16)}),
    ({"x": "bool[n]"}, {"x": np.zeros(4, np.int8)}),
    ({"x": "f32"}, {"x": np.zeros((2, 2, 2), np.float32)}),
    ({"a": "f32[n]", "b": "f32[n]"},
     {"a": np.zeros(3, np.float32), "b": np.zeros(4, np.float32)}),
]


def _verdict(mod, specs, args, to_array):
    import inspect

    deco = mod.contract(**specs)

    def body(**kw):
        return None

    params = [inspect.Parameter(k, inspect.Parameter.KEYWORD_ONLY)
              for k in specs]
    body.__signature__ = inspect.Signature(params)
    try:
        deco(body)(**{k: to_array(v) for k, v in args.items()})
        return "ok"
    except mod.ContractError:
        return "ContractError"


def _jax(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray | np.generic) else v


def _torch(v):
    return torch.as_tensor(v) if isinstance(v, np.ndarray | np.generic) \
        else v


@pytest.mark.parametrize("k", range(len(CASES)))
def test_accept_reject_decisions_match_the_jax_package(k):
    specs, args = CASES[k]
    assert _verdict(tc, specs, args, _torch) == \
        _verdict(jc, specs, args, _jax)


def test_bool_spec_accepts_bool_tensors():
    """The one decision that differs: both parsers canonicalise ``bool`` to
    ``bool_`` (numpy's name), which a jax array's dtype name ``bool`` never
    equals, so the JAX check refuses every bool array; the port maps
    torch's ``bool`` to ``bool_`` and accepts a bool tensor."""
    def body(x):
        return None

    mask = np.zeros(4, bool)
    with pytest.raises(jc.ContractError):
        jc.contract(x="bool[n]")(body)(jnp.asarray(mask))
    tc.contract(x="bool[n]")(body)(torch.as_tensor(mask))


def test_tuple_returns_and_symbols_bound_by_the_return():
    @tc.contract(x="f32[n]", ret=("f32[n]", None, "int32[]"))
    def f(x):
        return x, "anything", torch.tensor(3, dtype=torch.int32)

    f(torch.zeros(4))

    @tc.contract(x="f32[n]", ret="f32[n]")
    def g(x):
        return x[:-1]

    with pytest.raises(tc.ContractError, match="symbol 'n'"):
        g(torch.zeros(4))

    @tc.contract(x="f32[n]", ret=("f32[n]", "f32[n]"))
    def h(x):
        return x

    with pytest.raises(tc.ContractError, match="2-tuple"):
        h(torch.zeros(4))
    with pytest.raises(ValueError, match="unknown"):
        tc.contract(y="f32")(lambda x: x)


def test_the_check_reads_metadata_only():
    # a meta tensor has no data at all: any read of its values would raise
    @tc.contract(nbr="int32[n,d]", sp="int32[n,w]", ret="int32[n,w]")
    def f(nbr, sp):
        return sp

    nbr = torch.empty((10, 3), dtype=torch.int32, device="meta")
    sp = torch.empty((10, 2), dtype=torch.int32, device="meta")
    assert f(nbr, sp) is sp


def _rrg():
    return jg.random_regular_graph(30, 3, seed=1), \
        tg.random_regular_graph(30, 3, seed=1)


def _raises(fn):
    try:
        fn()
    except (TypeError, ValueError) as e:
        return type(e).__name__ == "ContractError"
    return False


@pytest.mark.parametrize("case", ["spin_dtype", "node_axis", "rank"])
def test_batched_rollout_raises_where_the_jax_one_raises(case):
    jgr, tgr = _rrg()
    s = np.ones((4, 30), np.int8)
    if case == "spin_dtype":
        s = s.astype(np.int32)
    elif case == "node_axis":
        s = s[:, :29]
    else:
        s = s[0]
    want = _raises(lambda: jd.batched_rollout(jnp.asarray(jgr.nbr),
                                              jnp.asarray(s), 2))
    got = _raises(lambda: td.batched_rollout(
        torch.as_tensor(tgr.nbr, dtype=torch.int32), torch.as_tensor(s), 2))
    assert want and got


@pytest.mark.parametrize("case", ["ok", "spin_dtype"])
def test_run_dynamics_single_raises_where_the_jax_one_raises(case):
    jgr, tgr = _rrg()
    s = np.ones(30, np.int8 if case == "ok" else np.int32)
    want = _raises(lambda: jd.run_dynamics(jgr, s, 2, backend="jax"))
    got = _raises(lambda: td.run_dynamics(tgr, s, 2, device="cpu"))
    assert want == got == (case != "ok")


@pytest.mark.parametrize("case", ["ok", "rows", "deg"])
def test_packed_rollout_raises_where_the_jax_one_raises(case):
    jgr, tgr = _rrg()
    words = np.zeros((30, 2), np.uint32)
    deg = np.asarray(jgr.deg, np.int32)
    if case == "rows":
        words = words[:-1]
    elif case == "deg":
        deg = deg[:-1]
    want = _raises(lambda: jp.packed_rollout(
        jnp.asarray(jgr.nbr), jnp.asarray(deg), jnp.asarray(words), steps=1))
    got = _raises(lambda: tp.packed_rollout(
        torch.as_tensor(tgr.nbr, dtype=torch.int32), torch.as_tensor(deg),
        torch.as_tensor(words.view(np.int32)), 1))
    assert want == got == (case != "ok")


@pytest.mark.parametrize("case", ["ok", "rows"])
def test_packed_consensus_scan_raises_where_the_jax_one_raises(case):
    jgr, tgr = _rrg()
    words = np.zeros((30 if case == "ok" else 29, 1), np.uint32)
    deg = np.asarray(jgr.deg, np.int32)
    want = _raises(lambda: jp.packed_consensus_scan(
        jnp.asarray(jgr.nbr), jnp.asarray(deg), jnp.asarray(words), R=32,
        max_steps=2))
    got = _raises(lambda: tp.packed_consensus_scan(
        torch.as_tensor(tgr.nbr, dtype=torch.int32), torch.as_tensor(deg),
        torch.as_tensor(words.view(np.int32)), R=32, max_steps=2))
    assert want == got == (case != "ok")


@pytest.mark.parametrize("case", ["ok", "int_chi", "rank"])
def test_bdcm_sweep_contract(case):
    data = tb.BDCMData(tg.random_regular_graph(20, 3, seed=0), p=1, c=1)
    sweep = tb.make_sweep(data, damp=0.5, device="cpu")
    chi = data.init_messages(0)
    if case == "int_chi":
        chi = chi.to(torch.int32)
    elif case == "rank":
        chi = chi[0]
    if case == "ok":
        assert sweep(chi, 0.5).shape == chi.shape
    else:
        with pytest.raises(tc.ContractError):
            sweep(chi, 0.5)
