"""The port's sanitizers (``graphdyn_torch.utils.validate``), held to the
JAX package's ``checked``/``debug_nans`` (``tests/test_validate.py``): a
checked function passes clean outputs through and raises where the JAX
package's raises, on a NaN and on a division by zero (an Inf), inside the
``debug_nans`` scope that turns the check on; outside it the outputs pass
untouched; the scope restores itself, also on an exception."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphdyn.utils.validate import checked as jchecked
from graphdyn_torch.utils import validate
from graphdyn_torch.utils.validate import checked, debug_nans


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


CASES = {
    "clean": (lambda x: torch.log(x + 1.0).sum(),
              lambda x: jnp.log(x + 1.0).sum(), np.ones(8, np.float32)),
    "nan": (lambda x: torch.log(x).sum(), lambda x: jnp.log(x).sum(),
            np.full(4, -1.0, np.float32)),
    "inf": (lambda x: (1.0 / x).sum(), lambda x: (1.0 / x).sum(),
            np.zeros(4, np.float32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_checked_raises_where_jax_raises(case):
    tfn, jfn, x = CASES[case]
    try:
        want = float(jchecked(jax.jit(jfn))(jnp.asarray(x)))
    except Exception as e:                  # JaxRuntimeError
        want = e
    f = checked(tfn)
    if isinstance(want, Exception):
        assert "nan" in str(want) or "division by zero" in str(want)
        with debug_nans(), pytest.raises(FloatingPointError, match=case):
            f(torch.from_numpy(x))
    else:
        with debug_nans():
            got = f(torch.from_numpy(x))
        assert np.isfinite(float(got))
        assert float(got) == pytest.approx(want, rel=1e-6)


def test_checked_reads_nested_outputs():
    f = checked(lambda: {"a": (torch.ones(2), [np.array([1.0, np.inf])]),
                         "n": 3})
    with debug_nans():
        with pytest.raises(FloatingPointError,
                           match=r"\['a'\]\[1\]\[0\]"):
            f()
        assert checked(lambda: (torch.ones(2, dtype=torch.int32),
                                1.5))()[1] == 1.5


def test_debug_nans_scope_restores_also_on_exception():
    bad = checked(lambda: torch.tensor([float("nan")]))
    assert torch.isnan(bad()).all()         # outside the scope: no check
    with debug_nans():
        assert validate.debugging()
        with pytest.raises(FloatingPointError):
            bad()
    assert not validate.debugging()

    class Boom(RuntimeError):
        pass

    with pytest.raises(Boom):
        with debug_nans():
            raise Boom()
    assert not validate.debugging()
    with debug_nans(False):
        assert not validate.debugging()
