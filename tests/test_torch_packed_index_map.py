"""The packed-step kernel's launch plan (``graphdyn_torch/ops/packed_cuda.py``
``launch_plan``/``index_map``, the index map of ``csrc/packed_step.cu``), on
the CPU: at small n, every (row, word) of the ghost-extended state
``[n+1, W]`` is covered by exactly one thread, no thread reaches past a
row's W words, and the threads walk the rows in node order. The kernel runs
only on a GPU; ``chip_smoke.py`` holds it against the plain stepper bit for
bit there.
"""

import numpy as np
import pytest

from graphdyn_torch.ops import packed_cuda as pc

WIDTHS = (1, 3, 4, 5, 16, 33, 512)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [0, 9, 63, 300])
@pytest.mark.parametrize("W", WIDTHS)
def test_index_map_covers_every_word_once(W, n, aligned):
    plan = pc.launch_plan(W, aligned=aligned)
    hits = np.zeros((n + 1, W), np.int32)
    last = (-1, -1)
    for t, row, w0, nw in pc.index_map(n, W, plan):
        assert nw == plan["U"] and w0 % nw == 0 and w0 + nw <= W
        # node order: thread t + 1 takes the next vector of the row, then
        # the first of the next row
        assert (row, w0) > last
        last = (row, w0)
        hits[row, w0:w0 + nw] += 1
    assert (hits == 1).all(), (n, W, plan)


@pytest.mark.parametrize("W,U,VPR", [
    (1, 1, 1), (3, 1, 3), (4, 4, 1), (5, 1, 5), (16, 4, 4), (33, 1, 33),
    (512, 4, 128),
])
def test_launch_plan_split(W, U, VPR):
    """16-byte vectors exactly where W is a multiple of 4 and the states
    are aligned, one per thread; one word per thread otherwise."""
    assert pc.launch_plan(W) == {"U": U, "VPR": VPR}
    assert pc.launch_plan(W, aligned=False) == {"U": 1, "VPR": W}
