"""KB, the bucketed step kernel: its build, its launch table, its launch
wrapper and its launch counter.

The kernel (``graphdyn_torch/csrc/bucketed_step.cu``) replaces the JAX
package's XLA programs ``graphdyn/ops/bucketed.py:_bucketed_rollout_device``
(one step of every bucket) and ``graphdyn/ops/streamed.py:
_stream_chunk_device`` (one streamed chunk): one launch updates every row of
a table of segments (a bucket, or a chunk) from ``src`` into ``dst``.
Narrow segments (width ≤ 32) take one thread per (row, vector); wide ones
(the hubs) one warp per (row, vector group, chunk of slots), in the lane
split of :func:`wide_geometry`; the chunks of a row longer than one chunk
meet in a count workspace that the launch leaves zeroed.
:func:`launch_table` builds the segment table the kernel reads and
:func:`index_map` / :func:`chunk_slots` enumerate its index map for the CPU
tests.

Build: ``nvcc`` for ``sm_90a`` through :mod:`graphdyn_torch.ops.cuda_build`
at the first CUDA use, never at import. No fallback: a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from graphdyn_torch.ops import cuda_build
from graphdyn_torch.ops.dynamics import Rule, TieBreak

SOURCE = "bucketed_step.cu"
NVCC_FLAGS = cuda_build.BASE_FLAGS
THREADS = 256                    # per block
WARP = 32
WARPS = THREADS // WARP
MAX_SEGMENTS = 32                # widths 2^0 .. 2^31
NARROW_MAX = 32                  # widest segment on the narrow path
SLOTS_PER_LANE = 64              # a wide lane's slots per chunk
COLS = 10                        # int64 columns of a segment descriptor

# kernel launches made through a Launch since the last reset
LAUNCHES = 0

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile the kernel library unless built; return its path."""
    return cuda_build.build(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load(SOURCE, NVCC_FLAGS)
            fn = lib.graphdyn_bucketed_step
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = lib
        return _lib


def words_per_thread(W: int, aligned: bool = True) -> int:
    """``U``: 4 words (a uint4) per thread or lane where W is a multiple of
    4 and the states are 16-byte aligned, else 1."""
    return 4 if W % 4 == 0 and aligned else 1


def wide_geometry(W: int, U: int) -> dict:
    """The wide path's lane split for rows of ``W // U`` vectors of ``U``
    words: ``vlanes`` vector lanes (a power of two, at most 32) times ``32
    // vlanes`` slot lanes per warp, ``G`` vector groups per row, and the
    ``chunk`` of slots one warp folds (each slot lane takes
    :data:`SLOTS_PER_LANE`). The C entry checks the same numbers."""
    vpr = W // U
    vlanes = min(WARP, 1 << max(vpr - 1, 0).bit_length())
    return {"vlanes": vlanes, "G": -(-vpr // vlanes),
            "chunk": (WARP // vlanes) * SLOTS_PER_LANE}


def launch_order(widths) -> list[int]:
    """The order of the segments in the grid: the wide ones first, widest
    first (their chains are the longest), then the narrow ones as given."""
    wide = sorted((w, -k) for k, w in enumerate(widths) if w > NARROW_MAX)
    return ([-k for _, k in reversed(wide)]
            + [k for k, w in enumerate(widths) if w <= NARROW_MAX])


def launch_table(segments, W: int, U: int):
    """The kernel's segment table from ``segments``: ``(rows, width,
    out_row0)`` each, in the order they are to run (:func:`launch_order`).
    Returns ``(table int64[S, 10], total_blocks, ws_rows)``: the columns
    are ``block0, rows, out_row0, width, cpr`` (0 for a narrow segment,
    else the slot chunks per row), ``ws_row0`` (the first count-workspace
    row of a segment whose rows can span several chunks, else -1), three
    pointer slots (``nbr, deg, self``) the wrapper fills and one unused;
    ``ws_rows`` is the workspace's rows. Every segment starts on a block
    boundary."""
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"KB takes 1..{MAX_SEGMENTS} segments, got "
                         f"{len(segments)}")
    if W < 1 or W % U:
        raise ValueError(f"W={W} is not a multiple of U={U}")
    vpr = W // U
    geo = wide_geometry(W, U)
    table = np.zeros((len(segments), COLS), np.int64)
    block = ws_rows = 0
    for s, (rows, width, out_row0) in enumerate(segments):
        if width <= NARROW_MAX:
            cpr, ws_row0 = 0, -1
            blocks = -(-rows * vpr // THREADS)
        else:
            cpr = -(-width // geo["chunk"])
            ws_row0 = ws_rows if cpr > 1 else -1
            ws_rows += rows if cpr > 1 else 0
            blocks = -(-rows * geo["G"] * cpr // WARPS)
        table[s, :6] = (block, rows, out_row0, width, cpr, ws_row0)
        block += max(blocks, 1)
    return table, block, ws_rows


def chunk_slots(W: int, U: int, c: int) -> list[int]:
    """The slots of a row that chunk ``c`` folds, over its slot lanes and
    their :data:`SLOTS_PER_LANE` turns (the kernel's ``j``), for tests."""
    geo = wide_geometry(W, U)
    slanes = WARP // geo["vlanes"]
    return [c * geo["chunk"] + sl + t * slanes
            for sl in range(slanes) for t in range(SLOTS_PER_LANE)]


def index_map(table: np.ndarray, W: int, U: int):
    """Yield ``(segment, out_row, first_word, words, self_row)`` for every
    vector the kernel's grid writes (a thread's ``U`` words of a narrow
    segment; a vector lane's ``U`` words of a wide segment's row, whichever
    of the row's chunks decides it), with ``self_row`` the own row read when
    no self table is given (``out_row0 + r``): the kernel's own arithmetic,
    for tests."""
    vpr = W // U
    geo = wide_geometry(W, U)
    for s, (_, rows, out_row0, _, cpr) in enumerate(table[:, :5]):
        if cpr == 0:
            for local in range(rows * vpr):
                r, v = divmod(local, vpr)
                yield s, int(out_row0 + r), int(v * U), U, int(out_row0 + r)
            continue
        for item in range(rows * geo["G"] * cpr):
            r, rest = divmod(item, geo["G"] * cpr)
            g, c = divmod(rest, cpr)
            if c:
                continue                  # a row's words, counted once
            for vl in range(geo["vlanes"]):
                vec = g * geo["vlanes"] + vl
                if vec < vpr:
                    yield (s, int(out_row0 + r), int(vec * U), U,
                           int(out_row0 + r))


def check_segment(nbr: torch.Tensor, deg: torch.Tensor, self_loc,
                  n_src: int) -> None:
    """Refuse a segment the kernel would read out of bounds with: neighbor
    ids outside ``[0, n_src)`` (the source rows, its ghost row included),
    degrees outside ``[0, width]`` or self rows outside the source. One
    reduction and one host read, once per table, never per step."""
    rows, width = nbr.shape
    if rows == 0:
        return
    vals = [nbr.min(), nbr.max(), deg.min().to(nbr.dtype),
            deg.max().to(nbr.dtype)]
    if self_loc is not None:
        vals += [self_loc.min().to(nbr.dtype), self_loc.max().to(nbr.dtype)]
    b = torch.stack(vals).tolist()
    bad = b[0] < 0 or b[1] >= n_src or b[2] < 0 or b[3] > width
    if self_loc is not None:
        bad = bad or b[4] < 0 or b[5] >= n_src
    if bad:
        raise ValueError(
            f"bucketed tables out of range: nbr in [{b[0]}, {b[1]}] (must be "
            f"within [0, {n_src - 1}]), deg in [{b[2]}, {b[3]}] (within "
            f"[0, {width}])"
            + (f", self rows in [{b[4]}, {b[5]}]" if self_loc is not None
               else ""))


def _check_tensor(name, t, device):
    if t.device.type != "cuda":
        raise ValueError(f"bucketed_step: {name} is on {t.device}, not CUDA")
    want = torch.device(device).index
    if t.device.index != (torch.cuda.current_device() if want is None
                          else want):
        raise ValueError("bucketed_step: tensors on different devices")
    if t.dtype != torch.int32:
        raise TypeError(f"bucketed_step: {name} is {t.dtype}, not torch.int32")
    if not t.is_contiguous():
        raise ValueError(f"bucketed_step: {name} is not contiguous")


def aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


class Launch:
    """A checked KB launch over fixed segments between two states of fixed
    shapes: the table with its pointers, the grid and the count workspace
    (zeroed; each launch leaves it zeroed) are made once; :meth:`__call__`
    launches ``src -> dst`` with no checks (the buffers must be the shapes
    and alignment it was made for, see :meth:`check`).

    ``segments``: ``(nbr int32[rows, width], deg int32[rows], self_loc
    int32[rows] or None, out_row0)``; ``src_rows``/``dst_rows``: the rows
    of the two states; ``ghost_row``: a dst row written zero, or None.
    ``check_tables=False`` skips :func:`check_segment` (a device read) for
    tables the caller has checked on the host."""

    def __init__(self, segments, *, W: int, src_rows: int, dst_rows: int,
                 device, rule, tie, ghost_row=None, aligned: bool = True,
                 check_tables: bool = True):
        self.minority = Rule(rule) == Rule.MINORITY
        self.change = TieBreak(tie) == TieBreak.CHANGE
        self.U = words_per_thread(W, aligned)
        self.W, self.src_rows, self.dst_rows = W, src_rows, dst_rows
        self.ghost_row = -1 if ghost_row is None else int(ghost_row)
        self.geo = wide_geometry(W, self.U)
        metas = []
        for nbr, deg, self_loc, out_row0 in segments:
            _check_tensor("nbr", nbr, device)
            _check_tensor("deg", deg, device)
            if self_loc is not None:
                _check_tensor("self_loc", self_loc, device)
            if nbr.ndim != 2 or tuple(deg.shape) != (nbr.shape[0],) or (
                    self_loc is not None
                    and tuple(self_loc.shape) != (nbr.shape[0],)):
                raise ValueError("bucketed_step: a segment's nbr, deg and "
                                 "self_loc shapes disagree")
            if out_row0 < 0 or out_row0 + nbr.shape[0] > dst_rows:
                raise ValueError("bucketed_step: a segment's rows fall "
                                 "outside the output")
            if check_tables:
                check_segment(nbr, deg, self_loc, src_rows)
            metas.append((nbr.shape[0], nbr.shape[1], out_row0))
        order = launch_order([m[1] for m in metas])
        table, self.blocks, ws_rows = launch_table(
            [metas[k] for k in order], W, self.U)
        for s, k in enumerate(order):
            nbr, deg, self_loc, _ = segments[k]
            table[s, 6:9] = (nbr.data_ptr(), deg.data_ptr(),
                             0 if self_loc is None else self_loc.data_ptr())
        self.table = np.ascontiguousarray(table)
        self.order = order
        self.segments = segments          # the tables outlive the launches
        self.counts = self.tickets = None
        if ws_rows:
            self.counts = torch.zeros(ws_rows * W * WARP, dtype=torch.int32,
                                      device=device)
            self.tickets = torch.zeros(ws_rows * self.geo["G"],
                                       dtype=torch.int32, device=device)

    def rebind(self, segments) -> None:
        """Point the launch at other tables of the same shapes, as
        :class:`Launch` takes them (a streamed chunk's tables are copied to
        the card anew every step); their values are not checked."""
        if len(segments) != len(self.segments):
            raise ValueError("bucketed_step: rebind takes as many segments "
                             "as the launch was made for")
        device = self.segments[0][0].device
        for s, k in enumerate(self.order):
            nbr, deg, self_loc, out_row0 = segments[k]
            old = self.segments[k]
            for name, t, was in (("nbr", nbr, old[0]), ("deg", deg, old[1]),
                                 ("self_loc", self_loc, old[2])):
                if (t is None) != (was is None) or (
                        t is not None and t.shape != was.shape):
                    raise ValueError(f"bucketed_step: rebind's {name} "
                                     "differs from the launch's in shape")
                if t is not None:
                    _check_tensor(name, t, device)
            if out_row0 != old[3]:
                raise ValueError("bucketed_step: rebind moves a segment's "
                                 "output rows")
            self.table[s, 6:9] = (nbr.data_ptr(), deg.data_ptr(),
                                  0 if self_loc is None
                                  else self_loc.data_ptr())
        self.segments = segments

    def check(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """The buffers' device, type, shape, contiguity and alignment."""
        for name, t, rows in (("src", src, self.src_rows),
                              ("dst", dst, self.dst_rows)):
            _check_tensor(name, t, self.segments[0][0].device)
            if tuple(t.shape) != (rows, self.W):
                raise ValueError(f"bucketed_step: {name} must be "
                                 f"[{rows}, {self.W}], got {tuple(t.shape)}")
        if src.data_ptr() == dst.data_ptr():
            raise ValueError("bucketed_step: src and dst must be distinct")
        if self.U == 4 and not aligned16(src, dst):
            raise ValueError("bucketed_step: the plan takes uint4 vectors "
                             "but the states are not 16-byte aligned")

    def __call__(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        global LAUNCHES
        fn = _library().graphdyn_bucketed_step
        geo = self.geo
        with torch.cuda.device(src.device):
            rc = fn(self.table.ctypes.data, self.table.shape[0], self.blocks,
                    src.data_ptr(), dst.data_ptr(), self.W, self.ghost_row,
                    int(self.minority), int(self.change), self.U,
                    geo["vlanes"], geo["G"], geo["chunk"],
                    0 if self.counts is None else self.counts.data_ptr(),
                    0 if self.tickets is None else self.tickets.data_ptr(),
                    torch.cuda.current_stream(src.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"bucketed_step: kernel launch failed, cudaError {rc}")
        LAUNCHES += 1


def bucketed_step(segments, src: torch.Tensor, dst: torch.Tensor, *, rule,
                  tie, ghost_row=None) -> None:
    """One KB launch ``src -> dst`` on the current CUDA stream, checked:
    ``segments`` as :class:`Launch` takes them. Does not synchronise."""
    launch = Launch(segments, W=src.shape[1], src_rows=src.shape[0],
                    dst_rows=dst.shape[0], device=src.device, rule=rule,
                    tie=tie, ghost_row=ghost_row,
                    aligned=aligned16(src, dst))
    launch.check(src, dst)
    launch(src, dst)


class KernelBucketedStep:
    """KB over every bucket of a layout: ping-pongs between the state it is
    given and one spare buffer, allocated on first use; one launch a step
    on the current stream, nothing synchronises. ``tabs``: each bucket's
    ``(nbr, deg, row0)`` on the card; ``check_tables=False`` when the
    caller has checked them on the host. ``launches``: a dict in which the
    :class:`Launch` of each (rule, tie, W, alignment, stream) is kept, so
    that the steppers of one layout share them; each stream gets its own
    count workspace, since the launches on one stream run in order."""

    def __init__(self, tabs, *, n: int, rule, tie, check_tables=True,
                 launches: dict | None = None):
        self.segments = [(nb.contiguous(), dg.contiguous(), None, row0)
                         for nb, dg, row0 in tabs]
        self.n, self.rule, self.tie = n, Rule(rule), TieBreak(tie)
        self.check_tables = check_tables
        self.launches = {} if launches is None else launches
        self.spare = None
        self.launch = None

    def __call__(self, ext):
        if self.spare is None or self.spare.shape != ext.shape:
            self.spare = torch.empty_like(ext)
            aligned = aligned16(ext, self.spare)
            key = (self.rule, self.tie, ext.shape[1], aligned,
                   torch.cuda.current_stream(ext.device).cuda_stream)
            launch = self.launches.get(key)
            if launch is None:
                launch = Launch(
                    self.segments, W=ext.shape[1], src_rows=self.n + 1,
                    dst_rows=self.n + 1, device=ext.device, rule=self.rule,
                    tie=self.tie, ghost_row=self.n, aligned=aligned,
                    check_tables=self.check_tables)
                self.launches[key] = launch
            launch.check(ext, self.spare)
            self.launch = launch
        self.launch(ext, self.spare)
        out, self.spare = self.spare, ext
        return out
