"""graftlint — the AST linter for the invariants the port's speed and
correctness rest on (the port of ``graphdyn/analysis/graftlint.py``: the
same disable comments, ``Finding``, ``lint_sources``/``lint_paths``/``main``
and exit code, the number of findings; the JAX codes GD001–GD017 for every
rule that has a counterpart, and the port's own rules after them).

The port has no tracer and no XLA program: its hot paths are PyTorch ops
and hand kernels issued from host loops. What regresses them silently is a
host round-trip in a device loop, an implicit float64 or int64 tensor, a
serial launch loop, a host buffer mutated under an asynchronous copy —
well-typed Python that ruff and mypy cannot see.

Disposition of the JAX rules:

- **GD001–GD003** (host NumPy, a Python branch on a traced value, a host
  sync inside a jit context). The port's counterpart of a jit context is a
  *device body*: a function whose ops are captured into a CUDA graph (the
  functions called inside a ``with torch.cuda.graph(...)`` block,
  ``models/sa.py:363-364``, and the module-local functions they reach).
  In a device body, GD001 flags a ``numpy`` call, GD002 an ``if``/``while``
  that reads a parameter's value (a tensor at capture; parameters
  annotated ``bool``/``int``/``float``/``str`` or with a constant default
  are static, and ``.dtype``/``.shape``/``.ndim``/``.device`` reads and
  ``is None`` tests read no data), GD003 a host sync. The device
  *chunk loops* — a host ``for``/``while`` loop whose body calls a chunk,
  step, sweep or rollout function — get GD003 too: a host sync there is
  ROADMAP A18's "host sync inside a device loop". The host syncs are
  ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``torch.cuda.synchronize()`` and ``float()`` / ``int()`` of a
  non-literal (in a chunk loop: ``float()`` / ``int()`` / ``bool()`` of a
  call, such as ``int(x.sum())``, since the loop's host bookkeeping
  converts numpy elements); the sanctioned read once per chunk carries a
  reasoned disable each.
- **GD004**: in ``ops/`` and ``parallel/``, a ``torch.float64`` /
  ``torch.double`` literal or ``.double()``, and
  ``torch.zeros/ones/empty/full/arange`` with no ``dtype=`` (the float32
  or int64 default is ambient, not the contract's dtype). Host numpy
  float64 (observables, staging) is out of scope: it never reaches the
  card as such, and a dtype test (``dt == torch.float64``) creates
  nothing. The float64 BDCM paths carry reasoned disables.
- **GD005, GD006**: no counterpart. There are no static jit arguments to
  declare (a Python value reaches a PyTorch op or a kernel as it is, with
  no retrace) and no buffer donation (the drivers update their state in
  place or swap two buffers by hand). graftcheck's GC001 checks the
  in-place state contract at run time (the state keeps its ``data_ptr``
  across a chunk).
- **GD007**: the same rule, with ``torch.save`` among the watched writers.
- **GD008**: ``torch.as_tensor`` / ``torch.tensor`` / ``torch.from_numpy``
  followed by ``.to(...)`` or ``.cuda()`` inside a ``for`` loop of a
  driver module (``models/``, ``pipeline/``, ``cli.py``): one host buffer
  shipped per iteration while the card idles.
- **GD009**: ``torch.vmap`` / ``torch.func.vmap`` over a function that
  reaches a hand-kernel launch (a call through a ``*_cuda`` module):
  vmap has no batching rule for a ctypes launch.
- **GD010**: ``torch.from_numpy`` / ``torch.as_tensor`` of a numpy buffer
  that the same function mutates — on the CPU these share memory for the
  tensor's whole life, stronger than JAX's "may alias"; and a host tensor
  copied to the card with ``non_blocking=True`` and then written in the
  same function before an event wait or a synchronize (the copy may still
  be reading it). The runtime half is :mod:`graphdyn_torch.analysis.
  sanitize`.
- **GD011**: bare ``time.time()`` / ``time.perf_counter()`` in a driver
  module (use :func:`graphdyn_torch.obs.timed` / ``obs.span``).
- **GD012**: bare ``torch.profiler.profile`` / ``record_function`` /
  ``torch.cuda.nvtx`` outside ``obs/`` (use
  :func:`graphdyn_torch.obs.trace.profiling`).
- **GD013**: ``all_gather`` / ``all_gather_into_tensor`` /
  ``all_gather_tiled`` in ``parallel/``: the halo modes move boundary slabs
  only; the gather mode (the parity baseline) and the replicated-messages
  sweep keep reasoned disables, as the JAX package's gather mode does.
- **GD014, GD015**: the same scopes (``search/`` drive loops; ``models/``
  anneal drive loops) with the torch syncs of GD003.
- **GD016**: hand byte arithmetic (an itemsize literal times two or more
  shape variables; ``.nbytes`` or ``element_size()`` aggregated) outside
  the port's cost homes: ``obs/memband.py``, ``obs/roofline.py``, the
  ``ops/*_cuda.py`` launch plans, ``parallel/halo.py``,
  ``serve/admission.py`` and ``analysis/graftcost.py``.
- **GD017**: the same rule (a ``full`` ghost-id fill outside
  ``graphs.py``).

The port's own rules:

- **GD018** an unmasked ``>>`` in ``ops/``: packed words are int32 tensors
  carrying uint32 bit patterns, so a right shift is arithmetic and fills
  with the sign bit; every shift must reach an ``&`` mask (through the
  arithmetic around it) to stay logical. A shift of a value known to be
  non-negative carries a reasoned disable.
- **GD019** a kernel library built without ``--fmad=false`` whose source is
  in :data:`graphdyn_torch.ops.cuda_build.FMAD_FALSE_SOURCES` (the kernels
  with a float decision that must equal their plain versions bit for bit):
  a ``cuda_build.build``/``load`` call, or a module's ``SOURCE`` with its
  ``NVCC_FLAGS``, whose flags lack the option.

Escape hatches, all requiring an explicit code list (``all`` allowed):

- same line:      ``# graftlint: disable=GD003  <reason>``
- line before:    ``# graftlint: disable-next-line=GD004  <reason>``
- whole file:     ``# graftlint: disable-file=GD004  <reason>``

The linter is stdlib-only (``ast`` and line scanning). Heuristic by design:
it resolves names syntactically, and the disable comment with a written
reason is the intended pressure valve.
"""

from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from pathlib import Path
from typing import Iterable, NamedTuple

RULES = {
    "GD001": "host-NumPy call inside a device body (a CUDA-graph captured function)",
    "GD002": "Python control flow on a tensor inside a device body",
    "GD003": "host sync (.item()/.cpu()/.tolist()/.numpy()/float()/int()/torch.cuda.synchronize()) inside a device body or a device chunk loop",
    "GD004": "dtype-contract violation (float64 literal / dtype-less creation in ops/ and parallel/)",
    "GD007": "non-atomic persistence (direct np.savez / torch.save / open-for-write outside utils/io.py)",
    "GD008": "per-iteration host->device transfer (torch.as_tensor/tensor/from_numpy(...).to()/.cuda()) in a driver-module for-loop",
    "GD009": "torch.vmap over a hand-kernel-backed callable (serial launch loop, not a batched grid)",
    "GD010": "torch.from_numpy/as_tensor of a buffer this function mutates, or a host tensor written after its non_blocking copy before a wait",
    "GD011": "bare time.time()/time.perf_counter() timing in a driver module (use graphdyn_torch.obs timed/span)",
    "GD012": "bare torch.profiler / torch.cuda.nvtx outside graphdyn_torch/obs/ (use graphdyn_torch.obs.trace profiling/span ranges)",
    "GD013": "full-state all_gather in parallel/ (the halo exchange moves boundary slabs only)",
    "GD014": "host round-trip (np.asarray/.item()/.cpu()/.tolist()/.numpy()/synchronize/int()/float()) inside a search/ drive loop",
    "GD015": "per-temperature-step host sync (.item()/synchronize/bool()/int()/float() of a torch.-rooted call) in a models/ anneal drive loop",
    "GD016": "hand-rolled byte-size arithmetic (itemsize literal x shape variables, .nbytes/element_size() aggregation) outside the sanctioned cost modules",
    "GD017": "ghost-padded node-table construction (a full with a dimension-sized ghost-id fill) outside graphs.py",
    "GD018": "unmasked >> in ops/ (int32 words shift arithmetically: mask with & to keep the shift logical)",
    "GD019": "kernel library built without --fmad=false for a source in cuda_build.FMAD_FALSE_SOURCES",
}

#: methods that read a tensor back to the host (GD003/GD014)
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
#: calls that block the host on the card
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
#: the loops GD003 calls device chunk loops: a loop whose own body calls a
#: function whose base name contains one of these
_DEVICE_LOOP_CALLEE = re.compile(r"chunk|step|sweep|rollout")
#: GD003's scope for device chunk loops
_DEVICE_LOOP_DIRS = ("/ops/", "/models/", "/search/", "/pipeline/",
                     "/parallel/")

_GD014_CALLS = {"np.asarray", "numpy.asarray", "asarray"}
_GD015_DEVICE_ROOTS = ("torch",)

_GD016_ITEMSIZES = {4, 8}
#: the port's cost-model homes (plus the ops/*_cuda.py launch plans)
_GD016_SANCTIONED = ("obs/memband.py", "obs/roofline.py",
                     "parallel/halo.py", "serve/admission.py",
                     "analysis/graftcost.py")

_GD011_CALLS = {"time.time", "time.perf_counter", "perf_counter", "time"}

#: the profiler surface GD012 watches (final attribute under any parent),
#: and the names matched only dotted under ``profiler`` / ``nvtx``
_GD012_NAMES = {"record_function", "range_push", "range_pop"}
_GD012_DOTTED = {"profile": "profiler", "range": "nvtx", "mark": "nvtx"}

#: host->device crossings GD010 watches
_GD010_CALLS = {"torch.from_numpy", "torch.as_tensor", "from_numpy"}
#: in-place numpy/tensor methods that count as mutation for GD010
_GD010_MUTATORS = {"fill", "sort", "put", "partition", "resize", "fill_",
                   "copy_", "zero_", "index_copy_", "index_put_",
                   "scatter_", "add_", "mul_"}
#: calls that order the host after a non_blocking copy (GD010)
_GD010_WAITS = {"synchronize", "wait_event", "wait_stream", "wait", "query"}

_GD008_CTORS = {"torch.as_tensor", "torch.tensor", "torch.from_numpy"}

_NP_DTYPE_CTORS = {
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "bool_", "dtype",
}
#: torch creators whose default dtype is ambient (GD004 scope)
_DTYPE_DEFAULT = {"zeros", "ones", "empty", "full", "arange"}
_GATHERS = {"all_gather", "all_gather_into_tensor", "all_gather_tiled"}

_DISABLE_RE = re.compile(
    r"#\s*graftlint:\s*(disable|disable-next-line|disable-file)=(.*)$"
)
_CODE_TOKEN = re.compile(r"(?i)^(gd\d{3}|all)$")


class Finding(NamedTuple):
    path: str
    line: int
    col: int
    code: str
    message: str


def parse_disable_comments(src: str, disable_re: re.Pattern,
                           code_token: re.Pattern):
    """Generic disable-comment parser shared by the in-package linters
    (graftlint, graftrace — each with its own comment prefix and code
    regex): ``(same_line: {lineno: set}, next_line: {lineno: set},
    file: set)``. Codes are comma-separated and each piece's first
    whitespace token must match ``code_token`` — so a free-text reason
    after a single space never corrupts the list (``disable=GD004 host
    staging`` still disables GD004)."""

    def parse_codes(blob: str) -> set:
        codes = set()
        for piece in blob.split(","):
            tok = piece.split()[0] if piece.split() else ""
            if code_token.match(tok):
                codes.add(tok.upper())
        return codes

    same, nxt, whole = {}, {}, set()
    for i, text in enumerate(src.splitlines(), start=1):
        m = disable_re.search(text)
        if not m:
            continue
        kind = m.group(1)
        codes = parse_codes(m.group(2))
        if kind == "disable":
            same.setdefault(i, set()).update(codes)
        elif kind == "disable-next-line":
            nxt.setdefault(i + 1, set()).update(codes)
        else:
            whole.update(codes)
    return same, nxt, whole


def _parse_disables(src: str):
    """(same_line: {lineno: set}, next_line: {lineno: set}, file: set)."""
    return parse_disable_comments(src, _DISABLE_RE, _CODE_TOKEN)


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for a Name/Attribute chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _base(node: ast.AST) -> str:
    return _dotted(node).rsplit(".", 1)[-1]


def _param_names(fn) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _own_nodes(fn):
    """The function's (or loop's) OWN nodes: nested defs/lambdas are
    separate scopes analysed on their own walk."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


_STATIC_ANN = {"bool", "int", "float", "str"}
_META_ATTRS = {"dtype", "shape", "ndim", "device", "is_cuda"}


def _static_params(fn) -> frozenset:
    """Parameters that hold Python values at capture: annotated
    bool/int/float/str, or with a constant default."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = dict(zip([p.arg for p in pos[len(pos) - len(a.defaults):]],
                        a.defaults))
    defaults.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults)
                     if d is not None})
    out = set()
    for p in pos + a.kwonlyargs:
        ann = _dotted(p.annotation) if p.annotation is not None else ""
        if ann in _STATIC_ANN or isinstance(defaults.get(p.arg),
                                            ast.Constant):
            out.add(p.arg)
    return frozenset(out)


def _value_reads(test: ast.expr) -> set:
    """Names whose VALUE ``test`` reads: not the ones only read for their
    metadata (``x.dtype``, ``x.shape``, ...) or tested for identity
    (``x is None``)."""
    skip: set[int] = set()
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr in _META_ATTRS:
            skip.add(id(n.value))
        elif isinstance(n, ast.Compare) and all(
                isinstance(o, (ast.Is, ast.IsNot)) for o in n.ops):
            for side in [n.left, *n.comparators]:
                skip.add(id(side))
        elif isinstance(n, ast.Call) and _dotted(n.func) == "isinstance":
            for arg in n.args:
                skip.add(id(arg))
    return {n.id for n in ast.walk(test)
            if isinstance(n, ast.Name) and id(n) not in skip}


def _tensor_call(expr: ast.expr) -> bool:
    """A call that returns a tensor as far as syntax tells: a ``torch.``
    call, or a method call on something not rooted in numpy or a builtin
    (``x.sum()``, ``st.active.any()``)."""
    if not isinstance(expr, ast.Call):
        return False
    root = _dotted(expr.func).split(".")[0]
    if root in ("np", "numpy", "math", "len", "max", "min", "sum", "abs",
                "round"):
        return False
    return root == "torch" or isinstance(expr.func, ast.Attribute)


def _host_sync(call: ast.Call, static: frozenset = frozenset()
               ) -> str | None:
    """The name of the host sync ``call`` is, or None: a read-back method,
    ``torch.cuda.synchronize()``, or ``float()``/``int()`` of a
    non-literal."""
    d = _dotted(call.func)
    if d in _SYNC_CALLS or d.endswith(".cuda.synchronize"):
        return d
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _SYNC_METHODS:
        return f".{call.func.attr}()"
    if (isinstance(call.func, ast.Name) and call.func.id in ("float", "int")
            and call.args and not isinstance(call.args[0], ast.Constant)
            and not (isinstance(call.args[0], ast.Name)
                     and call.args[0].id in static)):
        return f"{call.func.id}()"
    return None


def _declared_fmad_sources(sources: list[tuple[str, str]]) -> frozenset:
    """``FMAD_FALSE_SOURCES`` of ``ops/cuda_build.py``: from the linted
    sources when the module is among them, else from the package on disk."""
    src = next((s for p, s in sources
                if p.replace("\\", "/").endswith("ops/cuda_build.py")), None)
    if src is None:
        path = Path(__file__).resolve().parents[1] / "ops" / "cuda_build.py"
        try:
            src = path.read_text()
        except OSError:
            return frozenset()
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return frozenset()
    for stmt in tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            if any(isinstance(t, ast.Name) and t.id == "FMAD_FALSE_SOURCES"
                   for t in targets):
                return frozenset(
                    n.value for n in ast.walk(stmt.value)
                    if isinstance(n, ast.Constant) and isinstance(n.value, str))
    return frozenset()


class _FileLinter:
    def __init__(self, path: str, src: str, fmad_sources: frozenset):
        self.path = path
        self.src = src
        self.fmad_sources = fmad_sources
        self.findings: list[Finding] = []
        norm = path.replace("\\", "/")
        self.norm = norm
        self.dtype_strict = "/ops/" in norm or "/parallel/" in norm
        self.persist_strict = not norm.endswith("utils/io.py")
        self.driver_mod = (
            "/models/" in norm or "/pipeline/" in norm
            or norm.endswith("cli.py")
        )
        self.timing_strict = self.driver_mod or norm.endswith("bench.py")
        self.profiler_strict = "/obs/" not in norm
        self.parallel_mod = "/parallel/" in norm
        self.search_mod = "/search/" in norm
        self.models_mod = "/models/" in norm
        self.ops_mod = "/ops/" in norm
        self.device_loop_mod = any(d in norm for d in _DEVICE_LOOP_DIRS)
        self.byte_model_strict = (
            "graphdyn_torch/" in norm
            and not any(norm.endswith(s) for s in _GD016_SANCTIONED)
            and not re.search(r"ops/[a-z_]+_cuda\.py$", norm)
        )
        self.node_table_strict = (
            "graphdyn_torch/" in norm
            and not norm.endswith("graphdyn_torch/graphs.py")
        )

    def emit(self, node: ast.AST, code: str, message: str) -> None:
        self.findings.append(
            Finding(self.path, node.lineno, node.col_offset, code, message)
        )

    # -- device bodies ----------------------------------------------------

    def _device_bodies(self, tree: ast.Module) -> list:
        """Functions whose ops a CUDA graph captures: the callables called
        inside a ``with torch.cuda.graph(...)`` block, and the module-local
        functions they reach (to a fixpoint)."""
        by_name: dict[str, list] = {}
        calls: dict[str, set] = {}
        roots: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, []).append(node)
                calls.setdefault(node.name, set()).update(
                    _base(c.func) for c in _own_nodes(node)
                    if isinstance(c, ast.Call))
            elif isinstance(node, ast.With) and any(
                    _base(i.context_expr.func) == "graph"
                    and "cuda" in _dotted(i.context_expr.func)
                    for i in node.items
                    if isinstance(i.context_expr, ast.Call)):
                for stmt in node.body:
                    for c in ast.walk(stmt):
                        if isinstance(c, ast.Call):
                            roots.add(_base(c.func))
            elif isinstance(node, ast.Call) \
                    and _base(node.func) == "make_graphed_callables" \
                    and node.args:
                for a in ast.walk(node.args[0]):
                    if isinstance(a, ast.Name):
                        roots.add(a.id)
        scoped = {r for r in roots if r in by_name}
        changed = True
        while changed:
            changed = False
            for name in list(scoped):
                for callee in calls.get(name, ()):
                    if callee in by_name and callee not in scoped:
                        scoped.add(callee)
                        changed = True
        return [fn for name in sorted(scoped) for fn in by_name[name]]

    def run(self) -> list[Finding]:
        try:
            tree = ast.parse(self.src, filename=self.path)
        except SyntaxError as e:
            self.findings.append(
                Finding(self.path, e.lineno or 1, 0, "GD000",
                        f"syntax error: {e.msg}")
            )
            return self.findings

        seen: set[int] = set()
        for fn in self._device_bodies(tree):
            static = _static_params(fn)
            self._check_body(fn, frozenset(_param_names(fn)) - static,
                             static, seen)
        self._check_device_loops(tree, seen)
        self._check_dtypes(tree)
        self._check_persistence(tree)
        self._check_host_loop_transfers(tree)
        self._check_vmap_kernels(tree)
        self._check_alias_crossings(tree)
        self._check_async_copy_writes(tree)
        self._check_bare_timing(tree)
        self._check_bare_profiler(tree)
        self._check_full_gather(tree)
        self._check_search_loop_sync(tree)
        self._check_anneal_loop_sync(tree)
        self._check_byte_model_arith(tree)
        self._check_padded_table_full(tree)
        self._check_unmasked_shift(tree)
        self._check_fmad(tree)
        self.findings.sort(key=lambda f: (f.line, f.col, f.code))
        return self.findings

    # -- GD001/GD002/GD003 --------------------------------------------------

    def _check_body(self, fn, tensors: frozenset, static: frozenset,
                    seen: set):
        for stmt in fn.body:
            self._visit(stmt, tensors, static, seen)

    def _visit(self, node, tensors: frozenset, static: frozenset, seen: set):
        if id(node) in seen:
            return
        seen.add(id(node))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            inner = tensors | (frozenset(_param_names(node)) - static)
            for child in ast.iter_child_nodes(node):
                self._visit(child, inner, static, seen)
            return
        if isinstance(node, ast.Call):
            self._check_call(node, static)
        elif isinstance(node, (ast.If, ast.While)):
            hits = sorted(_value_reads(node.test) & tensors)
            if hits:
                kw = "if" if isinstance(node, ast.If) else "while"
                self.emit(
                    node, "GD002",
                    f"Python `{kw}` on tensor(s) {', '.join(hits)} inside a "
                    f"CUDA-graph captured body: the branch reads the card "
                    f"at capture and the graph replays one side forever "
                    f"(use torch.where, or decide on the host before "
                    f"capture)",
                )
        for child in ast.iter_child_nodes(node):
            self._visit(child, tensors, static, seen)

    def _check_call(self, node: ast.Call, static: frozenset):
        d = _dotted(node.func)
        if d.startswith(("np.", "numpy.")):
            attr = d.split(".", 1)[1]
            if attr.split(".")[0] not in _NP_DTYPE_CTORS:
                self.emit(node, "GD001",
                          f"host-NumPy call {d}(...) inside a CUDA-graph "
                          f"captured body (runs once, at capture; a replay "
                          f"never repeats it)")
            return
        what = _host_sync(node, static)
        if what:
            self.emit(node, "GD003",
                      f"{what} inside a CUDA-graph captured body "
                      f"synchronises with the card (illegal while "
                      f"capturing; a replay never repeats it)")

    def _check_device_loops(self, tree: ast.Module, seen: set):
        """GD003 in device chunk loops: a host ``for``/``while`` whose own
        body calls a chunk/step/sweep/rollout function."""
        if not self.device_loop_mod:
            return
        flagged: set[int] = set()
        for loop in ast.walk(tree):
            if not isinstance(loop, (ast.For, ast.While)) or id(loop) in seen:
                continue
            own = list(_own_nodes(loop))
            if not any(isinstance(c, ast.Call)
                       and _DEVICE_LOOP_CALLEE.search(_base(c.func))
                       for c in own):
                continue
            for c in own:
                if not isinstance(c, ast.Call) or id(c) in flagged \
                        or id(c) in seen:
                    continue
                what = _host_sync(c)
                if what in ("float()", "int()") \
                        and not _tensor_call(c.args[0]):
                    # host bookkeeping after the chunk's read (a numpy
                    # element, a Python number) is not a read of the card
                    what = None
                elif what is None and isinstance(c.func, ast.Name) \
                        and c.func.id == "bool" and c.args \
                        and _tensor_call(c.args[0]):
                    what = "bool()"
                if what:
                    flagged.add(id(c))
                    self.emit(
                        c, "GD003",
                        f"{what} inside a device chunk loop waits for the "
                        f"card every iteration — read once per chunk at "
                        f"most (a reasoned disable marks the sanctioned "
                        f"read), and read results back after the loop",
                    )

    # -- GD004 ----------------------------------------------------------------

    def _check_dtypes(self, tree: ast.Module):
        if not self.dtype_strict:
            return
        guards: set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Compare):
                # a dtype test creates no float64 (``dt == torch.float64``)
                guards.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and id(node) not in guards:
                d = _dotted(node)
                if d in ("torch.float64", "torch.double"):
                    self.emit(
                        node, "GD004",
                        f"{d} literal: the device dtype contract is int8 "
                        f"spins / int32 sums and words / f32 messages",
                    )
            elif isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "double" and not node.args:
                    self.emit(node, "GD004",
                              ".double() widens to float64: the device "
                              "dtype contract is f32 messages")
                    continue
                d = _dotted(node.func)
                if d.startswith("torch.") \
                        and d.rsplit(".", 1)[-1] in _DTYPE_DEFAULT \
                        and d.count(".") == 1 \
                        and not any(kw.arg == "dtype" for kw in node.keywords):
                    self.emit(
                        node, "GD004",
                        f"dtype-less {d}(...) takes torch's ambient dtype "
                        f"(float32, or int64 for integer arange/full) — "
                        f"pass the contract dtype explicitly",
                    )

    # -- GD007 ----------------------------------------------------------------

    def _check_persistence(self, tree: ast.Module):
        if not self.persist_strict:
            return

        def is_temp_token(blob: str) -> bool:
            for tok in re.split(r"[^a-z0-9]+", blob.lower()):
                if tok in ("temp", "temporary", "tempfile") or tok.startswith(
                    ("tmp", "mkstemp", "mkdtemp")
                ):
                    return True
            return False

        def looks_temp(node: ast.expr | None) -> bool:
            if node is None:
                return False
            for n in ast.walk(node):
                blob = ""
                if isinstance(n, ast.Constant) and isinstance(n.value, str):
                    blob = n.value
                elif isinstance(n, ast.Name):
                    blob = n.id
                elif isinstance(n, ast.Attribute):
                    blob = n.attr
                if blob and is_temp_token(blob):
                    return True
            return False

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d in ("np.savez", "numpy.savez", "np.savez_compressed",
                     "numpy.savez_compressed", "np.save", "numpy.save",
                     "torch.save"):
                target = node.args[1] if d == "torch.save" and \
                    len(node.args) > 1 else (node.args[0] if node.args
                                             else None)
                if looks_temp(target):
                    continue
                self.emit(
                    node, "GD007",
                    f"direct {d}(...) to a non-temp path: a preemption "
                    f"mid-write leaves a torn file — use graphdyn_torch."
                    f"utils.io (save_results_npz / Checkpoint: temp + "
                    f"os.replace)",
                )
            elif d == "open":
                mode = None
                if len(node.args) >= 2:
                    mode = node.args[1]
                for kw in node.keywords:
                    if kw.arg == "mode":
                        mode = kw.value
                if (
                    isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)
                    and mode.value.startswith(("w", "a", "x"))
                    and not (node.args and looks_temp(node.args[0]))
                ):
                    self.emit(
                        node, "GD007",
                        "open(..., for write) to a non-temp path: persist "
                        "through graphdyn_torch.utils.io (write_json_atomic "
                        "/ temp file + os.replace) so a preemption cannot "
                        "tear the file",
                    )

    # -- GD008 ----------------------------------------------------------------

    def _check_host_loop_transfers(self, tree: ast.Module):
        if not self.driver_mod:
            return
        flagged: set[int] = set()
        for loop in ast.walk(tree):
            if not isinstance(loop, ast.For):
                continue
            for sub in ast.walk(loop):
                if not isinstance(sub, ast.Call) or id(sub) in flagged:
                    continue
                if not (isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("to", "cuda")
                        and isinstance(sub.func.value, ast.Call)
                        and _dotted(sub.func.value.func) in _GD008_CTORS):
                    continue
                flagged.add(id(sub))
                self.emit(
                    sub, "GD008",
                    f"{_dotted(sub.func.value.func)}(...).{sub.func.attr}() "
                    f"inside a host for-loop ships one buffer per iteration "
                    f"while the card idles — stack the per-iteration tables "
                    f"and copy once, or overlap the builds with "
                    f"pipeline.prefetch.HostPrefetcher",
                )

    # -- GD009 ----------------------------------------------------------------

    def _check_vmap_kernels(self, tree: ast.Module):
        def launches(call: ast.Call) -> bool:
            return any(p.endswith("_cuda") for p in
                       _dotted(call.func).split(".")[:-1])

        fn_calls: dict[str, set] = {}
        backed: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                called = set()
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call):
                        if launches(sub):
                            backed.add(node.name)
                        if _base(sub.func):
                            called.add(_base(sub.func))
                fn_calls.setdefault(node.name, set()).update(called)
        changed = True
        while changed:
            changed = False
            for name, called in fn_calls.items():
                if name not in backed and called & backed:
                    backed.add(name)
                    changed = True

        def arg_backed(arg: ast.expr) -> bool:
            if isinstance(arg, (ast.Name, ast.Attribute)):
                return _base(arg) in backed or any(
                    p.endswith("_cuda") for p in _dotted(arg).split(".")[:-1])
            if isinstance(arg, ast.Call):
                d = _dotted(arg.func)
                if d == "partial" or d.endswith(".partial"):
                    return any(arg_backed(a) for a in arg.args)
            if isinstance(arg, ast.Lambda):
                return any(isinstance(s, ast.Call) and (
                    launches(s) or _base(s.func) in backed)
                    for s in ast.walk(arg))
            return False

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if not (d == "vmap" or d.endswith(".vmap")):
                continue
            if node.args and arg_backed(node.args[0]):
                self.emit(
                    node, "GD009",
                    "torch.vmap over a hand-kernel-backed callable runs a "
                    "serial loop of ctypes launches — make the batch axis "
                    "the kernel's own grid dimension",
                )

    # -- GD010 ----------------------------------------------------------------

    def _check_alias_crossings(self, tree: ast.Module):
        flagged: set[int] = set()
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            mutated: set[str] = set()
            for node in _own_nodes(fn):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name
                    ):
                        mutated.add(t.value.id)
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _GD010_MUTATORS
                    and isinstance(node.func.value, ast.Name)
                ):
                    mutated.add(node.func.value.id)
            if not mutated:
                continue
            for node in _own_nodes(fn):
                if (
                    isinstance(node, ast.Call)
                    and id(node) not in flagged
                    and _dotted(node.func) in _GD010_CALLS
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in mutated
                    and not any(kw.arg == "dtype" for kw in node.keywords)
                ):
                    flagged.add(id(node))
                    name = node.args[0].id
                    self.emit(
                        node, "GD010",
                        f"{_dotted(node.func)}({name}) shares memory with a "
                        f"host buffer this function mutates — on the CPU "
                        f"the tensor IS the buffer for its whole life; copy "
                        f"at the crossing (torch.tensor({name}) / "
                        f".clone()) or drop the tensor before mutating",
                    )

    def _check_async_copy_writes(self, tree: ast.Module):
        """GD010's second half: ``dst.copy_(P, non_blocking=True)`` /
        ``P.to(..., non_blocking=True)`` / ``P.cuda(non_blocking=True)``
        and, later in the same function, a write to ``P`` with no wait on
        the card in between (by line)."""
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            own = list(_own_nodes(fn))
            copies: list[tuple[int, str, ast.AST]] = []
            waits: list[int] = []
            writes: list[tuple[int, str]] = []
            for node in own:
                if isinstance(node, ast.Call):
                    nb = any(kw.arg == "non_blocking" and isinstance(
                        kw.value, ast.Constant) and kw.value.value is True
                        for kw in node.keywords)
                    f = node.func
                    if nb and isinstance(f, ast.Attribute):
                        src = None
                        if f.attr == "copy_" and node.args \
                                and isinstance(node.args[0], ast.Name):
                            src = node.args[0].id
                        elif f.attr in ("to", "cuda") \
                                and isinstance(f.value, ast.Name):
                            src = f.value.id
                        if src:
                            copies.append((node.lineno, src, node))
                    if isinstance(f, ast.Attribute) \
                            and f.attr in _GD010_WAITS:
                        waits.append(node.lineno)
                    if isinstance(f, ast.Attribute) \
                            and f.attr in _GD010_MUTATORS \
                            and isinstance(f.value, ast.Name):
                        writes.append((node.lineno, f.value.id))
                    for kw in node.keywords:
                        if kw.arg == "out" and isinstance(kw.value, ast.Name):
                            writes.append((node.lineno, kw.value.id))
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AugAssign):
                    targets = [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) and isinstance(
                            t.value, ast.Name):
                        writes.append((node.lineno, t.value.id))
            for line, src, node in copies:
                for wline, name in writes:
                    if name != src or wline <= line:
                        continue
                    if any(line < w <= wline for w in waits):
                        continue
                    self.emit(
                        node, "GD010",
                        f"{src!r} is copied to the card with "
                        f"non_blocking=True and written again at line "
                        f"{wline} with no event wait or synchronize in "
                        f"between — the copy may still be reading it "
                        f"(record an event after the copy and wait on it "
                        f"before the write)",
                    )
                    break

    # -- GD011/GD012 -------------------------------------------------------

    def _check_bare_timing(self, tree: ast.Module):
        if not self.timing_strict:
            return
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and _dotted(node.func) in _GD011_CALLS
                and not node.args and not node.keywords
            ):
                self.emit(
                    node, "GD011",
                    f"bare {_dotted(node.func)}() timing in a driver "
                    f"module bypasses the obs event ledger — use "
                    f"graphdyn_torch.obs.timed(name) or obs.span(name); "
                    f"time.monotonic is the allowed bookkeeping clock",
                )

    def _check_bare_profiler(self, tree: ast.Module):
        if not self.profiler_strict:
            return

        def profiler_name(expr: ast.expr) -> str | None:
            d = _dotted(expr)
            parts = d.split(".")
            if parts[-1] in _GD012_NAMES and len(parts) >= 2:
                return d
            parent = _GD012_DOTTED.get(parts[-1])
            if parent and len(parts) >= 2 and parts[-2] == parent:
                return d
            return None

        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if node.module in ("torch.profiler", "torch.cuda.nvtx",
                                   "torch.autograd.profiler"):
                    self.emit(
                        node, "GD012",
                        f"from {node.module} import ... outside "
                        f"graphdyn_torch/obs/ — use graphdyn_torch.obs."
                        f"trace.profiling(dir) (CLI --profile); span-named "
                        f"ranges come from obs.span/obs.timed",
                    )
                continue
            if isinstance(node, ast.Call):
                d = profiler_name(node.func)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                d = next((n for n in map(profiler_name, node.decorator_list)
                          if n is not None), None)
            else:
                continue
            if d is None:
                continue
            self.emit(
                node, "GD012",
                f"bare {d}() outside graphdyn_torch/obs/ — use graphdyn_"
                f"torch.obs.trace.profiling(dir) (CLI --profile); ranges "
                f"named by span path come from obs.span/obs.timed, so the "
                f"device timeline and the event ledger share one "
                f"vocabulary",
            )

    # -- GD013 ----------------------------------------------------------------

    def _check_full_gather(self, tree: ast.Module):
        if not self.parallel_mod:
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _base(node.func) in _GATHERS:
                self.emit(
                    node, "GD013",
                    f"{_dotted(node.func)}(...) in parallel/ moves the FULL "
                    f"state to every rank — a node-sharded step ships only "
                    f"the partition's boundary slabs (graphdyn_torch."
                    f"parallel.halo)",
                )

    # -- GD014/GD015 -----------------------------------------------------

    def _check_search_loop_sync(self, tree: ast.Module):
        if not self.search_mod:
            return
        flagged: set[int] = set()
        for node in ast.walk(tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call) or id(sub) in flagged:
                    continue
                what = _host_sync(sub)
                if what is None and _dotted(sub.func) in _GD014_CALLS:
                    what = _dotted(sub.func)
                if what:
                    flagged.add(id(sub))
                    self.emit(
                        sub, "GD014",
                        f"{what} inside a search drive loop reads the card "
                        f"back every chunk — the ladder/sweep stays one "
                        f"device program per chunk (the sanctioned per-chunk "
                        f"sync is the bool(...any()) stop test); read "
                        f"results back once after the loop",
                    )

    def _check_anneal_loop_sync(self, tree: ast.Module):
        if not self.models_mod:
            return
        flagged: set[int] = set()
        for node in ast.walk(tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call) or id(sub) in flagged:
                    continue
                d = _dotted(sub.func)
                is_method = (isinstance(sub.func, ast.Attribute)
                             and sub.func.attr == "item")
                is_sync = d in _SYNC_CALLS or d.endswith(".cuda.synchronize")
                is_coerce = (
                    isinstance(sub.func, ast.Name)
                    and sub.func.id in ("bool", "int", "float")
                    and sub.args
                    and isinstance(sub.args[0], ast.Call)
                    and _dotted(sub.args[0].func).split(".")[0]
                    in _GD015_DEVICE_ROOTS
                )
                if is_method or is_sync or is_coerce:
                    what = d or (sub.func.attr if isinstance(
                        sub.func, ast.Attribute) else sub.func.id)
                    flagged.add(id(sub))
                    self.emit(
                        sub, "GD015",
                        f"{what}(...) inside a models/ anneal drive loop "
                        f"reads the card back every temperature step — "
                        f"advance the schedule on the card and poll at chunk "
                        f"boundaries only",
                    )

    # -- GD016/GD017 -----------------------------------------------------

    def _check_byte_model_arith(self, tree: ast.Module):
        if not self.byte_model_strict:
            return

        def flatten_mult(node):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
                yield from flatten_mult(node.left)
                yield from flatten_mult(node.right)
            else:
                yield node

        inner: set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
                for side in (node.left, node.right):
                    if isinstance(side, ast.BinOp) \
                            and isinstance(side.op, ast.Mult):
                        inner.add(id(side))
        for node in ast.walk(tree):
            if not isinstance(node, ast.BinOp) \
                    or not isinstance(node.op, ast.Mult) \
                    or id(node) in inner:
                continue
            factors = list(flatten_mult(node))
            sizes = [
                f for f in factors
                if isinstance(f, ast.Constant)
                and isinstance(f.value, int) and f.value in _GD016_ITEMSIZES
            ]
            names = [
                f for f in factors
                if isinstance(f, (ast.Name, ast.Attribute))
            ]
            if sizes and len(names) >= 2:
                self.emit(
                    node, "GD016",
                    f"byte-size arithmetic ({sizes[0].value} * "
                    f"{len(names)} shape variables) outside the sanctioned "
                    "cost modules — hand byte models go stale silently; "
                    "move the formula into obs/memband.py / obs/roofline.py "
                    "/ an ops/*_cuda.py launch plan / parallel/halo.py / "
                    "serve/admission.py, where graftcost holds it to the "
                    "card's allocator peak",
                )

        def is_size(sub) -> bool:
            return (isinstance(sub, ast.Attribute) and sub.attr == "nbytes") \
                or (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "element_size")

        for node in ast.walk(tree):
            is_agg = False
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id == "sum":
                is_agg = True
            elif isinstance(node, ast.BinOp) \
                    and isinstance(node.op, (ast.Add, ast.Mult)):
                for side in (node.left, node.right):
                    if is_size(side):
                        is_agg = True
            if is_agg and any(is_size(sub) for sub in ast.walk(node)):
                self.emit(
                    node, "GD016",
                    ".nbytes / element_size() aggregation builds a hand "
                    "byte model outside the sanctioned cost modules — move "
                    "it into a sanctioned cost module",
                )

    def _check_padded_table_full(self, tree: ast.Module):
        if not self.node_table_strict:
            return
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if _dotted(node.func).rsplit(".", 1)[-1] != "full":
                continue
            if len(node.args) < 2:
                continue
            shape, fill = node.args[0], node.args[1]
            if not isinstance(shape, ast.Tuple) or len(shape.elts) < 2:
                continue
            if isinstance(fill, ast.Constant):
                continue
            fill_dump = ast.dump(fill)
            if any(ast.dump(e) == fill_dump for e in shape.elts):
                self.emit(
                    node, "GD017",
                    "ghost-padded node-table construction (the fill value "
                    "is one of the shape dimensions — the full((n, dmax), "
                    "n) padded-layout idiom) outside graphs.py; node "
                    "layouts come from the graphs.py builders, and "
                    "power-law degree sequences route through "
                    "graphs.degree_buckets",
                )

    # -- the port's rules: GD018, GD019 ------------------------------------

    def _check_unmasked_shift(self, tree: ast.Module):
        if not self.ops_mod:
            return
        parents: dict[int, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node

        def masked(node) -> bool:
            p = parents.get(id(node))
            while isinstance(p, (ast.BinOp, ast.UnaryOp)):
                if isinstance(p, ast.BinOp) and isinstance(p.op, ast.BitAnd):
                    return True
                p = parents.get(id(p))
            if isinstance(p, ast.AugAssign) and isinstance(p.op, ast.BitAnd):
                return True
            return False

        for node in ast.walk(tree):
            shift = (isinstance(node, ast.BinOp)
                     and isinstance(node.op, ast.RShift)) or (
                isinstance(node, ast.AugAssign)
                and isinstance(node.op, ast.RShift)) or (
                isinstance(node, ast.Call)
                and _base(node.func) == "bitwise_right_shift")
            if shift and not masked(node):
                self.emit(
                    node, "GD018",
                    "unmasked >> in ops/: int32 words shift arithmetically "
                    "(the sign bit fills in) — mask the result with & so "
                    "the shift stays logical, or disable with the reason "
                    "the operand is non-negative",
                )

    def _check_fmad(self, tree: ast.Module):
        if not self.fmad_sources:
            return
        consts: dict[str, ast.AST] = {}
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        consts[t.id] = stmt.value

        def text_of(expr) -> set:
            out = set()
            for n in ast.walk(expr):
                if isinstance(n, ast.Constant) and isinstance(n.value, str):
                    out.add(n.value)
                elif isinstance(n, ast.Name) and n.id in consts \
                        and consts[n.id] is not expr:
                    out |= {c.value for c in ast.walk(consts[n.id])
                            if isinstance(c, ast.Constant)
                            and isinstance(c.value, str)}
            return out

        source = consts.get("SOURCE")
        if isinstance(source, ast.Constant) \
                and source.value in self.fmad_sources \
                and "NVCC_FLAGS" in consts \
                and "--fmad=false" not in text_of(consts["NVCC_FLAGS"]):
            self.emit(
                consts["NVCC_FLAGS"], "GD019",
                f"{source.value} is declared in cuda_build."
                f"FMAD_FALSE_SOURCES but its NVCC_FLAGS lack --fmad=false: "
                f"nvcc contracts a*b+c into an FMA and the kernel's float "
                f"decisions part from its plain version",
            )
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and _base(node.func) in ("build", "load")
                    and _dotted(node.func).startswith("cuda_build.")
                    and len(node.args) >= 2):
                continue
            srcs = text_of(node.args[0]) & self.fmad_sources
            if srcs and "--fmad=false" not in text_of(node.args[1]):
                self.emit(
                    node, "GD019",
                    f"{sorted(srcs)[0]} is built without --fmad=false, but "
                    f"cuda_build.FMAD_FALSE_SOURCES declares it needs the "
                    f"flag (its float decisions must equal the plain "
                    f"version bit for bit)",
                )


def lint_sources(sources: list[tuple[str, str]]) -> list[Finding]:
    """Lint (path, source) pairs; disable comments already honored."""
    fmad = _declared_fmad_sources(sources)
    out = []
    for path, src in sources:
        same, nxt, whole = _parse_disables(src)
        for f in _FileLinter(path, src, fmad).run():
            disabled = (
                f.code in whole or "ALL" in whole
                or f.code in same.get(f.line, ())
                or "ALL" in same.get(f.line, ())
                or f.code in nxt.get(f.line, ())
                or "ALL" in nxt.get(f.line, ())
            )
            if not disabled:
                out.append(f)
    return out


def iter_python_files(paths: Iterable[str]):
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        elif path.suffix == ".py":
            yield path


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    sources = []
    unreadable = []
    for f in iter_python_files(paths):
        try:
            sources.append((str(f), f.read_text()))
        except OSError as e:
            # fail CLOSED: a file the gate could not inspect is a finding
            unreadable.append(
                Finding(str(f), 1, 0, "GD000", f"cannot read file: {e}")
            )
    return unreadable + lint_sources(sources)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.analysis",
        description="graftlint: the port's invariant linter "
                    "(exit code = number of findings)",
    )
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    findings = lint_paths(args.paths)
    if args.format == "json":
        # exactly ONE JSON document on stdout; the summary goes to stderr
        print(json.dumps([f._asdict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f"{f.path}:{f.line}:{f.col}: {f.code} {f.message}")
    if findings:
        print(f"graftlint: {len(findings)} finding(s)", file=sys.stderr)
    # exit code = findings, clamped to the 8-bit exit-status range
    return min(len(findings), 125)


if __name__ == "__main__":
    sys.exit(main())
