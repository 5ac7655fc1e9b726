"""graftrace — the host-concurrency auditor with a committed shared-state
ledger (the port of ``graphdyn/analysis/racecheck.py``: the same GT001–GT005
rules, ``# graftrace:`` disables, ledger format, ``--update-ledger``
workflow, CLI and exit code; the runtime ``TracedLock`` proxy, the
observed-order assertion and the ``GRAPHDYN_RACEFUZZ`` seeded jitter).

The port's host side is concurrent in the JAX package's places — the
prefetch worker (:class:`graphdyn_torch.pipeline.prefetch.HostPrefetcher`),
the write-behind mirror worker (:mod:`graphdyn_torch.resilience.store`),
the watchdog (:mod:`graphdyn_torch.resilience.supervisor`), the flight ring
(:mod:`graphdyn_torch.obs.flight`) — and in its own: the locks that guard
each kernel library's ``nvcc`` build and load (``ops/cuda_build.py`` and
the ``_lib_lock`` of every ``ops/*_cuda.py`` and ``ops/bdcm_sweep.py``),
the device-layout cache lock (``ops/bucketed.py``), and the job service's
worker thread, spool lock and bucket-cache lock (``serve/``). The committed
ledger is ``graphdyn_torch/analysis/concurrency_ledger.json``.

**Static half** — an AST pass over ``graphdyn_torch/`` that inventories the
thread-spawn sites (targets, daemon flags), the sync objects at module and
instance scope, the module-global mutables threads share, and the
acquired-while-holding lock-order graph, and enforces:

- **GT001** — a module-global mutable written from a thread-target
  function without lexically holding an inventoried lock
  (``queue.Queue`` / ``threading.local`` are exempt).
- **GT002** — a cycle in the static lock-order graph, or a live edge that
  inverts a ledgered pair.
- **GT003** — ``Thread.start()`` with no bounded ``.join(timeout)`` on the
  same thread object in the module.
- **GT004** — a thread, sync object, shared global or lock-order edge
  absent from the committed ledger (or a stale row).
- **GT005** — ``time.sleep`` in non-test code (every legitimate sleep
  carries a reasoned disable).

Edges a static walk cannot see — the order graph stays inside a module, as
the JAX auditor's does, and a call through an object (the ``kernel.build``
counter reaching the flight ring's lock through the installed recorder) is
opaque to it — are declared in the ledger's ``runtime_order`` section from
the runtime half's observations (:func:`undeclared_observed` lists the
candidates after a run). ``--update-ledger`` keeps that section, and the
static diff does not read it.

Escape hatches mirror graftlint (explicit code list, reason expected)::

    # graftrace: disable=GT005  <reason>
    # graftrace: disable-next-line=GT003  <reason>
    # graftrace: disable-file=GT001  <reason>

**Runtime half** — opt-in via ``GRAPHDYN_RACECHECK=1`` (``cli.main``
installs it before any driver thread spawns): every inventoried
module-scope ``Lock``/``RLock`` is wrapped in a :class:`TracedLock` that
emits one ``racecheck.acquire`` counter per acquire (lock, thread, held
stack; the null recorder forwards it into the flight ring), raises
:class:`LockOrderError` when an acquire inverts a ledgered pair
(``lock_order`` and ``runtime_order``), and with
``GRAPHDYN_RACEFUZZ=<seed>`` sleeps a delay that is a pure function of
``(seed, lock, thread name, op)`` at each acquire and release (capped by
``GRAPHDYN_RACEFUZZ_MAX_MS``; :func:`_fuzz_delay_s` gives the JAX
package's delay for the same inputs). The soak scenarios
``race_mirror_exit`` and ``race_prefetch_close``
(:mod:`graphdyn_torch.resilience.soak`) drive it. A lock held across a
kernel build (20–50 s of ``nvcc``) is only traced, never timed: the proxy
sets no deadline, and a run that builds its libraries before installing
(as ``chip_smoke.py`` does) never holds one that long under it. Off (the
default), the locks stay the plain ``threading`` objects and the cost is
one environment check.

CLI (exit code = number of findings)::

    python -m graphdyn_torch.analysis.racecheck [--format=text|json]
        [--update-ledger] [--ledger PATH] [paths...]
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import importlib
import json
import os
import re
import sys
import threading
import time
from pathlib import Path
from typing import Iterable, NamedTuple

RULES = {
    "GT001": "module-global mutable written from a thread target without an inventoried lock held",
    "GT002": "lock-order hazard: static acquisition cycle, or an edge inverting a ledgered pair",
    "GT003": "Thread.start() without a bounded join/close path in the module",
    "GT004": "undeclared concurrency growth: thread/sync/global/lock-order site absent from the ledger (or stale ledger row)",
    "GT005": "time.sleep-based synchronization in non-test code (sleep is never a happens-before edge)",
}

LEDGER_NAME = "concurrency_ledger.json"

ENV_VAR = "GRAPHDYN_RACECHECK"
FUZZ_ENV = "GRAPHDYN_RACEFUZZ"
FUZZ_MAX_ENV = "GRAPHDYN_RACEFUZZ_MAX_MS"
#: default jitter cap (milliseconds) when the fuzzer is armed
FUZZ_MAX_MS_DEFAULT = 20.0

#: threading constructors that create sync objects, -> inventory kind
_SYNC_CTORS = {
    "Lock": "lock", "RLock": "rlock", "Condition": "condition",
    "Semaphore": "semaphore", "BoundedSemaphore": "semaphore",
    "Event": "event", "Barrier": "barrier",
}
#: kinds that participate in lock ordering / can guard a GT001 write
_GUARD_KINDS = frozenset({"lock", "rlock", "condition", "semaphore"})

#: module-level constructors/literals that create shared mutable state,
#: -> inventory kind. "queue" and "threadlocal" are internally
#: synchronized / per-thread by construction: inventoried (the ledger is
#: the full sharing surface) but exempt from GT001.
_MUTABLE_CTORS = {
    "dict": "dict", "list": "list", "set": "set",
    "OrderedDict": "dict", "defaultdict": "dict", "Counter": "dict",
    "deque": "deque",
    "Queue": "queue", "LifoQueue": "queue", "PriorityQueue": "queue",
    "SimpleQueue": "queue",
    "local": "threadlocal",
}
_GT001_EXEMPT_KINDS = frozenset({"queue", "threadlocal"})

#: in-place mutator method names that count as a write for GT001
_MUTATORS = frozenset({
    "append", "appendleft", "add", "update", "clear", "pop", "popleft",
    "remove", "discard", "extend", "extendleft", "insert", "setdefault",
    "sort", "reverse", "rotate",
})

_DISABLE_RE = re.compile(
    r"#\s*graftrace:\s*(disable|disable-next-line|disable-file)=(.*)$"
)
_CODE_TOKEN = re.compile(r"(?i)^(gt\d{3}|all)$")


class Finding(NamedTuple):
    path: str
    line: int
    col: int
    code: str
    message: str


def default_ledger_path() -> Path:
    """The committed ledger, beside this module."""
    return Path(__file__).resolve().parent / LEDGER_NAME


def default_paths() -> list[str]:
    """The port's package — the audit scope the committed ledger covers."""
    return [str(Path(__file__).resolve().parents[1])]


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def _relkey(path: str) -> str:
    """Stable, cwd-independent file key: posix path relative to the repo
    root when under it, else the path as given."""
    p = Path(path).resolve()
    try:
        return p.relative_to(_repo_root()).as_posix()
    except ValueError:
        return Path(path).as_posix()


# ---------------------------------------------------------------------------
# disable comments (graftlint's hatch machinery, graftrace-prefixed) and
# shared AST helpers — one implementation for all in-package linters
# ---------------------------------------------------------------------------

from graphdyn_torch.analysis.graftlint import (  # noqa: E402
    _dotted,
    iter_python_files,
    parse_disable_comments,
)


def _parse_disables(src: str):
    return parse_disable_comments(src, _DISABLE_RE, _CODE_TOKEN)


def _base(node: ast.AST) -> str:
    """The final attribute / bare name of a dotted chain ('' if neither)."""
    d = _dotted(node)
    return d.rsplit(".", 1)[-1] if d else ""


# ---------------------------------------------------------------------------
# inventory model
# ---------------------------------------------------------------------------


class ThreadSite(NamedTuple):
    path: str           # repo-relative file key
    line: int
    col: int
    key: str            # stable ledger key (name const, else target)
    target: str         # target base name ('' when unresolvable)
    name: str | None    # name= kwarg when a constant
    daemon: bool | None  # daemon= kwarg when a constant
    assigned: str | None  # base name/attr the Thread object is bound to


class SyncSite(NamedTuple):
    path: str
    line: int
    col: int
    name: str           # module global name, or "Class.attr" / "<fn>.attr"
    kind: str           # lock | rlock | condition | event | ...
    scope: str          # "module" | "instance"


class GlobalSite(NamedTuple):
    path: str
    line: int
    col: int
    name: str
    kind: str           # dict | list | set | deque | queue | threadlocal | rebound


class LockEdge(NamedTuple):
    outer: str          # qualified "path::name"
    inner: str
    path: str
    line: int
    col: int


class Inventory(NamedTuple):
    threads: list[ThreadSite]
    sync: list[SyncSite]
    globals_: list[GlobalSite]
    edges: list[LockEdge]


def _is_thread_ctor(call: ast.Call) -> bool:
    d = _dotted(call.func)
    return d == "Thread" or d.endswith(".Thread")


def _const_kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant):
            return kw.value.value
    return None


def _target_base(call: ast.Call) -> str:
    for kw in call.keywords:
        if kw.arg == "target":
            return _base(kw.value)
    return ""


class _FileAudit:
    """Per-file inventory extraction + the single-file GT checks."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.key = _relkey(path)
        self.src = src
        self.findings: list[Finding] = []
        self.threads: list[ThreadSite] = []
        self.sync: list[SyncSite] = []
        self.globals_: list[GlobalSite] = []
        self.edges: list[LockEdge] = []
        self.tree: ast.Module | None = None
        # module-level sync names that can guard writes (Name -> kind)
        self.module_guards: dict[str, str] = {}
        self.module_globals: dict[str, str] = {}       # name -> kind
        self.fn_nodes: dict[str, list] = {}            # base name -> defs
        self.fn_calls: dict[int, set] = {}             # id(fn) -> callee bases
        self.fn_acquires: dict[int, set] = {}          # id(fn) -> lock names
        self.has_sleep_import = False

    def emit(self, node: ast.AST, code: str, message: str) -> None:
        self.findings.append(Finding(
            self.key, getattr(node, "lineno", 1),
            getattr(node, "col_offset", 0), code, message))

    # -- collection -----------------------------------------------------

    def collect(self) -> None:
        try:
            self.tree = ast.parse(self.src, filename=self.path)
        except SyntaxError as e:
            self.findings.append(Finding(
                self.key, e.lineno or 1, 0, "GT000",
                f"syntax error: {e.msg}"))
            return
        # one walk, reused by every pass over the whole module
        self.nodes = list(ast.walk(self.tree))
        self._collect_imports()
        self._collect_module_state()
        self._collect_functions()
        self._filter_unwritten_globals()
        self._collect_threads_and_instance_sync()

    def _collect_imports(self) -> None:
        for node in self.nodes:
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                if any(a.name == "sleep" for a in node.names):
                    self.has_sleep_import = True

    def _ctor_kind(self, value: ast.expr) -> tuple[str, str] | None:
        """('sync'|'mutable', kind) when ``value`` constructs shared
        state, else None."""
        if isinstance(value, ast.Call):
            b = _base(value.func)
            if b in _SYNC_CTORS and (
                "threading" in _dotted(value.func) or _dotted(value.func) == b
            ):
                return ("sync", _SYNC_CTORS[b])
            if b in _MUTABLE_CTORS:
                return ("mutable", _MUTABLE_CTORS[b])
            return None
        if isinstance(value, (ast.Dict, ast.DictComp)):
            return ("mutable", "dict")
        if isinstance(value, (ast.List, ast.ListComp)):
            return ("mutable", "list")
        if isinstance(value, (ast.Set, ast.SetComp)):
            return ("mutable", "set")
        return None

    def _collect_module_state(self) -> None:
        """Module-level sync objects and mutable globals; plus every name a
        function rebinds through a ``global`` declaration (a shared scalar
        slot is shared state even when its initializer is immutable)."""
        assert self.tree is not None
        for stmt in self.tree.body:
            targets: list[ast.expr] = []
            value: ast.expr | None = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            if value is None:
                continue
            ck = self._ctor_kind(value)
            if ck is None:
                continue
            what, kind = ck
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if what == "sync":
                    self.sync.append(SyncSite(
                        self.key, stmt.lineno, stmt.col_offset,
                        t.id, kind, "module"))
                    if kind in _GUARD_KINDS:
                        self.module_guards[t.id] = kind
                else:
                    self.globals_.append(GlobalSite(
                        self.key, stmt.lineno, stmt.col_offset, t.id, kind))
                    self.module_globals[t.id] = kind
        # names rebound via `global` in any function
        module_names = {
            t.id for stmt in self.tree.body
            for t in (stmt.targets if isinstance(stmt, ast.Assign)
                      else [stmt.target] if isinstance(stmt, ast.AnnAssign)
                      else [])
            if isinstance(t, ast.Name)
        }
        seen = set(self.module_globals) | {s.name for s in self.sync}
        for node in self.nodes:
            if isinstance(node, ast.Global):
                for name in node.names:
                    if name in module_names and name not in seen:
                        seen.add(name)
                        self.globals_.append(GlobalSite(
                            self.key, node.lineno, node.col_offset,
                            name, "rebound"))
                        self.module_globals[name] = "rebound"

    def _collect_functions(self) -> None:
        for node in self.nodes:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            self.fn_nodes.setdefault(node.name, []).append(node)
            called, acquires = set(), set()
            for sub in self._own_nodes(node):
                if isinstance(sub, ast.Call):
                    b = _base(sub.func)
                    if b:
                        called.add(b)
                elif isinstance(sub, ast.With):
                    for item in sub.items:
                        b = _base(item.context_expr)
                        if b in self.module_guards:
                            acquires.add(b)
            self.fn_calls[id(node)] = called
            self.fn_acquires[id(node)] = acquires

    def _filter_unwritten_globals(self) -> None:
        """Drop module-level containers no function ever writes: a
        read-only constant table (a rule set, a byte-model dict) is not
        *shared mutable state*, and inventorying it would make the ledger
        churn on every new constant. Kept unconditionally: ``queue`` /
        ``threadlocal`` kinds (the deliberate sharing idioms) and
        ``rebound`` slots (a ``global`` declaration IS a write)."""
        written: set[str] = set()
        for node in self.nodes:
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name):
                    written.add(t.value.id)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS
                    and isinstance(node.func.value, ast.Name)):
                written.add(node.func.value.id)

        def keep(g: GlobalSite) -> bool:
            return (g.kind in ("queue", "threadlocal", "rebound")
                    or g.name in written)

        self.globals_ = [g for g in self.globals_ if keep(g)]
        self.module_globals = {
            n: k for n, k in self.module_globals.items()
            if k in ("queue", "threadlocal", "rebound") or n in written
        }

    @staticmethod
    def _own_nodes(fn) -> Iterable[ast.AST]:
        """The function's own statements — nested defs/lambdas are separate
        scopes audited on their own walk."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _collect_threads_and_instance_sync(self) -> None:
        # enclosing-scope names for instance sync sites ("Class.attr")
        parents: dict[int, str] = {}

        def walk(node, scope):
            for child in ast.iter_child_nodes(node):
                s = scope
                if isinstance(child, ast.ClassDef):
                    s = child.name
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    parents[id(child)] = scope
                    s = scope
                walk(child, s)

        walk(self.tree, "")
        for node in self.nodes:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                ck = self._ctor_kind(node.value)
                if ck and ck[0] == "sync":
                    for t in node.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            scope = self._class_of(t) or "<instance>"
                            self.sync.append(SyncSite(
                                self.key, node.lineno, node.col_offset,
                                f"{scope}.{t.attr}", ck[1], "instance"))
            if isinstance(node, ast.Call) and _is_thread_ctor(node):
                name = _const_kwarg(node, "name")
                daemon = _const_kwarg(node, "daemon")
                target = _target_base(node)
                assigned = self._assigned_base(node)
                key = str(name) if isinstance(name, str) else (
                    f"target={target}" if target else f"line@{node.lineno}")
                self.threads.append(ThreadSite(
                    self.key, node.lineno, node.col_offset, key, target,
                    name if isinstance(name, str) else None,
                    daemon if isinstance(daemon, bool) else None, assigned))

    def _class_of(self, attr_node: ast.Attribute) -> str | None:
        """The class whose method assigns ``self.<attr>`` (lexical walk)."""
        for node in self.nodes:
            if isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    if sub is attr_node:
                        return node.name
        return None

    def _assigned_base(self, ctor: ast.Call) -> str | None:
        """The base name/attr the Thread constructor's result is bound to
        (``x = Thread(...)`` -> 'x'; ``self._t = Thread(...)`` -> '_t')."""
        for node in self.nodes:
            if isinstance(node, ast.Assign) and node.value is ctor:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        return t.id
                    if isinstance(t, ast.Attribute):
                        return t.attr
        return None

    # -- threaded-scope resolution (GD013-style module-local fixpoint) --

    def threaded_scope(self) -> list[ast.AST]:
        """Function nodes reachable from any thread target in this module
        (by base name, through module-local calls, to a fixpoint)."""
        roots = {t.target for t in self.threads if t.target}
        scoped: set[str] = {r for r in roots if r in self.fn_nodes}
        changed = True
        while changed:
            changed = False
            for name in list(scoped):
                for fn in self.fn_nodes.get(name, []):
                    for callee in self.fn_calls.get(id(fn), ()):
                        if callee in self.fn_nodes and callee not in scoped:
                            scoped.add(callee)
                            changed = True
        out = []
        for name in sorted(scoped):
            out.extend(self.fn_nodes[name])
        return out

    # -- GT001 ----------------------------------------------------------

    def check_unguarded_writes(self) -> None:
        for fn in self.threaded_scope():
            globals_decl = {
                n for node in self._own_nodes(fn)
                if isinstance(node, ast.Global) for n in node.names
            }
            for stmt in fn.body:
                self._scan_writes(fn, stmt, [], globals_decl)

    def _scan_writes(self, fn, node, held: list[str],
                     globals_decl: set) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return                  # separate scope; audited via its own root
        if isinstance(node, ast.With):
            locks = [
                _base(item.context_expr) for item in node.items
                if _base(item.context_expr) in self.module_guards
            ]
            inner = held + locks
            # the with-statement's own item expressions run unguarded
            for item in node.items:
                self._scan_writes(fn, item.context_expr, held, globals_decl)
            for b in node.body:
                self._scan_writes(fn, b, inner, globals_decl)
            return
        self._write_at(fn, node, held, globals_decl)
        for child in ast.iter_child_nodes(node):
            self._scan_writes(fn, child, held, globals_decl)

    def _write_at(self, fn, node, held: list[str],
                  globals_decl: set) -> None:
        target_name = None
        what = None
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id in globals_decl \
                        and t.id in self.module_globals:
                    target_name, what = t.id, "rebinds"
                elif isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name) \
                        and t.value.id in self.module_globals:
                    target_name, what = t.value.id, "subscript-writes"
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in _MUTATORS
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id in self.module_globals):
            target_name, what = node.func.value.id, \
                f".{node.func.attr}()-mutates"
        if target_name is None:
            return
        kind = self.module_globals[target_name]
        if kind in _GT001_EXEMPT_KINDS:
            return
        if held:
            return
        self.emit(
            node, "GT001",
            f"thread-target scope {fn.name!r} {what} module global "
            f"{target_name!r} ({kind}) without holding an inventoried "
            f"lock — wrap the access in `with <lock>:` (and declare the "
            f"pairing in {LEDGER_NAME}), or route through an internally "
            f"synchronized container (queue.Queue / threading.local)",
        )

    # -- GT002 edges (local collection; graph checks are package-wide) --

    def collect_edges(self) -> None:
        acq_star: dict[str, set] = {
            name: set().union(*[self.fn_acquires[id(fn)]
                                for fn in fns]) if fns else set()
            for name, fns in self.fn_nodes.items()
        }
        changed = True
        while changed:
            changed = False
            for name, fns in self.fn_nodes.items():
                for fn in fns:
                    for callee in self.fn_calls.get(id(fn), ()):
                        extra = acq_star.get(callee, set()) - acq_star[name]
                        if extra:
                            acq_star[name] |= extra
                            changed = True

        def qual(lock: str) -> str:
            return f"{self.key}::{lock}"

        def visit(node, held: list[str]):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            if isinstance(node, ast.With):
                locks = [
                    _base(item.context_expr) for item in node.items
                    if _base(item.context_expr) in self.module_guards
                ]
                for lk in locks:
                    for h in held:
                        if h != lk:
                            self.edges.append(LockEdge(
                                qual(h), qual(lk), self.key,
                                node.lineno, node.col_offset))
                for item in node.items:
                    visit(item.context_expr, held)
                for b in node.body:
                    visit(b, held + locks)
                return
            if isinstance(node, ast.Call) and held:
                callee = _base(node.func)
                for lk in acq_star.get(callee, ()):
                    for h in held:
                        if h != lk:
                            self.edges.append(LockEdge(
                                qual(h), qual(lk), self.key,
                                node.lineno, node.col_offset))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for fns in self.fn_nodes.values():
            for fn in fns:
                for stmt in fn.body:
                    visit(stmt, [])

    # -- GT003 ----------------------------------------------------------

    def check_unjoined_threads(self) -> None:
        bounded: set[str] = set()
        for node in self.nodes:
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "join"
                    and (node.args or any(kw.arg == "timeout"
                                          for kw in node.keywords))):
                b = _base(node.func.value)
                if b:
                    bounded.add(b)
        started: set[str] = set()
        for node in self.nodes:
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "start"):
                b = _base(node.func.value)
                if b:
                    started.add(b)
        for t in self.threads:
            if t.assigned is None or (t.assigned in started
                                      and t.assigned not in bounded):
                site = ast.parse("0").body[0]       # placeholder w/ lineno
                site.lineno, site.col_offset = t.line, t.col
                self.emit(
                    site, "GT003",
                    f"thread {t.key!r} is started but the module has no "
                    f"bounded `.join(timeout=...)` for "
                    f"{t.assigned or 'its (unbound) object'} — a thread "
                    f"nobody can bound-join wedges exit or outlives its "
                    f"driver (the prefetch/mirror lesson); add a bounded "
                    f"join/close path, or disable with the invariant that "
                    f"bounds it",
                )

    # -- GT005 ----------------------------------------------------------

    def check_sleep_sync(self) -> None:
        for node in self.nodes:
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d == "time.sleep" or (self.has_sleep_import and d == "sleep"):
                self.emit(
                    node, "GT005",
                    "time.sleep used as synchronization — a sleep is never "
                    "a happens-before edge: wait on an Event/Condition/"
                    "queue with a timeout instead, or disable with the "
                    "reason this sleep is not synchronization (injected "
                    "fault primitive, bounded drain poll, fuzzer jitter)",
                )


# ---------------------------------------------------------------------------
# package-wide analysis
# ---------------------------------------------------------------------------


def collect_inventory(paths: Iterable[str] | None = None,
                      sources: list[tuple[str, str]] | None = None
                      ) -> tuple[Inventory, list[Finding]]:
    """Parse every file and return ``(inventory, rule_findings)`` — the
    findings cover GT001/GT003/GT005 plus the GT002 *cycle* check; ledger
    diffs (GT004 + GT002 inversions) happen in :func:`check_ledger`.
    Disable comments are already honored."""
    if sources is None:
        sources = []
        for f in iter_python_files(paths or default_paths()):
            try:
                sources.append((str(f), f.read_text()))
            except OSError as e:
                # fail CLOSED, like graftlint: an uninspectable file is a
                # finding, not a skip
                return (Inventory([], [], [], []),
                        [Finding(_relkey(str(f)), 1, 0, "GT000",
                                 f"cannot read file: {e}")])
    audits = []
    findings: list[Finding] = []
    for path, src in sources:
        a = _FileAudit(path, src)
        a.collect()
        if a.tree is not None:
            a.check_unguarded_writes()
            a.collect_edges()
            a.check_unjoined_threads()
            a.check_sleep_sync()
        audits.append((a, src))
        findings.extend(a.findings)
    inv = Inventory(
        threads=[t for a, _ in audits for t in a.threads],
        sync=[s for a, _ in audits for s in a.sync],
        globals_=[g for a, _ in audits for g in a.globals_],
        edges=[e for a, _ in audits for e in a.edges],
    )
    findings.extend(_check_cycles(inv.edges))
    # honor disable comments
    out: list[Finding] = []
    disables = {}
    for a, src in audits:
        disables[a.key] = _parse_disables(src)
    for f in findings:
        same, nxt, whole = disables.get(f.path, ({}, {}, set()))
        disabled = (
            f.code in whole or "ALL" in whole
            or f.code in same.get(f.line, ()) or "ALL" in same.get(f.line, ())
            or f.code in nxt.get(f.line, ()) or "ALL" in nxt.get(f.line, ())
        )
        if not disabled:
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return inv, out


def _check_cycles(edges: list[LockEdge]) -> list[Finding]:
    """GT002: a cycle in the acquired-while-holding digraph is the textbook
    deadlock shape — two threads walking the cycle from different entry
    points block forever."""
    graph: dict[str, set] = {}
    where: dict[tuple, LockEdge] = {}
    for e in edges:
        graph.setdefault(e.outer, set()).add(e.inner)
        where.setdefault((e.outer, e.inner), e)
    findings = []
    seen_cycles: set = set()
    state: dict[str, int] = {}          # 0 unvisited, 1 on stack, 2 done

    def dfs(node, stack):
        state[node] = 1
        stack.append(node)
        for nxt in sorted(graph.get(node, ())):
            if state.get(nxt, 0) == 1:
                cyc = tuple(stack[stack.index(nxt):]) + (nxt,)
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    e = where.get((node, nxt)) or next(iter(where.values()))
                    findings.append(Finding(
                        e.path, e.line, e.col, "GT002",
                        "lock-order CYCLE: " + " -> ".join(cyc)
                        + " — two threads entering this cycle at different "
                        "locks deadlock; impose one global order (and "
                        f"commit it to {LEDGER_NAME})",
                    ))
            elif state.get(nxt, 0) == 0:
                dfs(nxt, stack)
        stack.pop()
        state[node] = 2

    for node in sorted(graph):
        if state.get(node, 0) == 0:
            dfs(node, [])
    return findings


# ---------------------------------------------------------------------------
# the ledger (concurrency_ledger.json)
# ---------------------------------------------------------------------------


def inventory_to_ledger(inv: Inventory) -> dict:
    threads = {
        f"{t.path}::{t.key}": {
            "target": t.target or None,
            "daemon": t.daemon,
        }
        for t in inv.threads
    }
    locks = {
        f"{s.path}::{s.name}": {"kind": s.kind, "scope": s.scope}
        for s in inv.sync
    }
    globals_ = {
        f"{g.path}::{g.name}": {"kind": g.kind}
        for g in inv.globals_
    }
    lock_order = sorted({(e.outer, e.inner) for e in inv.edges})
    return {
        "version": 1,
        "threads": dict(sorted(threads.items())),
        "locks": dict(sorted(locks.items())),
        "globals": dict(sorted(globals_.items())),
        "lock_order": [list(p) for p in lock_order],
    }


def load_ledger(path: Path | str | None = None) -> dict | None:
    p = Path(path) if path else default_ledger_path()
    if not p.exists():
        return None
    with open(p) as fh:
        return json.load(fh)


def write_ledger(inv: Inventory, path: Path | str | None = None) -> Path:
    from graphdyn_torch.utils.io import write_json_atomic

    p = Path(path) if path else default_ledger_path()
    doc = inventory_to_ledger(inv)
    # the runtime-declared edges are not derivable statically: keep them
    doc["runtime_order"] = (load_ledger(p) or {}).get("runtime_order", [])
    write_json_atomic(str(p), doc, indent=2, sort_keys=True)
    return p


def check_ledger(inv: Inventory, ledger: dict | None,
                 ledger_path: str | None = None) -> list[Finding]:
    """GT004 (+ GT002 inversions): diff the live inventory against the
    committed ledger. A missing ledger is a finding per live section —
    the gate fails until ``--update-ledger`` commits the contract."""
    lpath = _relkey(str(ledger_path or default_ledger_path()))
    live = inventory_to_ledger(inv)
    if ledger is None:
        return [Finding(
            lpath, 1, 0, "GT004",
            f"no concurrency ledger found ({LEDGER_NAME}) — run `python -m "
            "graphdyn_torch.analysis.racecheck --update-ledger` and commit "
            "it",
        )]
    findings: list[Finding] = []
    sites = {
        **{f"{t.path}::{t.key}": (t.path, t.line, t.col)
           for t in inv.threads},
        **{f"{s.path}::{s.name}": (s.path, s.line, s.col) for s in inv.sync},
        **{f"{g.path}::{g.name}": (g.path, g.line, g.col)
           for g in inv.globals_},
    }
    for section, noun in (("threads", "thread-spawn site"),
                          ("locks", "sync object"),
                          ("globals", "shared module global")):
        live_keys = set(live[section])
        ledger_keys = set(ledger.get(section, {}))
        for k in sorted(live_keys - ledger_keys):
            path, line, col = sites.get(k, (lpath, 1, 0))
            findings.append(Finding(
                path, line, col, "GT004",
                f"undeclared {noun} {k!r} — concurrency growth must be "
                f"declared: run --update-ledger and commit the new "
                f"{LEDGER_NAME} row (reviewed like a new HLO op category)",
            ))
        for k in sorted(ledger_keys - live_keys):
            findings.append(Finding(
                lpath, 1, 0, "GT004",
                f"stale ledger row: {noun} {k!r} no longer exists in the "
                f"code — run --update-ledger so the ledger matches the "
                f"shipped surface",
            ))
    live_edges = {tuple(p) for p in live["lock_order"]}
    ledger_edges = {tuple(p) for p in ledger.get("lock_order", [])}
    for a, b in sorted(live_edges - ledger_edges):
        e = next(e for e in inv.edges if (e.outer, e.inner) == (a, b))
        if (b, a) in ledger_edges:
            findings.append(Finding(
                e.path, e.line, e.col, "GT002",
                f"lock-order INVERSION: acquiring {b!r} while holding "
                f"{a!r}, but the ledger commits the order [{b}, {a}] — "
                "two threads obeying the two orders deadlock; restore the "
                "committed order or deliberately re-bless with "
                "--update-ledger",
            ))
        else:
            findings.append(Finding(
                e.path, e.line, e.col, "GT004",
                f"undeclared lock-order edge [{a}, {b}] — declare the "
                "acquired-while-holding pair via --update-ledger so the "
                "runtime half can assert the observed order against it",
            ))
    for a, b in sorted(ledger_edges - live_edges):
        findings.append(Finding(
            lpath, 1, 0, "GT004",
            f"stale ledger lock-order edge [{a}, {b}] — no live "
            "acquisition site implies it; run --update-ledger",
        ))
    return findings


def analyze_sources(sources: list[tuple[str, str]],
                    ledger: dict | None = None,
                    check_declarations: bool = False) -> list[Finding]:
    """Test-facing entry: rule findings for in-memory sources; pass a
    ledger dict (with ``check_declarations=True``) to also run the GT004/
    GT002-inversion diff."""
    inv, findings = collect_inventory(sources=sources)
    if check_declarations:
        findings = findings + check_ledger(inv, ledger)
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


# ---------------------------------------------------------------------------
# runtime half: the traced-lock proxy, order assertion, schedule fuzzer
# ---------------------------------------------------------------------------


class LockOrderError(RuntimeError):
    """The observed acquisition order inverts a ledgered pair — the runtime
    complement of GT002, raised at the acquire that closes the inversion."""


_tl = threading.local()                 # per-thread held stack + hook guard
_book_lock = threading.Lock()           # guards _observed/_held_registry (never wrapped)
_observed: set = set()                  # observed (outer, inner) edges
#: registration seq -> (thread name, that thread's live held-stack LIST —
#: the same object the thread mutates). Keyed by a monotonic registration
#: id and NEVER overwritten: thread names repeat (every prefetch worker
#: is "graphdyn-prefetch") and CPython recycles thread idents after
#: exit, so either as a key would let a replacement thread silently
#: shadow what a dead/wedged thread still holds — the exact evidence the
#: crash stamp exists to keep. Dead threads with EMPTY stacks are pruned
#: at registration time (bounds growth); a dead thread holding a lock is
#: kept — that IS the post-mortem.
_held_registry: dict = {}
_reg_next: list = [1]                   # monotonic seq (under _book_lock)
_runtime: dict = {"installed": False, "wrapped": [], "pairs": frozenset(),
                  "fuzz": None}
#: the fuzzer's delays, a pure function of their key (:func:`_fuzz_delay_s`)
_delays: dict = {}


def _held_stack() -> list:
    st = getattr(_tl, "held", None)
    if st is None:
        st = _tl.held = []
        t = threading.current_thread()
        with _book_lock:
            if len(_held_registry) > 64:
                live = {th.ident for th in threading.enumerate()}
                for k in [k for k, (_, ident, s) in _held_registry.items()
                          if not s and ident not in live]:
                    del _held_registry[k]
            seq = _reg_next[0]
            _reg_next[0] += 1
            _held_registry[seq] = (t.name, t.ident, st)
    return st


def held_locks() -> dict[str, list[str]]:
    """Snapshot of every registered thread's currently held wrapped locks
    (non-empty stacks only, keyed ``name#seq``) — the flight recorder's
    crash path stamps this into ``obs.crash`` so a post-mortem names the
    lock a wedged run died holding even after the ring rotated the
    acquire events out. Cross-thread reads are GIL-atomic list copies of
    live stacks: a racing acquire/release can shear the snapshot by one
    entry, which is exactly the precision a crash dump needs."""
    with _book_lock:
        return {f"{name}#{seq}": list(st)
                for seq, (name, _, st) in _held_registry.items() if st}


def _in_hook() -> bool:
    return getattr(_tl, "in_hook", False)


def _fuzz_delay_s(seed: int, lock: str, thread: str, op: str,
                  max_ms: float) -> float:
    """The fuzzer's seeding contract: the jitter at a given (lock, thread,
    op) site is a pure function of the seed — constant across the run, so
    a schedule that loses a race loses it reproducibly per seed."""
    h = int.from_bytes(hashlib.blake2s(
        f"{seed}:{lock}:{thread}:{op}".encode(), digest_size=4,
    ).digest(), "big")
    return (h % 1000) / 1000.0 * max_ms / 1000.0


#: below this, a jitter is waited out by yielding in a loop on the clock:
#: ``time.sleep`` of a few µs costs its timer's floor (~0.1 ms here, more
#: on a loaded host), which would turn a 20 µs jitter into a 1 ms one
_SPIN_BELOW_S = 1e-3


def _jitter(lock: str, op: str) -> None:
    cfg = _runtime.get("fuzz")
    if not cfg:
        return
    thread = threading.current_thread().name
    key = (cfg["seed"], lock, thread, op, cfg["max_ms"])
    delay = _delays.get(key)
    if delay is None:
        delay = _delays[key] = _fuzz_delay_s(*key)
    if delay >= _SPIN_BELOW_S:
        # graftrace: disable-next-line=GT005  the fuzzer IS the jitter primitive — this sleep exists to perturb schedules, not to synchronize
        time.sleep(delay)
    elif delay > 0:
        end = time.perf_counter() + delay
        while time.perf_counter() < end:
            # graftrace: disable-next-line=GT005  the fuzzer's short jitter: yield the GIL until the seeded delay has passed
            time.sleep(0)


class TracedLock:
    """A ``Lock``/``RLock`` proxy recording per-thread acquisition
    sequences (into the flight ring via the obs counter), asserting the
    observed lock order against the ledgered pairs, and injecting the
    seeded schedule jitter. Installed only under ``GRAPHDYN_RACECHECK=1``
    — racecheck-off code never sees this class."""

    __slots__ = ("_inner", "name")

    def __init__(self, inner, name: str):
        self._inner = inner
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _in_hook():
            return self._inner.acquire(blocking, timeout)
        # order check + event + jitter all happen BEFORE blocking on the
        # inner lock: an inversion is detected without deadlocking on it,
        # and the flight-ring event for a lock the run then wedges on says
        # what it was WAITING FOR and what it already held — exactly the
        # post-mortem question. (Emitting while holding would also
        # self-deadlock when the acquired lock IS the flight ring's own.)
        _tl.in_hook = True
        try:
            self._note_acquire_attempt()
            _jitter(self.name, "acquire")
        finally:
            _tl.in_hook = False
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        if not _in_hook():
            st = _held_stack()
            for i in range(len(st) - 1, -1, -1):
                if st[i] == self.name:
                    del st[i]
                    break
        self._inner.release()
        if _in_hook():
            return
        _tl.in_hook = True
        try:
            _jitter(self.name, "release")
        finally:
            _tl.in_hook = False

    def _note_acquire_attempt(self) -> None:
        st = _held_stack()
        held = [h for h in st if h != self.name]
        pairs = _runtime["pairs"]
        for h in held:
            if (self.name, h) in pairs and (h, self.name) not in pairs:
                raise LockOrderError(
                    f"lock-order inversion on thread "
                    f"{threading.current_thread().name!r}: acquiring "
                    f"{self.name!r} while holding {h!r}, but "
                    f"{LEDGER_NAME} commits the order "
                    f"[{self.name}, {h}] — the GT002 contract, observed "
                    f"live"
                )
        if held:
            with _book_lock:
                for h in held:
                    _observed.add((h, self.name))
        from graphdyn_torch import obs

        obs.counter(
            "racecheck.acquire", lock=self.name,
            thread=threading.current_thread().name,
            depth=len(held) + 1, held="|".join(held) or None,
        )

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


def _module_name(relkey: str) -> str:
    return relkey[:-3].replace("/", ".") if relkey.endswith(".py") else ""


_SELF_KEY = "graphdyn_torch/analysis/racecheck.py"


def _module_locks(paths) -> list[SyncSite]:
    """The module-scope ``Lock``/``RLock`` sites of ``paths`` — what
    :func:`install` wraps — from each module's top-level statements alone
    (the full inventory's rule passes are not needed to install)."""
    out = []
    for f in iter_python_files(paths):
        try:
            tree = ast.parse(f.read_text())
        except (OSError, SyntaxError):
            continue
        a = _FileAudit(str(f), "")
        a.tree, a.nodes = tree, list(ast.walk(tree))
        a._collect_module_state()
        out += [s for s in a.sync if s.kind in ("lock", "rlock")]
    return out


def install(ledger_path: Path | str | None = None, *,
            fuzz_seed: int | None = None,
            fuzz_max_ms: float | None = None) -> list[str]:
    """Wrap every inventoried *module-scope* ``Lock``/``RLock`` in a
    :class:`TracedLock` (this module's own bookkeeping lock excluded).
    Idempotent; returns the wrapped qualified names. The ledger's
    ``lock_order`` pairs become the runtime assertion set."""
    if _runtime["installed"]:
        return [name for name, *_ in _runtime["wrapped"]]
    ledger = load_ledger(ledger_path)
    _runtime["pairs"] = _ledger_pairs(ledger)
    if fuzz_seed is None:
        raw = os.environ.get(FUZZ_ENV, "").strip()
        if raw:
            try:
                fuzz_seed = int(raw)
            except ValueError:
                fuzz_seed = None
    if fuzz_seed is not None:
        if fuzz_max_ms is None:
            try:
                fuzz_max_ms = float(
                    os.environ.get(FUZZ_MAX_ENV, "") or FUZZ_MAX_MS_DEFAULT)
            except ValueError:
                fuzz_max_ms = FUZZ_MAX_MS_DEFAULT
        _runtime["fuzz"] = {"seed": int(fuzz_seed),
                            "max_ms": float(fuzz_max_ms)}
    wrapped = []
    for s in _module_locks(default_paths()):
        if s.path == _SELF_KEY:
            continue                    # never wrap our own bookkeeping
        modname = _module_name(s.path)
        if not modname:
            continue
        try:
            mod = importlib.import_module(modname)
        except ImportError:
            continue
        obj = getattr(mod, s.name, None)
        if obj is None or isinstance(obj, TracedLock):
            continue
        if not (hasattr(obj, "acquire") and hasattr(obj, "release")):
            continue
        qual = f"{s.path}::{s.name}"
        proxy = TracedLock(obj, qual)
        setattr(mod, s.name, proxy)
        wrapped.append((qual, mod, s.name, obj))
    _runtime["wrapped"] = wrapped
    _runtime["installed"] = True
    return [name for name, *_ in wrapped]


def uninstall() -> None:
    """Restore the plain lock objects and reset the runtime state
    (tests; a real run just exits)."""
    for _, mod, attr, obj in _runtime["wrapped"]:
        setattr(mod, attr, obj)
    _runtime.update(installed=False, wrapped=[], pairs=frozenset(),
                    fuzz=None)
    with _book_lock:
        _observed.clear()
        # clear IN PLACE: the registry and each thread's _tl.held point at
        # the same list object — rebinding would orphan the registry view
        for _, _, st in _held_registry.values():
            st.clear()


def installed() -> bool:
    return bool(_runtime["installed"])


def observed_order() -> list[tuple[str, str]]:
    """The observed acquired-while-holding edges so far (sorted)."""
    with _book_lock:
        return sorted(_observed)


def assert_observed_against_ledger(ledger_path=None) -> list[str]:
    """Post-run check: every observed edge must not invert a ledgered
    pair. (Install-time acquisition already raises on the closing acquire;
    this surfaces the full list for harnesses.) Returns problem strings."""
    pairs = _runtime["pairs"] or _ledger_pairs(load_ledger(ledger_path))
    problems = []
    for a, b in observed_order():
        if (b, a) in pairs and (a, b) not in pairs:
            problems.append(
                f"observed edge [{a}, {b}] inverts ledgered pair [{b}, {a}]")
    return problems


def undeclared_observed(ledger_path=None) -> list[tuple[str, str]]:
    """Observed edges the ledger declares in neither ``lock_order`` nor
    ``runtime_order`` (candidates for a reviewed ``runtime_order`` row)."""
    pairs = _runtime["pairs"] or _ledger_pairs(load_ledger(ledger_path))
    return [e for e in observed_order() if e not in pairs]


def _ledger_pairs(ledger: dict | None) -> frozenset:
    """The order pairs the runtime asserts: the static ``lock_order`` and
    the declared ``runtime_order``."""
    led = ledger or {}
    return frozenset(tuple(p) for p in (led.get("lock_order", [])
                                        + led.get("runtime_order", [])))


def maybe_install() -> list[str]:
    """CLI hook: install the runtime proxies when ``GRAPHDYN_RACECHECK=1``.
    With the env unset this is ONE dict lookup — racecheck-off runs keep
    the plain ``threading`` locks (no proxy exists, zero per-acquire
    cost)."""
    if os.environ.get(ENV_VAR) != "1":
        return []
    return install()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m graphdyn_torch.analysis.racecheck",
        description="graftrace: host-concurrency auditor over the "
                    "committed shared-state ledger (exit code = number of "
                    "findings)",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to audit (default: the "
                    "graphdyn_torch package)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--ledger", default=None,
                    help=f"ledger path (default: {LEDGER_NAME} beside this "
                    f"module)")
    ap.add_argument("--update-ledger", action="store_true",
                    help="rewrite the declaration ledger from the live "
                         "inventory (GT001/GT002-cycle/GT003/GT005 rule "
                         "findings still gate)")
    args = ap.parse_args(argv)

    paths = args.paths or default_paths()
    inv, findings = collect_inventory(paths)
    if args.update_ledger:
        if args.paths:
            ap.error("--update-ledger declares the WHOLE package surface; "
                     "it cannot be combined with explicit paths")
        path = write_ledger(inv, args.ledger)
        print(
            f"graftrace: wrote {len(inv.threads)} thread(s), "
            f"{len(inv.sync)} sync object(s), {len(inv.globals_)} shared "
            f"global(s), {len({(e.outer, e.inner) for e in inv.edges})} "
            f"lock-order edge(s) to {path}", file=sys.stderr)
    elif not args.paths:
        # the declaration diff (GT004) only means something over the full
        # default scope the ledger declares — a partial path list would
        # read every undiffed module as a stale row
        findings = findings + check_ledger(inv, load_ledger(args.ledger),
                                           args.ledger)
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    else:
        print("graftrace: explicit paths — rule findings only, ledger "
              "diff skipped (it covers the whole package scope)",
              file=sys.stderr)

    if args.format == "json":
        # exactly ONE JSON document on stdout (CI pipes it); diagnostics
        # stay on stderr — the graftlint/graftcheck contract
        print(json.dumps({
            "findings": [f._asdict() for f in findings],
            "inventory": inventory_to_ledger(inv),
        }, indent=2))
    else:
        for f in findings:
            print(f"{f.path}:{f.line}:{f.col}: {f.code} {f.message}")
    if findings:
        print(f"graftrace: {len(findings)} finding(s)", file=sys.stderr)
    else:
        print(
            f"graftrace: concurrency surface clean ({len(inv.threads)} "
            f"thread(s), {len(inv.sync)} sync object(s), "
            f"{len(inv.globals_)} shared global(s))", file=sys.stderr)
    return min(len(findings), 125)


if __name__ == "__main__":
    sys.exit(main())
