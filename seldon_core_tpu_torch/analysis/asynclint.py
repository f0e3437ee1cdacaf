"""RL6xx — asyncio concurrency lint: event-loop races on shared state (port
of ``seldon_core_tpu/analysis/asynclint.py``, unchanged).

Every serving tier in this repo (gateway, engine walk, fleet router,
caches, registries) shares one event loop.  Coroutines interleave at
``await`` points only, so the classic race shape is *check-then-act
split by an await*: coroutine A checks a registry, awaits a build/dial,
and inserts — while coroutine B did the same in the gap.  A
``threading.Lock`` does not help (it would deadlock across awaits);
only an ``asyncio.Lock`` (or never awaiting inside the critical
section) does.

A per-function dataflow pass over the AST.  **Shared mutable state** is:

- module-level names bound to container literals/constructors
  (``_REGISTRY = {}``, ``_pools: dict = defaultdict(list)``), and
- ``self.*`` attributes bound to containers in ``__init__`` (or the
  class body) of any class that defines at least one ``async def``
  method — one instance's coroutines interleave on the loop, which is
  exactly the singleton/registry/pool shape.

Rules (stable codes in ``findings.py``; docs/static-analysis.md):

- **RL601 ERROR** — a *check* of shared state (membership test, ``.get``
  probe, or any read inside an ``if``/``while`` test), then an
  ``await``, then a *write* to the same state, with no lock held: the
  TOCTOU race.
- **RL602 WARN** — shared container read before an ``await`` and
  mutated after it, unlocked (the observation is stale by the time the
  mutation lands).  RL601 subsumes this when the read was a check.
- **RL603 ERROR** — ``asyncio.create_task(...)`` / ``ensure_future``
  whose result is discarded: the event loop keeps only a weak
  reference, so the task can be garbage-collected mid-flight.
- **RL604 WARN** — an ``asyncio`` lock held across an awaited
  network/remote call: every coroutine needing the lock now waits on
  one peer's RTT — the hot path serializes.
- **RL605 WARN** — ``await asyncio.gather(...)`` without
  ``return_exceptions`` outside any ``try``: the first child exception
  propagates while the surviving siblings keep running unobserved.

Suppression: ``# graphlint: disable=CODE[,CODE]`` on any line of the
flagged statement, or ``# graphlint: skip-file`` — same pragmas as
``repolint.py``.  Sync functions, nested ``def``s, and lambdas are not
async context and are never flagged.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, Optional

from seldon_core_tpu_torch.analysis.findings import (
    DISCARDED_TASK,
    GATHER_WITHOUT_RETURN_EXCEPTIONS,
    LOCK_HELD_ACROSS_REMOTE_AWAIT,
    SHARED_MUTATION_ACROSS_AWAIT,
    UNLOCKED_CHECK_THEN_ACT,
    Finding,
    make_finding,
)
from seldon_core_tpu_torch.analysis.repolint import (
    _SKIP_FILE,
    _dotted,
    _import_aliases,
    pragma_suppressed,
)

#: constructors whose result is a shared mutable container
_CONTAINER_CALLS = frozenset({
    "dict", "list", "set", "defaultdict", "OrderedDict", "deque",
    "Counter", "ChainMap", "WeakValueDictionary", "WeakKeyDictionary",
})

#: lock-ish constructors (asyncio OR threading — holding either marks a
#: region "locked" for RL601/602; RL604 only fires for async with)
_LOCK_CALLS = frozenset({
    "Lock", "RLock", "Semaphore", "BoundedSemaphore", "Condition",
})

#: method names that mutate a container in place
_MUTATORS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear",
    "appendleft", "popleft", "extendleft",
})

#: method names that probe a container — a *check* for RL601
_PROBES = frozenset({"get", "__contains__"})

#: awaited-call name fragments that mark a network/remote call (RL604)
_REMOTE_SEGMENTS = frozenset({
    "client", "session", "http", "aiohttp", "httpx", "sock", "conn",
    "channel", "remote",
})
_REMOTE_TAILS = frozenset({
    "fetch", "request", "urlopen", "connect", "open_connection",
    "create_connection", "post", "put", "delete", "send", "recv",
    "read", "write", "scrape", "probe", "dispatch",
})


def _is_container_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set,
                         ast.DictComp, ast.ListComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return _dotted(node.func).rpartition(".")[2] in _CONTAINER_CALLS
    return False


def _is_lock_expr_ctor(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _dotted(node.func).rpartition(".")[2] in _LOCK_CALLS)


def _module_shared_globals(tree: ast.Module) -> set:
    """Module-level names bound to mutable containers."""
    names: set = set()
    for stmt in tree.body:
        targets: list = []
        if isinstance(stmt, ast.Assign) and _is_container_expr(stmt.value):
            targets = stmt.targets
        elif (isinstance(stmt, ast.AnnAssign) and stmt.value is not None
                and _is_container_expr(stmt.value)):
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
    return names


def _class_shared_state(cls: ast.ClassDef) -> tuple:
    """(shared container attrs, lock attrs) of one class: ``self.x = {}``
    in ``__init__`` (or a container class attribute), ``self._lock =
    asyncio.Lock()``.  Annotated forms (``self._cond: asyncio.Condition
    = asyncio.Condition()``) and class-body lock attributes count the
    same as their bare equivalents — any ``asyncio`` guard primitive
    (Lock/Semaphore/Condition/...) marks a guarded region."""
    shared: set = set()
    locks: set = set()
    for stmt in cls.body:
        targets: list = []
        if isinstance(stmt, ast.Assign):
            targets = [(t, stmt.value) for t in stmt.targets]
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [(stmt.target, stmt.value)]
        for t, value in targets:
            if not isinstance(t, ast.Name):
                continue
            if _is_container_expr(value):
                shared.add(t.id)
            elif _is_lock_expr_ctor(value):
                locks.add(t.id)
        if not (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                and stmt.name == "__init__"):
            continue
        for sub in ast.walk(stmt):
            pairs: list = []
            if isinstance(sub, ast.Assign):
                pairs = [(t, sub.value) for t in sub.targets]
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                pairs = [(sub.target, sub.value)]
            for t, value in pairs:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    if _is_container_expr(value):
                        shared.add(t.attr)
                    elif _is_lock_expr_ctor(value):
                        locks.add(t.attr)
    return shared, locks


def _looks_like_lock(name: str) -> bool:
    tail = name.rpartition(".")[2].lower()
    return "lock" in tail or "mutex" in tail or "sem" in tail


def _is_remote_call(name: str) -> bool:
    segments = [s.lower() for s in name.split(".")]
    if any(seg in _REMOTE_SEGMENTS for s in segments
           for seg in (s, s.lstrip("_"))):
        return True
    return bool(segments) and segments[-1] in _REMOTE_TAILS


class _AsyncFnScanner:
    """Linear event timeline of one ``async def``: shared-state reads,
    checks, writes, awaits — plus lock/try scoping.  Branch bodies are
    flattened in source order (a lint heuristic, not an interpreter)."""

    def __init__(self, linter: "_AsyncLinter", shared: set, locks: set):
        self.linter = linter
        self.shared = shared          # keys: "name" or "self.attr"
        self.locks = locks            # lock attr names on self
        self.events: list = []        # (kind, key, node)
        self._lock_depth = 0
        self._async_lock_depth = 0
        self._try_depth = 0

    # -- key extraction --------------------------------------------------
    def _shared_key(self, node: ast.AST) -> Optional[str]:
        while isinstance(node, ast.Subscript):
            node = node.value
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in self.shared):
            return f"self.{node.attr}"
        if isinstance(node, ast.Name) and node.id in self.shared:
            return node.id
        return None

    def _is_lock_ref(self, node: ast.AST) -> bool:
        """Is this with-context expression a lock?  ``self._lock``,
        anything lock-named, or ``self._lock.acquire_timeout(...)``."""
        if isinstance(node, ast.Call):
            node = node.func
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in self.locks):
            return True
        return _looks_like_lock(_dotted(node))

    # -- event emission --------------------------------------------------
    def _event(self, kind: str, key: Optional[str], node: ast.AST) -> None:
        self.events.append((kind, key, node,
                            self._lock_depth > 0, self._try_depth > 0))

    # -- statements ------------------------------------------------------
    def scan(self, fn: ast.AsyncFunctionDef) -> None:
        self._stmts(fn.body)

    def _stmts(self, body: list) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separate schedule (executor, callback, ...)
        if isinstance(stmt, (ast.If, ast.While)):
            self._expr(stmt.test, test=True)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter)
            if isinstance(stmt, ast.AsyncFor):
                self._event("await", None, stmt)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._with(stmt)
            return
        if isinstance(stmt, ast.Try):
            self._try_depth += 1
            self._stmts(stmt.body)
            self._try_depth -= 1
            for h in stmt.handlers:
                self._stmts(h.body)
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
            return
        if isinstance(stmt, ast.Expr):
            self._maybe_rl603(stmt)
            self._expr(stmt.value)
            return
        if isinstance(stmt, ast.Assign):
            self._expr(stmt.value)
            for t in stmt.targets:
                self._target(t)
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value)
            key = self._shared_key(stmt.target)
            if key:
                self._event("write", key, stmt)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._expr(stmt.value)
                self._target(stmt.target)
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                key = self._shared_key(t)
                if key:
                    self._event("write", key, stmt)
            return
        if isinstance(stmt, ast.Assert):
            self._expr(stmt.test, test=True)
            return
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            self._expr(stmt.value)
            return
        # anything else: scan its expressions generically
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _target(self, t: ast.AST) -> None:
        """Assignment target: a store through a shared container
        (``self._x[k] = v``, ``self._x = rebuilt``) is a write."""
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._target(el)
            return
        if isinstance(t, ast.Subscript):
            self._expr(t.slice)
        key = self._shared_key(t)
        if key:
            self._event("write", key, t)

    def _with(self, stmt) -> None:
        lockish = any(self._is_lock_ref(item.context_expr)
                      for item in stmt.items)
        for item in stmt.items:
            self._expr(item.context_expr)
        is_async = isinstance(stmt, ast.AsyncWith)
        if is_async:
            self._event("await", None, stmt)
        if lockish:
            self._lock_depth += 1
            self._async_lock_depth += 1 if is_async else 0
        self._stmts(stmt.body)
        if lockish:
            self._lock_depth -= 1
            self._async_lock_depth -= 1 if is_async else 0

    def _maybe_rl603(self, stmt: ast.Expr) -> None:
        call = stmt.value
        if isinstance(call, ast.Await):
            return  # awaited — the result is consumed by the wait
        if not isinstance(call, ast.Call):
            return
        name = self.linter.canonical(_dotted(call.func))
        if name.rpartition(".")[2] in ("create_task", "ensure_future"):
            self.linter.emit(
                DISCARDED_TASK, stmt,
                f"{name}(...) result discarded — the event loop holds "
                "only a weak reference, so the task can be "
                "garbage-collected mid-flight; keep a reference (and "
                "await or add_done_callback it)",
            )

    # -- expressions -----------------------------------------------------
    def _expr(self, node: Optional[ast.AST], test: bool = False) -> None:
        if node is None or isinstance(node, (ast.Lambda, ast.GeneratorExp)):
            return
        if isinstance(node, ast.Await):
            self._await(node, test)
            return
        if isinstance(node, ast.IfExp):
            self._expr(node.test, test=True)
            self._expr(node.body, test)
            self._expr(node.orelse, test)
            return
        if isinstance(node, ast.Call):
            self._call(node, test)
            return
        if isinstance(node, ast.Compare):
            membership = any(isinstance(op, (ast.In, ast.NotIn))
                             for op in node.ops)
            self._expr(node.left, test)
            for cmp_op, comparator in zip(node.ops, node.comparators):
                key = self._shared_key(comparator)
                if key is not None and isinstance(cmp_op, (ast.In, ast.NotIn)):
                    self._event("check", key, comparator)
                else:
                    self._expr(comparator, test or membership)
            return
        key = self._shared_key(node)
        if key is not None:
            self._event("check" if test else "read", key, node)
            if isinstance(node, ast.Subscript):
                self._expr(node.slice, False)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, test)

    def _call(self, node: ast.Call, test: bool) -> None:
        if isinstance(node.func, ast.Attribute):
            key = self._shared_key(node.func.value)
            if key is not None:
                if node.func.attr in _MUTATORS:
                    for a in node.args:
                        self._expr(a, False)
                    for kw in node.keywords:
                        self._expr(kw.value, False)
                    self._event("write", key, node)
                    return
                kind = ("check" if test or node.func.attr in _PROBES
                        else "read")
                self._event(kind, key, node)
        else:
            self._expr(node.func, False)
        for a in node.args:
            self._expr(a, False)
        for kw in node.keywords:
            self._expr(kw.value, False)

    def _await(self, node: ast.Await, test: bool) -> None:
        inner = node.value
        self._expr(inner, test)
        name = ""
        if isinstance(inner, ast.Call):
            name = self.linter.canonical(_dotted(inner.func))
            if (name == "asyncio.gather"
                    and not any(kw.arg == "return_exceptions"
                                for kw in inner.keywords)
                    and self._try_depth == 0):
                self.linter.emit(
                    GATHER_WITHOUT_RETURN_EXCEPTIONS, node,
                    "asyncio.gather without return_exceptions in a "
                    "try-less scope: the first child exception "
                    "propagates while surviving siblings keep running "
                    "unobserved",
                )
        if self._async_lock_depth > 0 and name and _is_remote_call(name):
            self.linter.emit(
                LOCK_HELD_ACROSS_REMOTE_AWAIT, node,
                f"asyncio lock held across awaited remote call "
                f"{name}() — every coroutine needing this lock now "
                "waits on one peer's network round-trip",
            )
        self._event("await", None, node)

    # -- race detection over the event timeline --------------------------
    def report(self) -> None:
        """RL601/RL602 per shared key, worst finding once per key."""
        keys = {k for kind, k, *_ in self.events if k}
        for key in sorted(keys):
            self._report_key(key)

    def _report_key(self, key: str) -> None:
        checked_before_await = False   # unlocked check, then an await
        read_before_await = False      # unlocked read, then an await
        pending_check = False
        pending_read = False
        for kind, k, node, locked, _in_try in self.events:
            if kind == "await":
                checked_before_await |= pending_check
                read_before_await |= pending_read
                continue
            if k != key or locked:
                continue
            if kind == "check":
                pending_check = True
            elif kind == "read":
                pending_read = True
            elif kind == "write":
                if checked_before_await:
                    self.linter.emit(
                        UNLOCKED_CHECK_THEN_ACT, node,
                        f"{key} checked, then awaited, then written with "
                        "no asyncio.Lock held — another coroutine can "
                        "interleave at the await and invalidate the "
                        "check (TOCTOU)",
                    )
                    return
                if read_before_await:
                    self.linter.emit(
                        SHARED_MUTATION_ACROSS_AWAIT, node,
                        f"{key} read before an await and mutated after "
                        "it, unlocked — the observation is stale by the "
                        "time the mutation lands",
                    )
                    return
                pending_read = True  # a write is also an observation


class _AsyncLinter:
    def __init__(self, rel_path: str, source: str, tree: ast.Module):
        self.rel_path = rel_path
        self.lines = source.splitlines()
        self.aliases = _import_aliases(tree)
        self.tree = tree
        self.findings: list = []

    def canonical(self, name: str) -> str:
        head, _, rest = name.partition(".")
        full = self.aliases.get(head)
        if full:
            return f"{full}.{rest}" if rest else full
        return name

    def emit(self, code: str, node: ast.AST, message: str) -> None:
        if not pragma_suppressed(self.lines, node, code):
            self.findings.append(make_finding(
                code, f"{self.rel_path}:{node.lineno}", message))

    def run(self) -> list:
        module_shared = _module_shared_globals(self.tree)
        self._scope(self.tree, module_shared, set())
        return self.findings

    def _scope(self, node: ast.AST, shared: set, locks: set) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                attrs, cls_locks = _class_shared_state(child)
                has_async = any(
                    isinstance(m, ast.AsyncFunctionDef) for m in child.body)
                # shared holds both global names and bare self-attr names
                cls_shared = shared | (attrs if has_async else set())
                for m in child.body:
                    if isinstance(m, ast.AsyncFunctionDef):
                        self._scan_fn(m, cls_shared, cls_locks | locks)
                    elif isinstance(m, (ast.FunctionDef, ast.ClassDef)):
                        self._scope(m, shared, locks)
            elif isinstance(child, ast.AsyncFunctionDef):
                self._scan_fn(child, shared, locks)
            else:
                self._scope(child, shared, locks)

    def _scan_fn(self, fn: ast.AsyncFunctionDef, shared: set,
                 locks: set) -> None:
        scanner = _AsyncFnScanner(self, shared, locks)
        scanner.scan(fn)
        scanner.report()


def lint_source(source: str, rel_path: str) -> list:
    """RL6xx findings for one file's source."""
    if _SKIP_FILE.search(source):
        return []
    try:
        tree = ast.parse(source, filename=rel_path)
    except SyntaxError:
        return []  # repolint already reports the parse failure
    return _AsyncLinter(rel_path, source, tree).run()


def lint_file(path: str, root: Optional[str] = None) -> list:
    rel = os.path.relpath(path, root) if root else path
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), rel)


def lint_paths(paths: Iterable[str],
               root: Optional[str] = None) -> list[Finding]:
    """Lint files and (recursively) directories of ``*.py`` files."""
    findings: list[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, files in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        findings.extend(
                            lint_file(os.path.join(dirpath, fn), root or p))
        else:
            findings.extend(lint_file(p, root))
    return findings
