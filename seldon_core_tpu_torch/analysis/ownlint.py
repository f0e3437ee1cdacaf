"""RL7xx — device-ref ownership lint: one-shot registry lifecycles.

The device plane's remote fast path moves tensors as *refs* minted by
:mod:`~seldon_core_tpu_torch.runtime.device_registry`: ``put()`` /
``put_shm()`` hand back a **one-shot** token whose first ``resolve()``
consumes it (donation frees the producer's buffer), and ``channel()``
hands back a reusable ``ShmChannel`` lane the holder must ``close()``.
Both contracts are invisible to the type system — a ref is just a
``str`` — so misuse compiles fine and fails only under traffic.  This
pass statically enforces the lifecycle over the package's AST, the way
RL6xx enforces event-loop locking.

A per-function abstract interpreter tracks locals bound to minted refs
through a three-point lattice {live, consumed, maybe-consumed} with
branch-merge (``if``/``try``) semantics:

- **RL701 ERROR** — use-after-consume: a ref local is resolved (or
  otherwise read) after a ``resolve()`` already consumed/donated it —
  the second use observes a dead ref at runtime, unconditionally.
- **RL702 ERROR** — double-consume across branches: a ref consumed on
  one branch of an ``if``/``try`` and resolved again after the join —
  dead-ref on exactly the paths tests rarely cover.
- **RL703 WARN** — a ``resolve()`` call site with no byte-downgrade
  error path: ``resolve`` raises ``ForeignProcessRef``/``KeyError`` by
  contract (wrong process, consumed, expired) and every transport-facing
  caller must catch and fall back to the byte wire; a resolve outside
  any ``try`` body turns a negotiable downgrade into a 500.
- **RL704 WARN** — a ``ShmChannel`` lane acquired via ``channel()`` and
  neither handed off (returned / stored on an object) nor closed on all
  exits (``close()`` in a ``finally``): the backing shared-memory
  segment leaks for the process lifetime.

Receivers are matched structurally: any dotted name whose tail mentions
``registry`` (the module singleton, ``self._registry``, …) or a local
bound to a ``DeviceBufferRegistry(...)``; lane locals are those bound
from ``<registry>.channel(...)``.

Suppression: ``# graphlint: disable=CODE[,CODE]`` on any line of the
flagged statement, or ``# graphlint: skip-file`` — same pragmas as
``repolint.py``.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, Optional

from seldon_core_tpu_torch.analysis.findings import (
    REF_DOUBLE_CONSUME,
    REF_NO_DOWNGRADE_PATH,
    REF_USE_AFTER_CONSUME,
    SHM_LANE_NOT_CLOSED,
    Finding,
    make_finding,
)
from seldon_core_tpu_torch.analysis.repolint import (
    _SKIP_FILE,
    _dotted,
    pragma_suppressed,
)

#: ref-minting method names on a registry/lane receiver
_MINTS = frozenset({"put", "put_shm"})

LIVE = "live"
CONSUMED = "consumed"
MAYBE = "maybe"  # consumed on some join predecessor, not all


def _merge(a: Optional[str], b: Optional[str]) -> Optional[str]:
    """Join of the consumption lattice at a branch merge.  A var killed
    (re-bound to a non-ref) on either side drops out of tracking — we
    only reason about values we are sure are refs."""
    if a is None or b is None:
        return None
    if a == b:
        return a
    return MAYBE


def _merge_states(a: dict, b: dict) -> dict:
    out = {}
    for var in set(a) & set(b):
        m = _merge(a.get(var), b.get(var))
        if m is not None:
            out[var] = m
    return out


def _registryish(linter: "_OwnLinter", recv: ast.AST) -> bool:
    """Does this receiver expression denote a device-buffer registry?"""
    name = _dotted(recv)
    if not name:
        return False
    tail = name.rpartition(".")[2].lower()
    if "registry" in tail:
        return True
    return name in linter.registry_vars


def _is_mint(linter: "_OwnLinter", scanner: "_FnOwnership",
             node: ast.AST) -> bool:
    """``reg.put(x)`` / ``reg.put_shm(x)`` / ``lane.put(x)`` — mints a
    one-shot ref.  ``put_shm`` is distinctive enough to match on any
    receiver (the serving codecs alias the registry freely)."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MINTS):
        return False
    if node.func.attr == "put_shm":
        return True
    recv = node.func.value
    return (_registryish(linter, recv)
            or _dotted(recv) in scanner.lane_vars)


def _is_channel_acquire(linter: "_OwnLinter", node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "channel"
            and _registryish(linter, node.func.value))


class _FnOwnership:
    """Abstract interpretation of one function body over the ref lattice."""

    def __init__(self, linter: "_OwnLinter"):
        self.linter = linter
        self.state: dict = {}      # local name -> LIVE | CONSUMED | MAYBE
        self.lane_vars: set = set()  # locals bound from .channel()
        self._try_depth = 0        # lexically inside a Try body
        self._emitted: set = set()  # (lineno, code) — loop bodies run twice

    # -- emission --------------------------------------------------------
    def _emit(self, code: str, node: ast.AST, message: str) -> None:
        key = (getattr(node, "lineno", 0), code)
        if key in self._emitted:
            return
        self._emitted.add(key)
        self.linter.emit(code, node, message)

    # -- statement walk --------------------------------------------------
    def run(self, fn) -> None:
        self._stmts(fn.body)

    def _stmts(self, body: list) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separate scope, scanned on its own
        if isinstance(stmt, ast.If):
            self._expr(stmt.test)
            before = dict(self.state)
            self._stmts(stmt.body)
            after_body = self.state
            self.state = dict(before)
            self._stmts(stmt.orelse)
            self.state = _merge_states(after_body, self.state)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            if isinstance(stmt, ast.While):
                self._expr(stmt.test)
            else:
                self._expr(stmt.iter)
            # two passes over the body with merged entry state covers the
            # "consumed on iteration N, used on N+1" shape; _emitted
            # dedupes the replayed diagnostics
            before = dict(self.state)
            self._stmts(stmt.body)
            self.state = _merge_states(before, self.state)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            entry = dict(self.state)
            self._try_depth += 1
            self._stmts(stmt.body)
            self._try_depth -= 1
            after_body = dict(self.state)
            for h in stmt.handlers:
                # a handler can run with the body partially executed
                self.state = _merge_states(entry, after_body)
                self._stmts(h.body)
            self.state = after_body
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr)
            self._stmts(stmt.body)
            return
        if isinstance(stmt, ast.Assign):
            self._assign(stmt.value, stmt.targets)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign(stmt.value, [stmt.target])
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._expr(stmt.value)
            return
        if isinstance(stmt, ast.Expr):
            self._expr(stmt.value)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _assign(self, value: ast.AST, targets: list) -> None:
        self._expr(value)
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        for t in targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)):
                self._expr(t.value)
        if _is_mint(self.linter, self, value):
            for n in names:
                self.state[n] = LIVE
            return
        if _is_channel_acquire(self.linter, value):
            self.lane_vars.update(names)
            return
        for n in names:  # re-bound to something else: stop tracking
            self.state.pop(n, None)

    # -- expression walk -------------------------------------------------
    def _expr(self, node: Optional[ast.AST]) -> None:
        if node is None or isinstance(node, (ast.Lambda,
                                             ast.GeneratorExp)):
            return
        if isinstance(node, ast.Call) and self._resolve_call(node):
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if self.state.get(node.id) == CONSUMED:
                self._emit(
                    REF_USE_AFTER_CONSUME, node,
                    f"one-shot ref {node.id!r} used after resolve() "
                    "consumed it — the registry donated the buffer on "
                    "first resolve, so this use observes a dead ref",
                )
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _resolve_call(self, node: ast.Call) -> bool:
        """Handle ``<registry>.resolve(ref, ...)``; True if handled."""
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "resolve"
                and _registryish(self.linter, node.func.value)):
            return False
        if self._try_depth == 0:
            self._emit(
                REF_NO_DOWNGRADE_PATH, node,
                "resolve() outside any try: it raises ForeignProcessRef/"
                "KeyError by contract (foreign process, consumed, "
                "expired) — catch and downgrade to the byte wire instead "
                "of surfacing a 500",
            )
        consumed_kw = True
        for kw in node.keywords:
            if kw.arg == "consume" and isinstance(kw.value, ast.Constant):
                consumed_kw = bool(kw.value.value)
        args = list(node.args)
        ref = args[0] if args else None
        for extra in args[1:]:
            self._expr(extra)
        for kw in node.keywords:
            self._expr(kw.value)
        if isinstance(ref, ast.Name):
            st = self.state.get(ref.id)
            if st == CONSUMED:
                self._emit(
                    REF_USE_AFTER_CONSUME, ref,
                    f"one-shot ref {ref.id!r} resolved again after a "
                    "resolve() already consumed it — the registry "
                    "donated the buffer on the first resolve",
                )
            elif st == MAYBE:
                self._emit(
                    REF_DOUBLE_CONSUME, ref,
                    f"one-shot ref {ref.id!r} may already be consumed on "
                    "this path (a branch resolved it) — resolving again "
                    "double-consumes on exactly the branch-taken runs",
                )
            if st is not None and consumed_kw:
                self.state[ref.id] = CONSUMED
        elif ref is not None:
            self._expr(ref)
        return True


def _lane_escapes(fn, var: str) -> bool:
    """Lane handed off: returned/yielded, or stored onto an object or
    into a container — ownership (and the close obligation) moved."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            v = node.value
            if v is not None and any(
                    isinstance(n, ast.Name) and n.id == var
                    for n in ast.walk(v)):
                return True
        if isinstance(node, ast.Assign):
            stores = any(isinstance(t, (ast.Attribute, ast.Subscript))
                         for t in node.targets)
            if stores and any(isinstance(n, ast.Name) and n.id == var
                              for n in ast.walk(node.value)):
                return True
    return False


def _lane_closed_in_finally(fn, var: str) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try):
            continue
        for stmt in node.finalbody:
            for sub in ast.walk(stmt):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "close"
                        and isinstance(sub.func.value, ast.Name)
                        and sub.func.value.id == var):
                    return True
    return False


class _OwnLinter:
    def __init__(self, rel_path: str, source: str, tree: ast.Module):
        self.rel_path = rel_path
        self.lines = source.splitlines()
        self.tree = tree
        self.findings: list = []
        #: locals/globals bound to an explicit DeviceBufferRegistry(...)
        self.registry_vars: set = {
            t.id
            for node in ast.walk(tree)
            if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and _dotted(node.value.func).rpartition(".")[2]
            == "DeviceBufferRegistry"
            for t in node.targets if isinstance(t, ast.Name)
        }

    def emit(self, code: str, node: ast.AST, message: str) -> None:
        if not pragma_suppressed(self.lines, node, code):
            self.findings.append(make_finding(
                code, f"{self.rel_path}:{node.lineno}", message))

    def run(self) -> list:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_fn(node)
        return self.findings

    def _scan_fn(self, fn) -> None:
        scanner = _FnOwnership(self)
        scanner.run(fn)
        # RL704 over the lanes this function acquired and still owns
        for node in fn.body:
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Assign)
                        and _is_channel_acquire(self, sub.value)):
                    continue
                # self._lane = registry.channel(): ownership lives on the
                # object, closed by its own lifecycle — out of scope
                names = [t.id for t in sub.targets
                         if isinstance(t, ast.Name)]
                for var in names:
                    if _lane_escapes(fn, var):
                        continue
                    if _lane_closed_in_finally(fn, var):
                        continue
                    self.emit(
                        SHM_LANE_NOT_CLOSED, sub,
                        f"ShmChannel lane {var!r} acquired but not "
                        "closed on all exits — close() it in a finally "
                        "(or hand ownership off); the backing shared-"
                        "memory segment otherwise leaks for the process "
                        "lifetime",
                    )


def lint_source(source: str, rel_path: str) -> list:
    """RL7xx findings for one file's source."""
    if _SKIP_FILE.search(source):
        return []
    try:
        tree = ast.parse(source, filename=rel_path)
    except SyntaxError:
        return []  # repolint already reports the parse failure
    return _OwnLinter(rel_path, source, tree).run()


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
