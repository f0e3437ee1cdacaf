"""Repo lint: AST pass over the codebase's async and jit'd hot paths (port
of ``seldon_core_tpu/analysis/repolint.py``, rules, messages and pragmas
unchanged, so findings over the same source text are equal).

Two rule families, both pure ``ast`` (no imports of the linted code):

- **RL4xx — blocking calls in async functions.**  The engine walk
  (``graph/engine.py``), the gateway (``gateway/app.py``), and every
  other coroutine share one event loop; a single ``time.sleep`` or sync
  HTTP call stalls every in-flight request on the process.  Flags
  ``time.sleep``, sync HTTP clients (``requests``, ``urllib.request``,
  ``http.client``), ``socket`` dials, ``subprocess`` waits and
  ``os.system`` (RL401, ERROR), and bare ``open()`` file I/O (RL402,
  WARN) in the statement body of any ``async def``.

- **RL5xx — host sync inside jit'd functions.**  ``x.block_until_ready()``
  or ``np.asarray(x)`` on a tracer inside a ``@jax.jit`` function either
  fails at trace time or silently forces a device→host sync per step —
  flags them (RL501/RL502, ERROR) inside functions decorated with
  ``jit`` / ``jax.jit`` / ``partial(jax.jit, ...)``.  The port has no
  jit'd bodies, so over its own package RL5xx never fires; a counterpart
  for CUDA-graph capture bodies is an open question (ROADMAP.md).

Suppression: append ``# graphlint: disable=CODE[,CODE...]`` to the
offending line, or put ``# graphlint: skip-file`` anywhere in the file.
Nested ``def``/``class`` bodies inside an async function are *not*
treated as async context (they may run anywhere, e.g. in an executor).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Optional

from seldon_core_tpu_torch.analysis.findings import (
    BLOCKING_CALL_IN_ASYNC,
    HOST_MATERIALIZE_IN_JIT,
    HOST_SYNC_IN_JIT,
    SYNC_OPEN_IN_ASYNC,
    Finding,
    make_finding,
)

_DISABLE = re.compile(r"#\s*graphlint:\s*disable=([A-Z0-9,\s]+)")
_SKIP_FILE = re.compile(r"#\s*graphlint:\s*skip-file")

#: dotted call prefixes that block the event loop (RL401)
_BLOCKING_PREFIXES = (
    "time.sleep",
    "requests.",
    "urllib.request.",
    "http.client.",
    "socket.create_connection",
    "socket.getaddrinfo",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "os.system",
    "os.popen",
)

#: dotted calls that force a device→host sync (RL501)
_HOST_SYNC_CALLS = (
    "jax.block_until_ready",
    "jax.device_get",
)

#: numpy materializers — poison on tracers inside jit (RL502)
_NP_MATERIALIZERS = ("asarray", "array", "ascontiguousarray")

#: decorator spellings that mark a function as jit-compiled
_JIT_NAMES = ("jit", "pjit")


def pragma_suppressed(lines: list[str], node: ast.AST, code: str) -> bool:
    """True if a ``# graphlint: disable=CODE`` pragma covers ``node``.

    A multi-line construct (call spanning lines, decorated def) anchors
    its finding at ``node.lineno``, but the natural place for the pragma
    is often the closing line — honor any line in the node's
    ``lineno..end_lineno`` span, not just the first."""
    end = getattr(node, "end_lineno", None) or node.lineno
    for lineno in range(node.lineno, min(end, len(lines)) + 1):
        m = _DISABLE.search(lines[lineno - 1])
        if m and code in {c.strip() for c in m.group(1).split(",")}:
            return True
    return False


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('time.sleep', 'np.asarray')."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_jit_decorator(dec: ast.AST) -> bool:
    """@jit, @jax.jit, @nn.jit, @partial(jax.jit, ...), @jax.jit(...)"""
    if isinstance(dec, ast.Call):
        name = _dotted(dec.func)
        if name.rpartition(".")[2] == "partial" and dec.args:
            return _is_jit_decorator(dec.args[0])
        dec_name = name
    else:
        dec_name = _dotted(dec)
    return dec_name.rpartition(".")[2] in _JIT_NAMES


def _import_aliases(tree: ast.AST) -> dict[str, str]:
    """local name → canonical dotted prefix, from every import in the file
    (``from time import sleep`` → ``{"sleep": "time.sleep"}``,
    ``import numpy as onp`` → ``{"onp": "numpy"}``)."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


class _FileLinter(ast.NodeVisitor):
    def __init__(self, rel_path: str, source: str,
                 aliases: Optional[dict[str, str]] = None):
        self.rel_path = rel_path
        self.lines = source.splitlines()
        self.aliases = aliases or {}
        self.findings: list[Finding] = []
        self._async_depth = 0
        self._jit_depth = 0

    def _canonical(self, name: str) -> str:
        head, _, rest = name.partition(".")
        full = self.aliases.get(head)
        if full:
            return f"{full}.{rest}" if rest else full
        return name

    # -- helpers ---------------------------------------------------------
    def _suppressed(self, node: ast.AST, code: str) -> bool:
        return pragma_suppressed(self.lines, node, code)

    def _emit(self, code: str, node: ast.AST, message: str) -> None:
        if not self._suppressed(node, code):
            self.findings.append(make_finding(
                code, f"{self.rel_path}:{node.lineno}", message))

    # -- scope tracking --------------------------------------------------
    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        jit = any(_is_jit_decorator(d) for d in node.decorator_list)
        self._async_depth += 1
        self._jit_depth += 1 if jit else 0
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self._async_depth -= 1
        self._jit_depth -= 1 if jit else 0

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        jit = any(_is_jit_decorator(d) for d in node.decorator_list)
        # a nested sync def is NOT async context; suspend the async scope
        saved_async, self._async_depth = self._async_depth, 0
        self._jit_depth += 1 if jit else 0
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self._jit_depth -= 1 if jit else 0
        self._async_depth = saved_async

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved_async, self._async_depth = self._async_depth, 0
        self.generic_visit(node)
        self._async_depth = saved_async

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        saved_async, self._async_depth = self._async_depth, 0
        self.generic_visit(node)
        self._async_depth = saved_async

    # -- the rules -------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = self._canonical(_dotted(node.func))
        tail = name.rpartition(".")[2]
        if self._async_depth > 0:
            if any(name == p or (p.endswith(".") and name.startswith(p))
                   for p in _BLOCKING_PREFIXES):
                self._emit(
                    BLOCKING_CALL_IN_ASYNC, node,
                    f"blocking call {name}() inside an async function "
                    "stalls every request on this event loop; use the "
                    "async equivalent or run_in_executor",
                )
            elif name == "open":
                self._emit(
                    SYNC_OPEN_IN_ASYNC, node,
                    "sync file I/O inside an async function; move it to "
                    "startup or an executor",
                )
        if self._jit_depth > 0:
            if name in _HOST_SYNC_CALLS or tail == "block_until_ready":
                self._emit(
                    HOST_SYNC_IN_JIT, node,
                    f"{name}() inside a jit'd function forces a "
                    "device→host sync (or fails at trace time)",
                )
            elif (tail in _NP_MATERIALIZERS
                    and name.split(".")[0] in ("np", "numpy", "onp")
                    and "jax" not in name):  # jnp.asarray resolves to jax.*
                self._emit(
                    HOST_MATERIALIZE_IN_JIT, node,
                    f"{name}() materializes a tracer on the host inside a "
                    "jit'd function; use jnp instead",
                )
            elif tail == "item" and isinstance(node.func, ast.Attribute):
                self._emit(
                    HOST_MATERIALIZE_IN_JIT, node,
                    ".item() inside a jit'd function pulls a scalar to "
                    "the host per call",
                )
        self.generic_visit(node)


def lint_source(source: str, rel_path: str) -> list[Finding]:
    if _SKIP_FILE.search(source):
        return []
    try:
        tree = ast.parse(source, filename=rel_path)
    except SyntaxError as e:
        return [make_finding(
            BLOCKING_CALL_IN_ASYNC,
            f"{rel_path}:{e.lineno or 0}",
            f"file does not parse: {e.msg}", severity="ERROR")]
    linter = _FileLinter(rel_path, source, _import_aliases(tree))
    linter.visit(tree)
    return linter.findings


def lint_file(path: str, root: Optional[str] = None) -> list[Finding]:
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
