"""Static analysis for inference graphs and async hot paths (port of
``seldon_core_tpu/analysis/``).

Public surface:

- :func:`lint_graph` / :func:`lint_deployment` — the graph checker
  (structure, shape/dtype signatures, deadline + HBM feasibility,
  per-plane annotation admission, GL16xx trace-lint when torch and the
  port's trace providers are loaded).
- :func:`lint_paths` / :func:`lint_source` / :func:`lint_file` — the
  combined AST repo-lint pass: blocking calls in async functions and
  host-sync ops inside jit'd functions (RL4xx/RL5xx,
  ``analysis/repolint.py``) plus the asyncio concurrency lint
  (RL6xx, ``analysis/asynclint.py``) and the device-ref ownership
  lint (RL7xx, ``analysis/ownlint.py``).
- :func:`lint_registry` — GL16xx signature-registry verification by
  abstract tracing on fake tensors (``analysis/tracelint.py``; imports
  torch).
- :class:`Finding` — one diagnosed defect with a stable code.
- :class:`GraphAnalysisError` — raised by operator admission when a spec
  carries ERROR-severity findings.

CLI: ``python -m seldon_core_tpu_torch.analysis <spec.json | --self>``.
Finding codes and severities are documented in docs/static-analysis.md.
"""

from typing import Iterable, Optional

from seldon_core_tpu_torch.analysis import asynclint as _asynclint
from seldon_core_tpu_torch.analysis import ownlint as _ownlint
from seldon_core_tpu_torch.analysis import repolint as _repolint
from seldon_core_tpu_torch.analysis.findings import (
    ERROR,
    INFO,
    WARN,
    Finding,
    errors,
    make_finding,
    worst_severity,
)
from seldon_core_tpu_torch.analysis.graphlint import (
    GraphAnalysisError,
    lint_deployment,
    lint_graph,
)


def lint_source(source: str, rel_path: str) -> list[Finding]:
    """All repo-lint families (RL4xx/RL5xx + RL6xx + RL7xx) for one
    source."""
    return (_repolint.lint_source(source, rel_path)
            + _asynclint.lint_source(source, rel_path)
            + _ownlint.lint_source(source, rel_path))


def lint_file(path: str, root: Optional[str] = None) -> list[Finding]:
    return (_repolint.lint_file(path, root)
            + _asynclint.lint_file(path, root)
            + _ownlint.lint_file(path, root))


def lint_paths(paths: Iterable[str],
               root: Optional[str] = None) -> list[Finding]:
    """Repo-lint files/directories with every RL family."""
    paths = list(paths)
    return (_repolint.lint_paths(paths, root)
            + _asynclint.lint_paths(paths, root)
            + _ownlint.lint_paths(paths, root))


def lint_registry(model_classes=None) -> list[Finding]:
    """GL16xx: trace-verify the signature registry (imports torch)."""
    from seldon_core_tpu_torch.analysis.tracelint import lint_registry as _impl

    return _impl(model_classes)


__all__ = [
    "ERROR",
    "INFO",
    "WARN",
    "Finding",
    "GraphAnalysisError",
    "errors",
    "lint_deployment",
    "lint_file",
    "lint_graph",
    "lint_paths",
    "lint_registry",
    "lint_source",
    "make_finding",
    "worst_severity",
]
