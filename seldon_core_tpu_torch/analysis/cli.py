"""``python -m seldon_core_tpu_torch.analysis`` — the graphlint CLI (port
of ``seldon_core_tpu/analysis/cli.py``, every flag kept).

Two modes:

- ``python -m seldon_core_tpu_torch.analysis spec.json [spec2.json ...]``
  lints inference-graph specs.  A file holding a full SeldonDeployment
  (``kind``/``spec.predictors``) lints every predictor graph with the
  deployment's annotations; a bare graph dict lints standalone
  (``--deadline-ms`` / ``--hbm-gb`` / ``--chips`` supply the budgets a
  bare graph has no annotations for).  ``--plan [on|off]`` forces the
  ``seldon.io/device-plane`` posture so the GL18xx residency
  verification runs in either posture regardless of what the spec says
  (the CI planlint-smoke job lints every example both ways).  Add
  ``--trace`` to import torch and the port's trace providers first,
  activating the gated passes (GL1202, GL16xx trace-lint).

- ``python -m seldon_core_tpu_torch.analysis --self [PATH ...]`` runs the
  repo-lint passes (RL4xx blocking calls, RL5xx host-sync-in-jit, RL6xx
  asyncio races, RL7xx device-ref ownership) over the given
  files/directories, defaulting to the installed port package
  (``seldon_core_tpu_torch/``) — plus the GL16xx signature-registry
  trace verification when torch is importable.

Output: human lines (default), ``--json``, and/or ``--sarif PATH``
(SARIF 2.1.0 with stable rule ids = finding codes and
``relatedLocations`` for multi-location findings, for the GitHub
code-scanning upload in ``.github/workflows/lint.yml``).

Exit status: 1 if any finding at or above ``--fail-on`` (default:
``error``) was emitted, else 0 — wired into ``scripts/lint.sh`` and CI.
``--baseline FILE`` grandfathers a snapshot of known findings: only
findings NOT in the snapshot count toward failure, so a strict gate can
expand to legacy surface without a flag-day cleanup.  Refresh the
snapshot with ``--baseline-write`` after triage.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Optional

from seldon_core_tpu_torch.analysis.findings import (
    CODE_SEVERITY,
    ERROR,
    WARN,
    Finding,
)
from seldon_core_tpu_torch.analysis.graphlint import (
    CHIPS_ANNOTATION,
    HBM_BUDGET_ANNOTATION,
    WALK_DEADLINE_ANNOTATION,
    lint_deployment,
    lint_graph,
)

_SARIF_LEVEL = {"ERROR": "error", "WARN": "warning", "INFO": "note"}
_FILE_LINE = re.compile(r"^(?P<file>[^:]+\.py):(?P<line>\d+)$")


def _lint_spec_file(path: str, extra_ann: dict) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        try:
            spec = json.load(f)
        except ValueError as e:
            from seldon_core_tpu_torch.analysis.findings import (
                SPEC_INVALID,
                make_finding,
            )

            return [make_finding(SPEC_INVALID, path, f"not valid JSON: {e}")]
    if isinstance(spec, dict) and (
            spec.get("kind") == "SeldonDeployment" or "predictors" in
            (spec.get("spec") or {})):
        if extra_ann:
            spec.setdefault("spec", {}).setdefault(
                "annotations", {}).update(extra_ann)
        return lint_deployment(spec)
    return lint_graph(spec, annotations=extra_ann)


def _sarif_location(path: str) -> dict:
    m = _FILE_LINE.match(path)
    if m:
        return {"physicalLocation": {
            "artifactLocation": {"uri": m.group("file").replace(
                os.sep, "/")},
            "region": {"startLine": int(m.group("line"))},
        }}
    # graph findings anchor to a unit path, not a file
    return {"logicalLocations": [
        {"fullyQualifiedName": path, "kind": "member"},
    ]}


def to_sarif(findings: list[Finding]) -> dict:
    """SARIF 2.1.0 log: one run, rule ids = stable finding codes.
    Multi-location findings (``Finding.related`` — e.g. GL1802's first
    and second consumer) carry ``relatedLocations``."""
    results = []
    rule_ids = []
    for f in findings:
        if f.code not in rule_ids:
            rule_ids.append(f.code)
        result = {
            "ruleId": f.code,
            "level": _SARIF_LEVEL.get(f.severity, "note"),
            "message": {"text": f"{f.path}: {f.message}"},
            "locations": [_sarif_location(f.path)],
        }
        if f.related:
            result["relatedLocations"] = [
                dict(_sarif_location(p), message={"text": msg})
                for p, msg in f.related
            ]
        results.append(result)
    rules = [{
        "id": code,
        "defaultConfiguration": {
            "level": _SARIF_LEVEL.get(CODE_SEVERITY.get(code, "INFO"),
                                      "note"),
        },
        "helpUri": "https://github.com/seldon-core-tpu/seldon-core-tpu/"
                   "blob/main/docs/static-analysis.md",
    } for code in rule_ids]
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "seldon-core-tpu-graphlint",
                "informationUri": "https://github.com/seldon-core-tpu/"
                                  "seldon-core-tpu/blob/main/docs/"
                                  "static-analysis.md",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def _baseline_key(f: Finding) -> str:
    """Stable identity of one finding across unrelated edits: code +
    file (line numbers churn with every edit above the finding) +
    message.  Graph findings keep their full unit path."""
    m = _FILE_LINE.match(f.path)
    loc = m.group("file") if m else f.path
    return f"{f.code}|{loc}|{f.message}"


def _load_baseline(path: str) -> dict:
    """Baseline file → key → grandfathered occurrence count."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    counts: dict = {}
    for key in doc.get("findings", []):
        counts[key] = counts.get(key, 0) + 1
    return counts


def _write_baseline(path: str, findings: list[Finding]) -> None:
    doc = {
        "version": 1,
        "tool": "seldon-core-tpu-graphlint",
        "findings": sorted(_baseline_key(f) for f in findings),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")


def _new_findings(findings: list[Finding], baseline: dict) -> list[Finding]:
    """Findings exceeding their grandfathered count — the *new* ones."""
    remaining = dict(baseline)
    fresh = []
    for f in findings:
        key = _baseline_key(f)
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
        else:
            fresh.append(f)
    return fresh


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m seldon_core_tpu_torch.analysis",
        description="static analysis for inference graphs and async "
                    "hot paths",
    )
    ap.add_argument("specs", nargs="*",
                    help="inference-graph or SeldonDeployment JSON files")
    ap.add_argument("--self", dest="self_paths", nargs="*", default=None,
                    metavar="PATH",
                    help="run the repo-lint passes over PATHs (default: the "
                         "seldon_core_tpu_torch package) plus the GL16xx "
                         "signature-registry trace verification")
    ap.add_argument("--trace", action="store_true",
                    help="import torch and the trace providers before "
                         "linting specs so the gated passes (GL1202, "
                         "GL16xx) run")
    ap.add_argument("--plan", nargs="?", const="on", choices=["on", "off"],
                    default=None, metavar="on|off",
                    help="force the seldon.io/device-plane posture so the "
                         "GL18xx plan-residency verification runs (examples "
                         "must be clean in BOTH postures)")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="only findings absent from this snapshot count "
                         "toward --fail-on (grandfather known findings)")
    ap.add_argument("--baseline-write", action="store_true",
                    help="(re)write --baseline FILE from this run's "
                         "findings and exit 0")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help=f"walk deadline for bare graphs "
                         f"({WALK_DEADLINE_ANNOTATION})")
    ap.add_argument("--chips", type=int, default=None,
                    help=f"device count for bare graphs "
                         f"({CHIPS_ANNOTATION})")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help=f"device memory budget (GiB) for bare graphs "
                         f"({HBM_BUDGET_ANNOTATION})")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON array")
    ap.add_argument("--sarif", metavar="PATH", default=None,
                    help="also write findings as SARIF 2.1.0 to PATH "
                         "(for GitHub code scanning)")
    ap.add_argument("--fail-on", choices=["error", "warn"], default="error",
                    help="lowest severity that fails the run")
    args = ap.parse_args(argv)

    if not args.specs and args.self_paths is None:
        ap.error("give spec files and/or --self")

    extra_ann: dict = {}
    if args.deadline_ms is not None:
        extra_ann[WALK_DEADLINE_ANNOTATION] = str(args.deadline_ms)
    if args.chips is not None:
        extra_ann[CHIPS_ANNOTATION] = str(args.chips)
    if args.hbm_gb is not None:
        extra_ann[HBM_BUDGET_ANNOTATION] = str(args.hbm_gb)
    if args.plan is not None:
        from seldon_core_tpu_torch.runtime.device_plane import (
            DEVICE_PLANE_ANNOTATION,
        )

        extra_ann[DEVICE_PLANE_ANNOTATION] = (
            "true" if args.plan == "on" else "false")
    if args.baseline_write and not args.baseline:
        ap.error("--baseline-write needs --baseline FILE")

    if args.trace:
        # activates the gated passes
        import torch  # noqa: F401

        import seldon_core_tpu_torch.models.traceable  # noqa: F401

    findings: list[Finding] = []
    for spec in args.specs:
        findings.extend(_lint_spec_file(spec, extra_ann))
    if args.self_paths is not None:
        from seldon_core_tpu_torch.analysis import lint_paths, lint_registry

        paths = args.self_paths or [os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))]
        findings.extend(lint_paths(paths))
        try:
            findings.extend(lint_registry())
        except ImportError:
            print("graphlint: torch not importable — GL16xx registry "
                  "trace verification skipped", file=sys.stderr)

    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(to_sarif(findings), f, indent=2)
    if args.json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
    if args.baseline and args.baseline_write:
        _write_baseline(args.baseline, findings)
        if not args.json:
            print(f"graphlint: baseline of {len(findings)} finding(s) "
                  f"written to {args.baseline}")
        return 0
    gated = findings
    if args.baseline:
        try:
            baseline = _load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"graphlint: cannot read baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        gated = _new_findings(findings, baseline)
    fail_sevs = (ERROR,) if args.fail_on == "error" else (ERROR, WARN)
    failed = [f for f in gated if f.severity in fail_sevs]
    if not args.json:
        n_err = sum(1 for f in findings if f.severity == ERROR)
        n_warn = sum(1 for f in findings if f.severity == WARN)
        print(f"graphlint: {n_err} error(s), {n_warn} warning(s), "
              f"{len(findings) - n_err - n_warn} info"
              + (f"; {len(gated)} new vs baseline" if args.baseline
                 else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
