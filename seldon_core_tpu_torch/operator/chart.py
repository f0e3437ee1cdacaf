"""Chart renderer: the ``helm template`` subset this repo's charts use
(port of ``seldon_core_tpu/operator/chart.py``).

The chart under ``charts/seldon-core-tpu/`` is a standard helm chart; this
module renders it without the helm binary, for tests, airgapped clusters
and ``python -m seldon_core_tpu_torch.operator.chart`` one-shot installs.
YAML is read by ``utils/yamlite.py`` (the subset the charts use), not
PyYAML.

Supported template syntax (all the chart uses, deliberately no more):

- ``{{ .Values.dot.path }}`` substitution;
- line-level ``{{- if .Values.path }}`` ... ``{{- end }}`` blocks (nestable),
  so toggles like ``gateway.enabled`` / ``crd.create`` actually gate their
  manifests — helm renders the same files identically.

Values come from ``values.yaml``, overridable via ``--set path=value``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Iterable

from seldon_core_tpu_torch.utils import yamlite

_SUB = re.compile(r"\{\{\s*\.Values\.([A-Za-z0-9_.]+)\s*\}\}")
_IF = re.compile(r"^\s*\{\{-?\s*if\s+\.Values\.([A-Za-z0-9_.]+)\s*-?\}\}\s*$")
_END = re.compile(r"^\s*\{\{-?\s*end\s*-?\}\}\s*$")


def load_values(chart_dir: str, overrides: Iterable[str] = ()) -> dict:
    with open(os.path.join(chart_dir, "values.yaml")) as f:
        values = yamlite.safe_load(f.read()) or {}
    for item in overrides:
        path, _, raw = item.partition("=")
        node = values
        keys = path.split(".")
        for k in keys[:-1]:
            nxt = node.get(k)
            if not isinstance(nxt, dict):
                if nxt is not None:
                    raise ValueError(
                        f"--set {item!r}: {'.'.join(keys)} traverses the "
                        f"non-mapping value {nxt!r} at {k!r}"
                    )
                nxt = node[k] = {}
            node = nxt
        try:
            node[keys[-1]] = json.loads(raw)
        except ValueError:
            node[keys[-1]] = raw
    return values


_MISSING = object()


def _lookup(values: dict, path: str, default: Any = _MISSING) -> Any:
    node: Any = values
    for k in path.split("."):
        if not isinstance(node, dict) or k not in node:
            if default is not _MISSING:
                return default
            raise KeyError(f".Values.{path} is not set (chart values.yaml)")
        node = node[k]
    return node


def render_template(text: str, values: dict) -> str:
    def sub(m: re.Match) -> str:
        v = _lookup(values, m.group(1))
        if isinstance(v, bool):
            return "true" if v else "false"
        return str(v)

    out_lines: list[str] = []
    stack: list[bool] = []  # truthiness of each enclosing if-block
    for line in text.splitlines():
        m = _IF.match(line)
        if m:
            # helm semantics: a missing values key is falsey, not an error
            # (substitution of a missing key still raises, matching helm's
            # <no value> hard-fail under --strict)
            stack.append(bool(_lookup(values, m.group(1), default=None)))
            continue
        if _END.match(line):
            if not stack:
                raise ValueError("unbalanced {{ end }} in chart template")
            stack.pop()
            continue
        if all(stack):
            out_lines.append(_SUB.sub(sub, line))
    if stack:
        raise ValueError("unclosed {{ if }} in chart template")
    return "\n".join(out_lines) + ("\n" if text.endswith("\n") else "")


def render_chart(chart_dir: str, overrides: Iterable[str] = ()) -> dict:
    """Render every template; returns {relative_path: rendered_text}."""
    values = load_values(chart_dir, overrides)
    out: dict[str, str] = {}
    tdir = os.path.join(chart_dir, "templates")
    for name in sorted(os.listdir(tdir)):
        if not name.endswith((".yaml", ".yml")):
            continue
        with open(os.path.join(tdir, name)) as f:
            out[name] = render_template(f.read(), values)
    return out


def manifests(chart_dir: str, overrides: Iterable[str] = ()) -> list:
    """Rendered chart as parsed manifest dicts (multi-doc aware)."""
    docs: list = []
    for text in render_chart(chart_dir, overrides).values():
        for doc in yamlite.safe_load_all(text):
            if doc:
                docs.append(doc)
    return docs


def default_chart_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "charts", "seldon-core-tpu",
    )


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="render the seldon-core-tpu chart (helm-template subset)"
    )
    ap.add_argument("--chart", default=default_chart_dir())
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    metavar="path=value")
    args = ap.parse_args(argv)
    for name, text in render_chart(args.chart, args.sets).items():
        print(f"---\n# Source: {name}")
        print(text)


if __name__ == "__main__":
    main()
