"""The port's repo lints (RL4xx-RL7xx, ``seldon_core_tpu_torch/analysis/``
``repolint.py``, ``asynclint.py``, ``ownlint.py``) against the reference's.

The rules, messages and pragmas are the reference's, so on one source
text the two packages' findings must be EQUAL in code, severity, path and
message:

- over every ``*.py`` file of ``seldon_core_tpu/`` and of
  ``seldon_core_tpu_torch/``, read as text;
- over every planted source snippet of the reference's own RL tests
  (``tests/test_analysis.py``, ``test_analysis_asynclint.py``,
  ``test_analysis_ownlint.py``: each string constant there that holds a
  ``def`` and parses), so each planted defect is its own case.

Then the port's own idiom: a use-after-consume and a leaked lane written
against ``runtime/device_registry.py`` come out as RL701 and RL704, and
the registry still has the method names RL7xx matches receivers by.
"""

import ast
import os
import textwrap

import pytest

from seldon_core_tpu.analysis import lint_source as ref_lint_source
from seldon_core_tpu_torch.analysis import lint_source
from seldon_core_tpu_torch.analysis.findings import (
    REF_DOUBLE_CONSUME,
    REF_NO_DOWNGRADE_PATH,
    REF_USE_AFTER_CONSUME,
    SHM_LANE_NOT_CLOSED,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(findings):
    return [(f.code, f.severity, f.path, f.message, f.related)
            for f in findings]


def _sources():
    out = []
    for pkg in ("seldon_core_tpu", "seldon_core_tpu_torch"):
        for dirpath, dirnames, files in os.walk(os.path.join(ROOT, pkg)):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            out += [os.path.relpath(os.path.join(dirpath, f), ROOT)
                    for f in sorted(files) if f.endswith(".py")]
    return out


def _planted():
    """(id, source) of every planted snippet of the reference's RL tests."""
    out = []
    for name in ("test_analysis.py", "test_analysis_asynclint.py",
                 "test_analysis_ownlint.py"):
        with open(os.path.join(ROOT, "tests", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and "def " in node.value):
                continue
            src = textwrap.dedent(node.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out.append((f"{name}:{node.lineno}", src))
    return sorted(out)


SOURCES = _sources()
PLANTED = _planted()


@pytest.mark.parametrize("rel", SOURCES)
def test_findings_equal_over_every_source_file(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        text = f.read()
    assert _rows(lint_source(text, rel)) == _rows(
        ref_lint_source(text, rel))


@pytest.mark.parametrize("case", [c[0] for c in PLANTED])
def test_findings_equal_on_every_planted_snippet(case):
    src = dict(PLANTED)[case]
    assert _rows(lint_source(src, "mod.py")) == _rows(
        ref_lint_source(src, "mod.py"))


def test_planted_snippets_cover_every_rl_family():
    codes = {f.code for _, src in PLANTED for f in lint_source(src, "mod.py")}
    for family in ("RL4", "RL5", "RL6", "RL7"):
        assert any(c.startswith(family) for c in codes), family
    assert len(PLANTED) >= 40


# ---- the port's own idiom (runtime/device_registry.py) ---------------------

USE_AFTER_CONSUME = """
    from seldon_core_tpu_torch.runtime.device_registry import registry

    def hop(t):
        ref = registry.put(t)
        try:
            out = registry.resolve(ref)
            again = registry.resolve(ref)
        except KeyError:
            return None
        return out, again
"""

LEAKED_LANE = """
    from seldon_core_tpu_torch.runtime.device_registry import (
        DeviceBufferRegistry,
    )

    def pump(frames):
        reg = DeviceBufferRegistry()
        lane = reg.channel()
        for f in frames:
            lane.put(f)
"""

DOUBLE_CONSUME = """
    from seldon_core_tpu_torch.runtime.device_registry import registry

    def maybe(t, flag):
        ref = registry.put_shm(t)
        try:
            if flag:
                registry.resolve(ref)
            return registry.resolve(ref)
        except KeyError:
            return None
"""

NO_DOWNGRADE = """
    def serve(self, ref):
        return self._registry.resolve(ref)
"""

CLOSED_LANE = """
    from seldon_core_tpu_torch.runtime.device_registry import registry

    def pump(frames):
        lane = registry.channel()
        try:
            for f in frames:
                lane.put(f)
        finally:
            lane.close()
"""


@pytest.mark.parametrize("src,code", [
    (USE_AFTER_CONSUME, REF_USE_AFTER_CONSUME),
    (LEAKED_LANE, SHM_LANE_NOT_CLOSED),
    (DOUBLE_CONSUME, REF_DOUBLE_CONSUME),
    (NO_DOWNGRADE, REF_NO_DOWNGRADE_PATH),
    (CLOSED_LANE, None),
], ids=["rl701", "rl704", "rl702", "rl703", "closed-lane-quiet"])
def test_planted_defects_in_the_ports_idiom(src, code):
    src = textwrap.dedent(src)
    got = [f.code for f in lint_source(src, "mod.py")]
    assert got == ([code] if code else [])
    assert _rows(lint_source(src, "mod.py")) == _rows(
        ref_lint_source(src, "mod.py"))


def test_registry_api_still_matches_the_receiver_names():
    """RL7xx matches receivers by name: ``put``/``put_shm`` mint, ``resolve``
    consumes, ``channel`` acquires a lane that ``close`` releases."""
    from seldon_core_tpu_torch.runtime.device_registry import (
        DeviceBufferRegistry,
        ShmChannel,
    )

    for name in ("put", "put_shm", "resolve", "channel"):
        assert callable(getattr(DeviceBufferRegistry, name)), name
    for name in ("put", "close"):
        assert callable(getattr(ShmChannel, name)), name
