"""The kernel build (``ops/_build.py``) compiles once when several processes
start together on a fresh checkout (worker processes, test workers): they
serialize on ``build/torch_kernels/.build.lock``, one compiles and the
others load its library.  Held with a stub ``nvcc`` that records its calls
(this machine has no CUDA toolkit).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

STUB = r"""#!{python}
import sys, time
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\n")
time.sleep(0.5)  # a compile takes a while: the other process must wait
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"stub")
"""

BUILD = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
from seldon_core_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
so = _build.build()
print(json.dumps({{"so": str(so), "compiled": _build.build_stats["compiled"]}}))
"""


def test_concurrent_builds_compile_once(tmp_path):
    bindir, build_dir, log = tmp_path / "bin", tmp_path / "build", \
        tmp_path / "nvcc.log"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    env = {**os.environ, "PATH": f"{bindir}{os.pathsep}{os.environ['PATH']}"}
    code = BUILD.format(root=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    sources = sorted((ROOT / "seldon_core_tpu_torch" / "csrc").glob("*.cu"))
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    links = [c for c in calls if "-shared" in c]
    assert len(compiles) == len(sources) and len(links) == 1
    assert sorted(o["compiled"] for o in outs) == [False, True]
    assert outs[0]["so"] == outs[1]["so"] and Path(outs[0]["so"]).exists()
    # a later build finds the library and compiles nothing
    again = subprocess.run([sys.executable, "-c", code, str(build_dir)],
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert json.loads(again.stdout.strip().splitlines()[-1])["compiled"] is \
        False
    assert len(log.read_text().splitlines()) == len(calls)
