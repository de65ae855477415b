"""Nothing a run imports is JAX or the JAX package, and the reference and
the counts import nothing of the program."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "gs2d_tpu"}

RUN = """
import sys
from perfbench import run
rc = run.main(["--workload", sys.argv[1], "--seed", "31", "--seconds", "3"],
              device="cpu", n=1200, scale=0.04)
print(sorted({m.split(".")[0] for m in sys.modules}))
sys.exit(rc)
"""


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_a_run_loads_no_jax():
    for w in ("m360-outdoor.train", "m360-outdoor.render"):
        p = subprocess.run([sys.executable, "-c", RUN, w], cwd=ROOT,
                           capture_output=True, text=True, timeout=300,
                           env={**os.environ, "PYTHONPATH": str(ROOT)})
        assert p.returncode == 0, p.stderr
        loaded = set(json.loads(p.stdout.strip().splitlines()[-1]
                                .replace("'", '"')))
        assert "gs2d_torch" in loaded
        assert not loaded & FORBIDDEN


def test_no_file_of_the_benchmark_imports_jax():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tops = {m.lstrip(".").split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_the_reference_and_the_counts_import_nothing_of_the_program():
    for sub in ("reference", "counts"):
        for path in (ROOT / "perfbench" / sub).rglob("*.py"):
            for m in _imports(path):
                assert not m.startswith("gs2d"), (path, m)
                assert not m.startswith("..") or m in ("..counts",), \
                    (path, m)
