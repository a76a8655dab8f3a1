"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: after a CPU dry run of every cell
at a small size, and in every import statement under portbench/.  Names
are compared by their top-level part (before the first dot), whole."""

import ast
import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.tiny import ROOT_DIR

PORT = "audio_formats_torch"


def _imports(path):
    """Top-level names of every absolute import in a source file."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources():
    for base, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_imports_jax():
    for path in _sources():
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(harness.HERE, "ref")
    for path in _sources():
        if path.startswith(ref + os.sep):
            assert PORT not in _imports(path), path


def test_dry_run_of_every_cell_loads_no_jax():
    cells = [w["name"] for w in harness.load_json("BENCHMARK.json")
             ["workloads"]]
    code = (
        "import json, sys\n"
        "from portbench.tests.tiny import run_tiny\n"
        "from portbench import harness\n"
        f"for cell in {cells!r}:\n"
        "    out = run_tiny(cell, seconds=0.2)\n"
        "    assert harness.passed(out['checks']), (cell, out['checks'])\n"
        "print(json.dumps(sorted({m.split('.', 1)[0]\n"
        "                         for m in sys.modules})))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT_DIR,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": ROOT_DIR})
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert PORT in loaded
    assert not loaded & set(harness.FORBIDDEN)
