"""The import rule: nothing the harness loads has the top-level name jax,
jaxlib, flax or lsenerf_tpu (compared whole: lsenerf_tpu_torch begins
with lsenerf_tpu and is the program), and no module of the reference
imports the port."""

from __future__ import annotations

import ast
import subprocess
import sys
import types
from pathlib import Path

from perfbench.harness import env, manifest

BENCH = manifest.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "lsenerf_tpu"}


def _imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imported_tops(path) & FORBIDDEN, path


def test_the_reference_never_imports_the_port():
    for path in (BENCH / "frozen").rglob("*.py"):
        assert "lsenerf_tpu_torch" not in _imported_tops(path), path


def test_a_run_process_loads_no_forbidden_module():
    """Everything a run imports (the harness, the drivers, the readers, the
    port, the frozen reference), in a fresh process: the loaded modules'
    top-level names, compared whole."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.harness import core, manifest, program, session, tracing\n"
        "from perfbench import readings\n"
        "import lsenerf_tpu_torch.engine.loop\n"
        "import lsenerf_tpu_torch.flagship\n"
        "man = manifest.manifest()\n"
        "[manifest.driver(manifest.traffic(w['traffic'])) for w in man['workloads']]\n"
        "[manifest.metric_reader(m['name']) for m in man['per_layer']]\n"
        "[manifest.bound_function(f['bound']) for f in manifest.kernel_families().values()"
        " if f['bound']]\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n" % str(manifest.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "lsenerf_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_process_holds_no_port():
    code = ("import sys, pkgutil, importlib; sys.path.insert(0, %r)\n"
            "import perfbench.frozen as f\n"
            "for m in pkgutil.walk_packages(f.__path__, 'perfbench.frozen.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n" % str(manifest.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "perfbench" in tops and not tops & (FORBIDDEN | {"lsenerf_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lsenerf_tpu_torch_extra", types.ModuleType("x"))
    assert "lsenerf_tpu" not in env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lsenerf_tpu.ops", types.ModuleType("y"))
    assert "lsenerf_tpu" in env.forbidden_modules()
