"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``icpflow_tpu_torch`` is not ``icpflow_tpu``."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import pytest

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "icpflow_tpu"}
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def _imported_tops(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"run.py", "harness.py", "engine.py", "scenes.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not (_imported_tops(path) & FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((BENCH_DIR / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = _imported_tops(path)
    assert not {t for t in tops if t.startswith("icpflow")}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch"}


def test_top_level_names_are_compared_whole():
    from benchmark.harness import forbidden_modules
    assert "icpflow_tpu_torch" not in forbidden_modules()


def test_no_forbidden_module_after_a_run(tmp_path):
    """A whole small run on the CPU in a fresh process (window, readers and
    reference), then sys.modules."""
    code = f"""
import json, pathlib, sys
sys.path.insert(0, {str(BENCH_DIR.parent)!r})
sys.path.insert(0, {str(BENCH_DIR / "tests")!r})
from conftest import make_small_root
from benchmark import harness
root = make_small_root(pathlib.Path({str(tmp_path)!r}))
out = harness.run_cell("av2_pairs.sparse", 5, 0.5, False, "cpu", root=root)
print(json.dumps([harness.forbidden_modules(),
                  sorted(m for m in sys.modules if m.startswith("icpflow"))]))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr[-3000:]
    after, ours = json.loads(res.stdout.strip().splitlines()[-1])
    assert after == []
    assert "icpflow_tpu_torch" in ours


def test_a_module_loaded_after_the_window_withholds_the_line(monkeypatch,
                                                              capsys):
    """run.py looks at sys.modules only once the run, the readers and the
    reference included, is over: a module loaded by any of them stops the
    line."""
    import types

    import torch

    from benchmark import harness, run

    def fake_run_cell(*args, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"line": {"correct": True, "check": {}}}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", fake_run_cell)
    monkeypatch.setattr(run, "_pin", lambda: None)
    monkeypatch.setattr(run, "_set_env", lambda: None)
    rc = run.main(["--workload", "av2_pairs.sparse", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert rc == 3 and captured.out == ""
    assert "jax" in captured.err
