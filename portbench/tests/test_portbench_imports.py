"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick imports nothing of the program.

Module names are compared by their top-level name as a whole: the port's
package name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

import pytest

from portbench.tests.conftest import ROOT, SEED

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = "repro_torch"
# the yardstick: generator, reference, work counts, traces, metric readers
YARDSTICK = ["corpus.py", "reference.py", "work.py", "trace.py", "judge.py", "metrics"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files(*parts):
    base = ROOT / "portbench"
    for p in parts:
        path = base / p
        yield from (sorted(path.rglob("*.py")) if path.is_dir() else [path])


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {str(f): sorted(set(_imports(f)) & FORBIDDEN) for f in _files(".")}
    assert not {f: b for f, b in bad.items() if b}


def test_the_yardstick_imports_nothing_of_the_program():
    bad = [str(f) for f in _files(*YARDSTICK) if PROGRAM in set(_imports(f))]
    assert not bad


def test_whole_name_comparison():
    from portbench.harness import FORBIDDEN as names

    assert "repro_torch".split(".")[0] not in names and "repro" in names


def test_a_run_loads_neither():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from portbench.tests import conftest
from portbench import harness
conftest.pytest = None
cfg, wl = harness.configuration, harness.workload
harness.configuration = lambda n: dict(cfg(n), **conftest.TINY_CONFIG)
harness.workload = lambda n: (lambda w: w["traffic"].update(check_span=2) or w)(wl(n))
harness.run_cell("nq.batch-search", {SEED}, 0.5, False, device="cpu")
print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_a_module_loaded_in_the_check_refuses_the_run(tiny, monkeypatch):
    """The look for JAX comes after the check, which runs program code too."""
    mod = tiny.traffic("batch_search")
    orig = mod.check

    def check(state, ctx):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig(state, ctx)

    monkeypatch.setattr(mod, "check", check)
    with pytest.raises(tiny.Refused, match="jax"):
        tiny.run_cell("nq.batch-search", SEED, 0.5, False, device="cpu")
