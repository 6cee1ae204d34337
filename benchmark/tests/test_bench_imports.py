"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference takes nothing of the program."""

import ast
import os
import subprocess
import sys

from kbench import driver, registry

BENCH = registry.HERE
# the modules that decide correct: they may import neither the program
# nor the JAX package
REFERENCE = ("kbench/reference.py", "kbench/spec.py", "kbench/k1_bound.py",
             "kbench/plugins.py")
# and every pod feature and score plugin the reference loads by name
PLUGIN_DIRS = ("features", "scores")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(driver.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    plugins = [os.path.join(d, f) for d in PLUGIN_DIRS
               for f in sorted(os.listdir(os.path.join(BENCH, d)))
               if f.endswith(".py")]
    assert plugins
    for rel in REFERENCE + tuple(plugins):
        tops = set(_imports(os.path.join(BENCH, rel)))
        assert not tops & {"kubetpu_torch", "kubetpu", "jax"}, (rel, tops)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kubetpu_torch_fake", sys)
    assert "kubetpu" not in driver.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kubetpu.fake", sys)
    assert "kubetpu" in driver.forbidden_modules()


def test_a_run_loads_no_jax():
    """A whole rehearsed run in a fresh process, then its sys.modules."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from kbench import driver, registry\n"
        "out = driver.run_cell(registry.Benchmark(%r), "
        "'k8s5k-default.fill-churn', 3, 0.5, True, 'cpu', time.time(), "
        "shrink=dict(nodes=32, batch_size=16))\n"
        "assert out['correct'], out\n"
        "print('FOUND', driver.forbidden_modules())\n"
        % (BENCH, os.path.dirname(BENCH), os.path.dirname(BENCH)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FOUND []" in p.stdout
