"""Nothing of the benchmark imports JAX or the JAX package, comparing each
module's top-level name whole (the port's name begins with the JAX
package's); the reference and the work counters import nothing of the
port either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from harness import bench, device

BENCH = bench.HERE
PORT = "physically_based_renderer_tpu_torch"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    return [p for p in BENCH.joinpath(*parts).rglob("*.py")
            if "tests" not in p.relative_to(BENCH).parts]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & set(device.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_and_the_counters_import_nothing_of_the_port():
    for part in ("reference", "work"):
        for path in _sources(part):
            assert PORT not in _imports(path), path


def test_the_top_level_names_are_compared_whole(monkeypatch):
    import types
    for name in ("jaxfoo", PORT + ".fake", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert device.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "physically_based_renderer_tpu.core",
                        types.ModuleType("x"))
    assert device.forbidden_modules() == ["jax",
                                          "physically_based_renderer_tpu"]


def test_a_run_loads_no_jax_module():
    """Import every module a run imports, in a fresh process."""
    code = ("import sys; sys.path[0:0] = [%r, %r]\n"
            "import harness.runner, harness.scenes, work.hooks, calibrate\n"
            "import physically_based_renderer_tpu_torch.integrator.path\n"
            "import physically_based_renderer_tpu_torch.grad.inverse\n"
            "from harness import device\n"
            "print(device.forbidden_modules())\n"
            % (str(BENCH), str(BENCH.parent)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
