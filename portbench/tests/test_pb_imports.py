"""Nothing the benchmark loads is JAX, jaxlib, flax or the JAX package,
compared by whole top-level names (the port's own name begins with the
JAX package's)."""

import ast
import glob
import os
import subprocess
import sys
import types

import pytest

from portbench import manifest, run

ROOT = manifest.root()
# the harness's own files: they reach a trainer, its seeded inputs and its
# reference only through the program a configuration names
HARNESS = ["harness.py", "calibrate.py", "spans.py", "readers.py"] + sorted(
    os.path.relpath(p, manifest.PKG) for kind in ("metrics", "e2e")
    for p in glob.glob(os.path.join(manifest.PKG, kind, "*.py")))
PROGRAM_ONLY = ("portbench.scene", "portbench.reference",
                "portbench.loop.ProgramRun", "portbench.loop.Schedule",
                "dynamic3dgaussians_tpu_torch.train",
                "dynamic3dgaussians_tpu_torch.models")


def imported_names(path):
    """Every module and name that the file at `path` imports, dotted."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dynamic3dgaussians_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dynamic3dgaussians_tpu.ops",
                        types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("z"))
    assert run.forbidden_modules() == ["dynamic3dgaussians_tpu", "jaxlib"]


@pytest.mark.parametrize("name", HARNESS)
def test_the_harness_reaches_the_program_only_through_the_manifest(name):
    found = [m for m in imported_names(os.path.join(manifest.PKG, name))
             if any(m == p or m.startswith(p + ".") for p in PROGRAM_ONLY)]
    assert found == []


def test_a_whole_run_loads_none_of_them():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests.conftest import tiny_run\n"
            "from portbench.run import forbidden_modules\n"
            "import portbench.calibrate\n"
            "r, _ = tiny_run('feat32_t1_window', trace=True)\n"
            "assert r['correct'], r\n"
            "print(forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_it_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sports_t1_window", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert out.returncode == 2
    assert out.stdout == ""
