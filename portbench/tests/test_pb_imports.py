"""Nothing the benchmark loads is JAX, jaxlib, flax or the JAX package,
compared by whole top-level names (the port's own name begins with the
JAX package's)."""

import subprocess
import sys
import types

from portbench import manifest, run

ROOT = manifest.root()


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dynamic3dgaussians_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dynamic3dgaussians_tpu.ops",
                        types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("z"))
    assert run.forbidden_modules() == ["dynamic3dgaussians_tpu", "jaxlib"]


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
