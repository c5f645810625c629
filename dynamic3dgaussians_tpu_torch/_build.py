"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources under `csrc/` have a plain `extern "C"` interface, so they build
without PyTorch's headers in seconds: each `.cu` is compiled by its own
`nvcc` process (all started together), then linked into one shared library
`build/kernels/libd3g_torch_<hash>.so` at the repository root. The hash
covers every source, header and flag, so an edited kernel rebuilds and an
unchanged one is loaded from the previous build. Nothing is built at import:
the first kernel launch calls `load_library()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message holds its output."""


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (set NVCC or CUDA_HOME, or put nvcc on PATH); the "
        "CUDA kernels build only on a machine with the CUDA toolkit")


def _sources() -> Tuple[List[Path], List[Path]]:
    cu = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    if not cu:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    return cu, headers


def _digest(files: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Tuple[Path, str]:
    """Compile the sources if needed; return (library path, ptxas report).

    The report is nvcc's `-Xptxas -v` output (registers, shared memory,
    spills per kernel); it is empty when the library was already built.
    """
    cu, headers = _sources()
    lib = BUILD_DIR / f"libd3g_torch_{_digest(cu + headers)}.so"
    if lib.exists():
        return lib, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            report.append(out)
            if proc.returncode != 0:
                failed.append(f"--- nvcc {src.name} (rc {proc.returncode})"
                              f"\n{out}")
        if failed:
            raise KernelBuildError("\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"--- nvcc link (rc {link.returncode})\n"
                                   f"{link.stdout}")
        os.replace(tmp_lib, lib)   # atomic: a concurrent loader sees all or
    return lib, "".join(report)    # nothing


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library, with argument types declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    lib.d3g_raster_fwd.argtypes = [vp, i64, i32, vp, vp, i32, i32, i32, i32,
                                   i32, i32, vp, vp, vp, vp, vp]
    lib.d3g_raster_fwd.restype = i32
    lib.d3g_raster_bwd.argtypes = [vp, i64, i32, vp, vp, vp, vp, vp, i32, i32,
                                   i32, i32, i32, i32, vp, vp, vp, vp]
    lib.d3g_raster_bwd.restype = i32
    lib.d3g_sol_probe.argtypes = [vp, i64, i32, i32, vp, vp]
    lib.d3g_sol_probe.restype = i32
    emit_common = [vp] * 8 + [i32] * 8 + [f32] * 7 + [i32]
    lib.d3g_emit_count.argtypes = emit_common + [vp] * 4
    lib.d3g_emit_count.restype = i32
    lib.d3g_emit_write.argtypes = emit_common + [vp] * 3 + [i32] + [vp] * 6
    lib.d3g_emit_write.restype = i32
    lib.d3g_emit_math.argtypes = [vp, i64, i32, vp, vp]
    lib.d3g_emit_math.restype = i32
    physics_common = [vp] * 8 + [i32] * 3
    lib.d3g_physics_fwd.argtypes = physics_common + [vp] * 8
    lib.d3g_physics_fwd.restype = i32
    lib.d3g_physics_bwd.argtypes = physics_common + [i32] + [vp] * 12
    lib.d3g_physics_bwd.restype = i32
    lib.d3g_unsort_sum.argtypes = [vp, vp, i64] + [i32] * 5 + [vp] * 6
    lib.d3g_unsort_sum.restype = i32
    lib.d3g_mark_launch.argtypes = [i32, vp]
    lib.d3g_mark_launch.restype = i32
    lib.d3g_view_mark_launch.argtypes = [i32, vp]
    lib.d3g_view_mark_launch.restype = i32
    lib.d3g_error_string.argtypes = [i32]
    lib.d3g_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.d3g_error_string(err).decode()}")
