"""ctypes binding of the native runtime (`native/src/d3g_native.cpp`).

Port of `dynamic3dgaussians_tpu/native.py`, the same API:

  * `ply_write` / `ply_read`: the binary splat-PLY codec (the 3DGS viewer
    interchange format).
  * `FileLoader`: a threaded read-ahead file cache. `prefetch()` queues
    paths ahead of time, `take()` blocks only if their bytes are not read
    yet, so disk reads overlap the training steps.

At first use the library is built from the C++ source with the flags of
`native/Makefile` (`g++ -O2 -std=c++17 -fPIC -pthread -shared`) into
`build/native/libd3g_native_<hash>.so` at the repository root, the hash
covering the source and the flags; nothing is written under `native/`.
Where it cannot be built (no compiler), the codec falls back to the numpy
writer and reader of `viz/export.py` and the loader to plain reads, and
`available()` says so.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "native" / "src" / "d3g_native.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread", "-shared"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libd3g_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises CalledProcessError / OSError when the compiler fails or is
    missing."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                        str(out), str(SOURCE)], check=True,
                       capture_output=True)
        os.replace(out, lib)   # atomic: a concurrent build sees all or none
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, cp, i32, i64 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                        ctypes.c_int64)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.d3g_ply_write.argtypes = [cp, i64, fp, fp, fp, fp, fp]
    lib.d3g_ply_write.restype = i32
    lib.d3g_ply_read_header.argtypes = [cp, ctypes.POINTER(i32),
                                        ctypes.POINTER(i64)]
    lib.d3g_ply_read_header.restype = i64
    lib.d3g_ply_read_data.argtypes = [cp, i64, i64, i32, fp]
    lib.d3g_ply_read_data.restype = i32
    lib.d3g_loader_create.argtypes = [i32, i64]
    lib.d3g_loader_create.restype = vp
    lib.d3g_loader_destroy.argtypes = [vp]
    lib.d3g_loader_destroy.restype = None
    lib.d3g_loader_prefetch.argtypes = [vp, cp]
    lib.d3g_loader_prefetch.restype = None
    lib.d3g_loader_size.argtypes = [vp, cp]
    lib.d3g_loader_size.restype = i64
    lib.d3g_loader_take.argtypes = [vp, cp, ctypes.POINTER(ctypes.c_uint8),
                                    i64]
    lib.d3g_loader_take.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None where it cannot be."""
    try:
        return _declare(ctypes.CDLL(str(build())))
    except (OSError, subprocess.CalledProcessError):
        return None


def available() -> bool:
    return _load() is not None


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def ply_write(path: str, means, f_dc, logit_opacities, log_scales,
              quats) -> None:
    """Write a binary splat PLY (native, or the numpy writer without the
    library): f_dc the SH DC colour, logit opacities, log scales and
    unnormalised wxyz quaternions."""
    n = np.asarray(means).shape[0]
    cols = [_f32(means), _f32(f_dc), _f32(logit_opacities).reshape(-1),
            _f32(log_scales), _f32(quats)]
    for name, col, shape in zip(
            ("means", "f_dc", "logit_opacities", "log_scales", "quats"),
            cols, ((n, 3), (n, 3), (n,), (n, 3), (n, 4))):
        if col.shape != shape:    # the writer reads exactly these sizes
            raise ValueError(f"ply_write: {name} has shape {col.shape}, "
                             f"expected {shape}")
    lib = _load()
    if lib is None:
        from dynamic3dgaussians_tpu_torch.viz.export import C0, save_ply_splat
        save_ply_splat(path, cols[0], cols[3], cols[4], cols[1] * C0 + 0.5,
                       cols[2])
        return
    rc = lib.d3g_ply_write(path.encode(), n, *map(_ptr, cols))
    if rc != 0:
        raise IOError(f"d3g_ply_write({path}) failed: {rc}")


_PLY_REQUIRED = ("x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "opacity",
                 "scale_0", "scale_1", "scale_2",
                 "rot_0", "rot_1", "rot_2", "rot_3")


def _ply_prop_names(path: str) -> list:
    """The float property names of the ASCII header."""
    names = []
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line or line.startswith(b"end_header"):
                break
            parts = line.decode("ascii", "replace").split()
            if len(parts) == 3 and parts[0] == "property":
                if parts[1] != "float":
                    raise IOError(
                        f"{path}: non-float property {parts[2]!r}; only "
                        "all-float32 splat PLYs are supported")
                names.append(parts[2])
    return names


def ply_read(path: str) -> dict:
    """Read a binary splat PLY -> {means3D, f_dc, logit_opacities,
    log_scales, unnorm_rotations}.

    Columns are found by the header's property names, so any all-float
    layout with the standard 3DGS names reads (extra f_rest_* included); a
    missing required property raises. Without the library the numpy reader
    returns its own keys (rgb_colors in place of f_dc), as in the
    reference.
    """
    names = _ply_prop_names(path)
    missing = [p for p in _PLY_REQUIRED if p not in names]
    if missing:
        raise IOError(f"{path}: PLY lacks required splat properties "
                      f"{missing}; found {names}")
    lib = _load()
    if lib is None:
        from dynamic3dgaussians_tpu_torch.viz.export import load_ply_splat
        return load_ply_splat(path)
    props = ctypes.c_int(0)
    header = ctypes.c_int64(0)
    n = lib.d3g_ply_read_header(path.encode(), ctypes.byref(props),
                                ctypes.byref(header))
    if n < 0:
        raise IOError(f"cannot read {path}")
    if props.value != len(names):
        raise IOError(f"{path}: header/property mismatch "
                      f"({props.value} vs {len(names)})")
    data = np.empty((n, props.value), np.float32)
    rc = lib.d3g_ply_read_data(path.encode(), header.value, n, props.value,
                               _ptr(data))
    if rc != 0:
        raise IOError(f"d3g_ply_read_data({path}) failed: {rc}")
    col = {name: data[:, i] for i, name in enumerate(names)}

    def stack(*ns):
        return np.stack([col[x] for x in ns], axis=-1)

    return {"means3D": stack("x", "y", "z"),
            "f_dc": stack("f_dc_0", "f_dc_1", "f_dc_2"),
            "logit_opacities": col["opacity"][:, None],
            "log_scales": stack("scale_0", "scale_1", "scale_2"),
            "unnorm_rotations": stack("rot_0", "rot_1", "rot_2", "rot_3")}


class FileLoader:
    """Threaded read-ahead byte cache (native; plain reads without the
    library). Each path is taken once: `take` hands its bytes over and
    drops them from the cache."""

    def __init__(self, n_threads: int = 2,
                 cache_limit_bytes: int = 1 << 30):
        self._lib = _load()
        self._h = None
        if self._lib is not None:
            self._h = self._lib.d3g_loader_create(n_threads,
                                                  cache_limit_bytes)

    def prefetch(self, paths: Sequence[str]) -> None:
        if self._h is None:
            return
        for p in paths:
            self._lib.d3g_loader_prefetch(self._h, p.encode())

    def take(self, path: str) -> bytes:
        """The bytes of `path`; blocks until the background read is done."""
        if self._h is None:
            with open(path, "rb") as f:
                return f.read()
        size = self._lib.d3g_loader_size(self._h, path.encode())
        if size < 0:
            raise IOError(f"loader failed to read {path}")
        buf = np.empty(size, np.uint8)
        rc = self._lib.d3g_loader_take(
            self._h, path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size)
        if rc != 0:
            raise IOError(f"loader cache miss for {path}")
        return buf.tobytes()

    def close(self):
        if self._h is not None:
            self._lib.d3g_loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
