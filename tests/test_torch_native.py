"""Port parity: the native runtime binding (`native.py`), the splat PLY
codec and the prefetching data loader.

The port builds `native/src/d3g_native.cpp` itself (into
`build/native/`) and binds it with ctypes; these tests mirror
tests/test_native.py against it: the PLY round trip, the PLY bytes against
the JAX package's native writer and the port's numpy writer (identical),
the numpy fallback, `FileLoader` prefetch and take, and
`load_timestep(loader=..., prefetch_next=True)` against `loader=None` and
the JAX `load_timestep`. Every comparison is exact (the codec moves
float32 bytes and the loader hands the same bytes to the same decoder),
except the numpy fallback's f_dc, which goes through rgb and back as in
the reference (atol 1e-6).
"""

import os

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu import native as jnative
from dynamic3dgaussians_tpu.data import dataset as JD
from dynamic3dgaussians_tpu_torch import native
from dynamic3dgaussians_tpu_torch.data import dataset as D
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.viz import export as texp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    # this machine has g++: the port must build its own library
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    return path


def _splats(n, seed):
    rng = np.random.RandomState(seed)
    return dict(means=rng.randn(n, 3).astype(np.float32),
                rgb=rng.rand(n, 3).astype(np.float32),
                op=rng.randn(n, 1).astype(np.float32),
                ls=rng.randn(n, 3).astype(np.float32),
                q=rng.randn(n, 4).astype(np.float32))


def test_ply_round_trip(lib, tmp_path):
    s = _splats(333, 0)
    f_dc = np.random.RandomState(5).randn(333, 3).astype(np.float32)
    p = str(tmp_path / "s.ply")
    native.ply_write(p, s["means"], f_dc, s["op"][:, 0], s["ls"], s["q"])
    back = native.ply_read(p)
    np.testing.assert_array_equal(back["means3D"], s["means"])
    np.testing.assert_array_equal(back["f_dc"], f_dc)
    np.testing.assert_array_equal(back["logit_opacities"], s["op"])
    np.testing.assert_array_equal(back["log_scales"], s["ls"])
    np.testing.assert_array_equal(back["unnorm_rotations"], s["q"])


def test_ply_bytes_match_jax_writer_and_numpy_writer(lib, tmp_path,
                                                    monkeypatch):
    """The JAX package's binding (`native.ply_write`) writes through the
    library the port built from the same source: its own build under
    native/ would race with tests/test_native.py's `make` in another
    worker."""
    monkeypatch.setattr(jnative, "_SO", str(lib))
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.available()
    s = _splats(64, 1)
    f_dc = texp.rgb_to_sh_np(s["rgb"])
    p_port = str(tmp_path / "port.ply")
    p_jax = str(tmp_path / "jax.ply")
    p_np = str(tmp_path / "np.ply")
    native.ply_write(p_port, s["means"], f_dc, s["op"][:, 0], s["ls"],
                     s["q"])
    jnative.ply_write(p_jax, s["means"], f_dc, s["op"][:, 0], s["ls"],
                      s["q"])
    texp.save_ply_splat(p_np, s["means"], s["ls"], s["q"], s["rgb"],
                        s["op"])
    port_bytes = open(p_port, "rb").read()
    assert port_bytes == open(p_jax, "rb").read()
    assert port_bytes == open(p_np, "rb").read()
    # the numpy reader and the native reader of either file agree
    a = texp.load_ply_splat(p_port)
    np.testing.assert_array_equal(a["means3D"], s["means"])
    np.testing.assert_allclose(a["rgb_colors"], s["rgb"], atol=1e-6)
    b = native.ply_read(p_np)
    np.testing.assert_array_equal(b["f_dc"], f_dc)


def test_ply_numpy_fallback_without_library(monkeypatch, tmp_path):
    """Without the library, ply_write goes through the numpy writer, as in
    the reference: the same header and columns, except that f_dc passes
    through rgb = f_dc C0 + 0.5 and back (within 1e-6); ply_read returns
    the numpy reader's columns."""
    s = _splats(40, 2)
    f_dc = texp.rgb_to_sh_np(s["rgb"])
    p_nat, p_fb = str(tmp_path / "nat.ply"), str(tmp_path / "fb.ply")
    native.ply_write(p_nat, s["means"], f_dc, s["op"], s["ls"], s["q"])
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    native.ply_write(p_fb, s["means"], f_dc, s["op"], s["ls"], s["q"])
    nat, fb = open(p_nat, "rb").read(), open(p_fb, "rb").read()
    head = nat.index(b"end_header\n") + len(b"end_header\n")
    assert fb[:head] == nat[:head] and len(fb) == len(nat)
    a = np.frombuffer(nat[head:], "<f4").reshape(40, 17)
    b = np.frombuffer(fb[head:], "<f4").reshape(40, 17)
    f_dc_cols = [6, 7, 8]
    keep = [c for c in range(17) if c not in f_dc_cols]
    np.testing.assert_array_equal(b[:, keep], a[:, keep])
    np.testing.assert_allclose(b[:, f_dc_cols], f_dc, atol=1e-6, rtol=0)
    back = native.ply_read(p_fb)
    np.testing.assert_array_equal(back["means3D"], s["means"])
    np.testing.assert_allclose(back["rgb_colors"], s["rgb"], atol=1e-6)
    with native.FileLoader() as ld:          # plain reads
        assert ld.take(p_fb) == open(p_fb, "rb").read()


def test_ply_read_refuses_missing_properties(lib, tmp_path):
    p = str(tmp_path / "bad.ply")
    with open(p, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
                b"property float x\nend_header\n" + b"\0" * 4)
    with pytest.raises(IOError, match="lacks required"):
        native.ply_read(p)


def test_ply_write_refuses_wrong_shapes(tmp_path):
    """The native writer reads n rows of fixed widths from each column, so
    a column of another shape is refused before any pointer is passed."""
    s = _splats(10, 3)
    with pytest.raises(ValueError, match="quats"):
        native.ply_write(str(tmp_path / "q.ply"), s["means"], s["rgb"],
                         s["op"], s["ls"], s["q"][:, :3])
    with pytest.raises(ValueError, match="logit_opacities"):
        native.ply_write(str(tmp_path / "o.ply"), s["means"], s["rgb"],
                         s["op"][:5], s["ls"], s["q"])
    assert not os.listdir(tmp_path)


def test_file_loader_prefetch_and_take(lib, tmp_path):
    files = []
    for i in range(8):
        fp = str(tmp_path / f"f{i}.bin")
        with open(fp, "wb") as f:
            f.write(bytes([i]) * (4000 + i))
        files.append(fp)
    with open(str(tmp_path / "x.bin"), "wb") as f:
        f.write(b"hello")
    ld = native.FileLoader(n_threads=3, cache_limit_bytes=1 << 20)
    try:
        ld.prefetch(files)
        for i, fp in enumerate(files):
            assert ld.take(fp) == bytes([i]) * (4000 + i)
        # take() without a prefetch: a blocking read
        assert ld.take(str(tmp_path / "x.bin")) == b"hello"
        with pytest.raises(IOError):
            ld.take(str(tmp_path / "missing.bin"))
    finally:
        ld.close()
    ld.close()                                   # a second close is a no-op


class _Recorder:
    """A loader that records the order of prefetches and takes."""

    def __init__(self):
        self.events = []

    def prefetch(self, paths):
        self.events.extend(("prefetch", p) for p in paths)

    def take(self, path):
        self.events.append(("take", path))
        with open(path, "rb") as f:
            return f.read()


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("layout"))
    scene = tsyn.make_gt_scene(n_fg=20, n_bg=40, seed=3)
    tsyn.write_reference_layout(root, "seq", num_t=2, num_cams=3, w=40,
                                h=24, f=30.0, scene=scene, device="cpu")
    return root, "seq", D.load_meta(root, "seq")


def test_load_timestep_prefetches_next_before_decoding(layout):
    root, seq, md = layout
    rec = _Recorder()
    D.load_timestep(root, seq, md, 0, loader=rec, prefetch_next=True,
                    device="cpu")
    nxt = D.timestep_paths(root, seq, md, 1)
    assert rec.events[:len(nxt)] == [("prefetch", p) for p in nxt]
    assert [p for e, p in rec.events[len(nxt):]] == \
        D.timestep_paths(root, seq, md, 0)
    # the last timestep has nothing after it to queue
    rec = _Recorder()
    D.load_timestep(root, seq, md, 1, loader=rec, prefetch_next=True,
                    device="cpu")
    assert all(e == "take" for e, _ in rec.events)


def test_load_timestep_through_loader_matches(lib, layout):
    root, seq, md = layout
    ld = native.FileLoader(n_threads=2)
    try:
        ld.prefetch(D.timestep_paths(root, seq, md, 0))
        for t in range(2):
            via = D.load_timestep(root, seq, md, t, loader=ld,
                                  prefetch_next=True, device="cpu")
            plain = D.load_timestep(root, seq, md, t, device="cpu")
            ref = JD.load_timestep(root, seq, md, t)
            assert len(via) == len(plain) == len(ref) == 3
            for a, b, j in zip(via, plain, ref):
                assert a["cam_id"] == b["cam_id"] == int(j["cam_id"])
                for key in ("im", "seg"):
                    assert torch.equal(a[key], b[key]), key
                    np.testing.assert_array_equal(a[key].numpy(),
                                                  np.asarray(j[key]))
                np.testing.assert_array_equal(a["camera"].w2c.numpy(),
                                              np.asarray(j["camera"].w2c))
    finally:
        ld.close()


def test_build_writes_only_under_build(lib):
    """The port's library lives under build/native, named by the hash of
    the source and flags; nothing is built into native/."""
    assert lib.name.startswith("libd3g_native_") and lib.suffix == ".so"
    assert native.build() == lib                  # already built: reused
    assert os.path.commonpath([str(lib), str(native.REPO / "build")]) == \
        str(native.REPO / "build")
