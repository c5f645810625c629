"""Port parity: the COLMAP and Blender scene readers (`data/colmap.py`).

A COLMAP model written by the test (two camera models, three images with
2D points to skip, points with tracks) goes through both packages' binary
and text readers and `convert_bin_to_txt`; parsing is NumPy on both sides,
so everything is compared exactly: the parsed values, the w2c matrices
built from the quaternions, the nerf++ radius, and the text files byte for
byte.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.data import colmap as JC
from dynamic3dgaussians_tpu_torch.data import colmap as TC

torch.set_num_threads(1)


def _write_bin_model(d, n_pts=7, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48))          # PINHOLE
        f.write(struct.pack("<dddd", 50.0, 51.0, 32.0, 24.0))
        f.write(struct.pack("<iiQQ", 2, 0, 40, 30))          # SIMPLE_PINHOLE
        f.write(struct.pack("<ddd", 33.0, 20.0, 15.0))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 3))
        # names out of order: the readers sort by name
        for iid, name, cam in ((1, "c.jpg", 1), (2, "a.jpg", 2),
                               (3, "b.jpg", 1)):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            t = rng.uniform(-1, 1, 3) + [0, 0, 3]
            f.write(struct.pack("<idddddddi", iid, *q, *t, cam))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddq", 1.0, 2.0, 5) * 2)
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_pts))
        for i in range(n_pts):
            xyz = rng.uniform(-1, 1, 3)
            rgb = rng.randint(0, 256, 3)
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz, *rgb, 0.5))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ii", 1, 0) * 2)


def _same_images(a, b):
    assert [im.name for im in a] == [im.name for im in b]
    for x, y in zip(a, b):
        assert x.camera_id == y.camera_id
        np.testing.assert_array_equal(x.qvec, y.qvec)
        np.testing.assert_array_equal(x.tvec, y.tvec)
        np.testing.assert_array_equal(x.w2c, y.w2c)


def _same_cameras(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert (a[k].model, a[k].width, a[k].height) == \
            (b[k].model, b[k].width, b[k].height)
        np.testing.assert_array_equal(a[k].params, b[k].params)
        np.testing.assert_array_equal(a[k].intrinsics, b[k].intrinsics)


@pytest.fixture()
def model_dir(tmp_path):
    d = str(tmp_path / "sparse" / "0")
    _write_bin_model(d)
    return d


def test_binary_readers_match(model_dir):
    p = lambda f: os.path.join(model_dir, f)          # noqa: E731
    _same_cameras(TC.read_cameras_bin(p("cameras.bin")),
                  JC.read_cameras_bin(p("cameras.bin")))
    _same_images(TC.read_images_bin(p("images.bin")),
                 JC.read_images_bin(p("images.bin")))
    for a, b in zip(TC.read_points3d_bin(p("points3D.bin")),
                    JC.read_points3d_bin(p("points3D.bin"))):
        np.testing.assert_array_equal(a, b)
    assert [im.name for im in TC.read_images_bin(p("images.bin"))] == \
        ["a.jpg", "b.jpg", "c.jpg"]


def test_convert_bin_to_txt_bytes_and_text_readers(model_dir, tmp_path):
    jdir = JC.convert_bin_to_txt(model_dir, str(tmp_path / "j"))
    tdir = TC.convert_bin_to_txt(model_dir, str(tmp_path / "t"))
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(jdir, f), "rb") as a, \
                open(os.path.join(tdir, f), "rb") as b:
            assert a.read() == b.read(), f
    p = lambda f: os.path.join(tdir, f)               # noqa: E731
    _same_cameras(TC.read_cameras_txt(p("cameras.txt")),
                  JC.read_cameras_txt(p("cameras.txt")))
    _same_images(TC.read_images_txt(p("images.txt")),
                 JC.read_images_txt(p("images.txt")))
    for a, b in zip(TC.read_points3d_txt(p("points3D.txt")),
                    JC.read_points3d_txt(p("points3D.txt"))):
        np.testing.assert_array_equal(a, b)
    # reference-side fault, reproduced (ROADMAP.md §3): the writer leaves
    # each image's 2D-points line empty and the reader drops blank lines
    # before taking every other line, so the text round trip keeps images
    # 1, 3, 5, ... of the sorted list
    binary = TC.read_images_bin(os.path.join(model_dir, "images.bin"))
    _same_images(TC.read_images_txt(p("images.txt")), binary[0::2])


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_read_colmap_scene_matches(model_dir, tmp_path, fmt):
    root = os.path.dirname(os.path.dirname(model_dir))
    if fmt == "txt":
        root = str(tmp_path / "txt_root")
        TC.convert_bin_to_txt(model_dir, os.path.join(root, "sparse", "0"))
    t, j = TC.read_colmap_scene(root), JC.read_colmap_scene(root)
    _same_cameras(t.cameras, j.cameras)
    _same_images(t.images, j.images)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.point_colors, j.point_colors)
    assert t.nerf_norm_radius == j.nerf_norm_radius
    np.testing.assert_array_equal(t.nerf_norm_center, j.nerf_norm_center)


def test_w2c_convention_and_nerfpp_norm():
    """qvec (wxyz) -> w2c rotation; centres from the inverse."""
    q = np.array([np.cos(0.3), 0.0, np.sin(0.3), 0.0])
    im = TC.ColmapImage("x", 1, q, np.array([0.5, -1.0, 4.0]))
    r = im.w2c[:3, :3]
    ang = 0.6
    np.testing.assert_allclose(r, [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                                   [-np.sin(ang), 0, np.cos(ang)]],
                               atol=1e-12)
    np.testing.assert_array_equal(
        im.w2c, JC.ColmapImage("x", 1, q, im.tvec).w2c)
    mats = [TC.ColmapImage("x", 1, q, np.array([i, 0.0, 3.0])).w2c
            for i in range(3)]
    for a, b in zip(TC.nerfpp_norm(mats), JC.nerfpp_norm(mats)):
        np.testing.assert_array_equal(a, b)


def test_blender_scene_and_sidecar(tmp_path):
    frames = []
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = [np.cos(i), 0.2 * i, np.sin(i) + 3]
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.69, "w": 64, "frames": frames}, f)
    t = TC.read_blender_scene(str(tmp_path))
    j = JC.read_blender_scene(str(tmp_path))
    _same_cameras(t.cameras, j.cameras)
    _same_images(t.images, j.images)
    np.testing.assert_array_equal(t.points, j.points)
    assert t.nerf_norm_radius == j.nerf_norm_radius

    img = str(tmp_path / "im0.png")
    assert TC.load_semantic_sidecar(img) is None
    np.save(str(tmp_path / "im0.npy"), np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(TC.load_semantic_sidecar(img),
                                  JC.load_semantic_sidecar(img))
