"""Port parity: the Shape-of-Motion data tools and the logging extras --
`data/tracks.py`, `data/init_clouds.py`, `data/tools.py`,
`models/gaussians.py::compose_scenes`, `utils/logging.py`'s `phase_timer`
and profiler trace, and `utils/clip_utils.py` -- against the JAX package on
the CPU.

The data tools are numpy (and PIL) in both packages, so their outputs
and the files they write must be bitwise equal, on the inputs of
tests/test_motion_feature.py, tests/test_init_viz.py and
tests/test_priors_features.py. `compose_scenes` concatenates and pads, so
it too is held exactly.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from dynamic3dgaussians_tpu.data import init_clouds as JIC
from dynamic3dgaussians_tpu.data import tools as JTO
from dynamic3dgaussians_tpu.data import tracks as JTR
from dynamic3dgaussians_tpu.models import gaussians as JG
from dynamic3dgaussians_tpu.utils import clip_utils as JCL
from dynamic3dgaussians_tpu_torch.data import init_clouds as TIC
from dynamic3dgaussians_tpu_torch.data import tools as TTO
from dynamic3dgaussians_tpu_torch.data import tracks as TTR
from dynamic3dgaussians_tpu_torch.models import gaussians as TG
from dynamic3dgaussians_tpu_torch.utils import clip_utils as TCL
from dynamic3dgaussians_tpu_torch.utils import logging as TLG

torch.set_num_threads(1)


def _same(a, b):
    """Equal tuples / arrays, dtype included."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- tracks

def _analytic_tracks(t=4, n=80, h=48, w=64):
    """tests/test_motion_feature.py's analytic depth surface, plus tracks
    that leave the image, straddle a depth step and carry occlusion
    flags."""
    rng = np.random.RandomState(0)
    k = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]], np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c2ws, depths = [], []
    for ti in range(t):
        ang = 0.05 * ti
        c, s_ = np.cos(ang), np.sin(ang)
        w2c = np.array([[c, 0, -s_, 0.1 * ti], [0, 1, 0, 0],
                        [s_, 0, c, 0], [0, 0, 0, 1]], np.float32)
        c2ws.append(np.linalg.inv(w2c).astype(np.float32))
        d = (4.0 + 0.01 * xx + 0.02 * yy
             + 0.2 * np.sin(0.1 * xx) * (1 + 0.1 * ti)).astype(np.float32)
        d[:, 40:] -= 1.5                              # an occluder edge
        depths.append(d)
    tracks = np.zeros((n, t, 4), np.float32)
    tracks[..., 0] = rng.uniform(-3, w + 2, (n, t))
    tracks[..., 1] = rng.uniform(1, h - 2, (n, t))
    tracks[:6, :, 0] = 39.5                           # on the step
    tracks[..., 2] = (rng.rand(n, t) < 0.2).astype(np.float32)
    tracks[..., 3] = rng.uniform(0, 1, (n, t))
    return tracks, np.stack(depths), k, np.stack(c2ws)


@pytest.mark.parametrize("channels", [2, 3, 4])
def test_lift_tracks_to_3d_bitwise(channels):
    tracks, depths, k, c2ws = _analytic_tracks()
    tr = tracks[..., :channels]
    out = TTR.lift_tracks_to_3d(tr, depths, k, c2ws)
    _same(out, JTR.lift_tracks_to_3d(tr, depths, k, c2ws))
    vis = out[1]
    assert vis.any() and not vis.all()
    # per-frame intrinsics and other thresholds
    ks = np.stack([k * (1 + 0.01 * i) for i in range(4)])
    ks[:, 2, 2] = 1.0
    kw = dict(occ_threshold=0.3, depth_consistency=0.2, err_scale=2.0)
    _same(TTR.lift_tracks_to_3d(tr, depths, ks, c2ws, **kw),
          JTR.lift_tracks_to_3d(tr, depths, ks, c2ws, **kw))


@pytest.mark.parametrize("num_samples,stride", [(12, 1), (None, 2)])
def test_tracks_from_sequence_files_bitwise(tmp_path, num_samples, stride):
    rng = np.random.RandomState(0)
    names = ["f0", "f1", "f2"]
    t, h, w = 3, 24, 32
    k = np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]], np.float32)
    depths = (5.0 + rng.rand(t, h, w)).astype(np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32)[None], (t, 1, 1))
    for q in names:
        for tn in names:
            arr = np.zeros((7, 4), np.float32)
            arr[:, 0] = rng.uniform(2, w - 3, 7)
            arr[:, 1] = rng.uniform(2, h - 3, 7)
            arr[:, 3] = 0.2
            np.save(tmp_path / f"{q}_{tn}.npy", arr)
    _same(TTR.load_2d_tracks(str(tmp_path), "f1", names),
          JTR.load_2d_tracks(str(tmp_path), "f1", names))
    kw = dict(num_samples=num_samples, query_stride=stride, seed=3)
    out = TTR.tracks_from_sequence(str(tmp_path), names, depths, k, c2ws,
                                   **kw)
    _same(out, JTR.tracks_from_sequence(str(tmp_path), names, depths, k,
                                        c2ws, **kw))
    assert out[0].shape == ((12, 3, 3) if num_samples else (14, 3, 3))


# ------------------------------------------------------------ init clouds

def _depth_frames():
    rng = np.random.RandomState(0)
    h, w, f = 24, 32, 40.0
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    depths, rgbs, ks, w2cs, segs = [], [], [], [], []
    for c in range(2):
        d = np.full((h, w), 2.5) + rng.rand(h, w)
        d[:3] = 0.0                                 # no depth there
        depths.append(d)
        rgbs.append(rng.rand(h, w, 3))
        ks.append(k)
        w2c = np.eye(4)
        w2c[2, 3] = 1.0 + c
        w2cs.append(w2c)
        segs.append((rng.rand(h, w) > 0.5).astype(np.float32))
    return dict(depths=depths, rgbs=rgbs, ks=ks, w2cs=w2cs, segs=segs)


def test_init_cloud_primitives_bitwise():
    fr = _depth_frames()
    for kw in (dict(stride=1), dict(stride=4), dict(stride=3,
                                                     max_depth=3.0)):
        _same(TIC.from_depth_maps(**fr, **kw), JIC.from_depth_maps(**fr,
                                                                   **kw))
    no_seg = {k: v for k, v in fr.items() if k != "segs"}
    _same(TIC.from_depth_maps(**no_seg), JIC.from_depth_maps(**no_seg))
    rng = np.random.RandomState(1)
    base = rng.rand(100, 7).astype(np.float32)
    for factor in (1, 3):
        _same(TIC.densify_with_noise(base, factor, 0.02, seed=4),
              JIC.densify_with_noise(base, factor, 0.02, seed=4))
    ckpt = {"means3D": rng.rand(3, 50, 3), "rgb_colors": rng.rand(3, 50, 3),
            "seg_colors": rng.rand(50, 3)}
    for t in (0, 2):
        _same(TIC.from_checkpoint(ckpt, t), JIC.from_checkpoint(ckpt, t))
    flat = {"means3D": rng.rand(50, 3), "rgb_colors": rng.rand(50, 3)}
    _same(TIC.from_checkpoint(flat), JIC.from_checkpoint(flat))
    _same(TIC.merge_clouds([base, base[:10]]),
          JIC.merge_clouds([base, base[:10]]))
    for m in (40, 200):
        _same(TIC.subsample(base, m, seed=2), JIC.subsample(base, m, seed=2))


@pytest.mark.parametrize("init_type", ["pcd", "noise", "depth",
                                       "checkpoint", "fused"])
def test_build_init_cloud_bitwise(init_type):
    rng = np.random.RandomState(0)
    kw = dict(pt_cld=rng.rand(100, 7).astype(np.float32),
              depth_frames=_depth_frames(),
              checkpoint={"means3D": rng.rand(3, 50, 3),
                          "rgb_colors": rng.rand(3, 50, 3)},
              noise_factor=3, noise_sigma=0.01, max_points=120, seed=5)
    out = TIC.build_init_cloud(init_type, **kw)
    _same(out, JIC.build_init_cloud(init_type, **kw))
    assert out.shape[1] == 7 and out.shape[0] <= 120
    with pytest.raises(ValueError):
        TIC.build_init_cloud("dust")


# ------------------------------------------------------------------ tools

def test_data_tools_bitwise(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    frames = [(rng.rand(16, 16, 3) * 255).astype(np.uint8) for _ in range(4)]
    fdir = tmp_path / "frames"
    os.makedirs(fdir)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(fdir / f"{i:03d}.png")
    (fdir / "notes.txt").write_text("not a frame")
    outs = []
    for pkg, name in ((TTO, "t"), (JTO, "j")):
        out = pkg.frames_to_video(str(fdir), str(tmp_path / f"{name}.gif"),
                                  fps=5, limit=3)
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and len(outs[0]) > 0
    # without imageio: PIL's animated GIF, the extension made .gif
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "imageio.v2", None)
        gifs = [pkg.frames_to_video(str(fdir), str(tmp_path / f"{name}.mp4"),
                                    fps=4)
                for pkg, name in ((TTO, "tf"), (JTO, "jf"))]
    assert [os.path.basename(g) for g in gifs] == ["tf.gif", "jf.gif"]
    assert open(gifs[0], "rb").read() == open(gifs[1], "rb").read()
    assert Image.open(gifs[0]).n_frames == 4
    with pytest.raises(AssertionError):
        TTO.frames_to_video(str(fdir), str(tmp_path / "x.gif"),
                            pattern="nothing")

    np.savez(tmp_path / "p.npz", a=np.zeros((3, 2)), b=np.ones(5),
             c=np.array(["x"]), e=np.zeros(0))
    assert TTO.inspect_npz(str(tmp_path / "p.npz")) == \
        JTO.inspect_npz(str(tmp_path / "p.npz"))

    seq = tmp_path / "root" / "seq"
    os.makedirs(seq)
    md = {"fn": [[f"{c}/{t:06d}.jpg" for c in range(5)] for t in range(3)],
          "w": 64, "h": 48, "k": [], "w2c": []}
    (seq / "train_meta.json").write_text(json.dumps(md))
    assert TTO.inspect_meta(str(tmp_path / "root"), "seq") == \
        JTO.inspect_meta(str(tmp_path / "root"), "seq")

    masks = [np.zeros((16, 16)) for _ in frames]
    masks[0][:8] = 1.0
    masks[1] = np.ones((16, 16, 3))
    stats = []
    for pkg, name in ((TTO, "t"), (JTO, "j")):
        stats.append(pkg.verify_masks(frames, masks,
                                      out_dir=str(tmp_path / f"ov_{name}")))
    assert stats[0] == stats[1] and stats[0]["n"] == 4
    for f in sorted(os.listdir(tmp_path / "ov_j")):
        assert (tmp_path / "ov_t" / f).read_bytes() == \
            (tmp_path / "ov_j" / f).read_bytes()
    assert TTO.verify_masks([], []) == JTO.verify_masks([], [])


# --------------------------------------------------------- compose_scenes

def _toy_params(n, seed):
    """tests/test_train_components.py's toy state: a cloud through the
    reference's init_params, as numpy."""
    rng = np.random.RandomState(seed)
    pt = np.concatenate([
        rng.normal(0, 0.3, (n, 3)), rng.uniform(0, 1, (n, 3)),
        (rng.uniform(size=(n, 1)) < 0.5).astype(np.float32)], axis=-1)
    w2c = np.tile(np.eye(4)[None], (3, 1, 1))
    w2c[:, 2, 3] = [4.0, 5.0, 6.0]
    params, variables = JG.init_params(pt.astype(np.float32), w2c,
                                       capacity=32)
    return ({k: np.array(v) for k, v in params.items()},
            float(variables["scene_radius"]))


@pytest.mark.parametrize("capacity", [None, 64])
def test_compose_scenes_matches(capacity):
    ps, radius = _toy_params(20, 7)
    pd, _ = _toy_params(12, 8)
    stat = {k: v[:20] for k, v in ps.items() if k not in JG.CAMERA_KEYS}
    stat["means3D"] = np.stack([stat["means3D"], stat["means3D"] + 0.1])
    stat["cam_m"] = ps["cam_m"]
    stat["scene_radius"] = np.float32(radius)
    dyn = {k: v[:12] for k, v in pd.items() if k not in ("cam_m",)}
    dyn.pop("seg_colors")                      # kept only if both have it
    jp, jv = JG.compose_scenes(stat, dyn, capacity=capacity)
    tp, tv = TG.compose_scenes(stat, dyn, capacity=capacity, device="cpu")
    assert set(tp) == set(jp) and "seg_colors" not in tp
    for k in jp:
        assert tp[k].dtype == torch.float32, k
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)
    assert set(tv) == set(jv)
    for k in jv:
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]), k)
    cap = capacity or 1024
    assert tp["label"].shape == (cap,) and int(tv["alive"].sum()) == 32
    np.testing.assert_array_equal(tp["label"][:20].numpy(), 0.0)
    np.testing.assert_array_equal(tp["label"][20:32].numpy(), 1.0)
    np.testing.assert_array_equal(tp["means3D"][:20].numpy(),
                                  stat["means3D"][0])
    # the dynamic side's camera table when the static side has none
    stat.pop("cam_c", None)
    tp2, _ = TG.compose_scenes(stat, dyn, device="cpu")
    np.testing.assert_array_equal(tp2["cam_c"].numpy(), dyn["cam_c"])
    # tensors are taken as they are
    tp3, _ = TG.compose_scenes({k: torch.as_tensor(v) for k, v in
                                stat.items()}, dyn, device="cpu")
    np.testing.assert_array_equal(tp3["means3D"].numpy(),
                                  tp2["means3D"].numpy())


# ---------------------------------------------------------------- logging

def test_phase_timer_logs_and_syncs(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d))
    log = {}
    with TLG.phase_timer("a", log=log) as pt:
        time.sleep(0.02)
    assert log["a"] == pt.dt and 0.02 <= pt.dt < 5.0
    # a CPU tensor needs no wait
    with TLG.phase_timer("b", sync={"x": [torch.ones(2)]}, log=log):
        pass
    assert "b" in log and synced == []


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    prof = TLG.start_profiler_trace(str(tmp_path))
    torch.ones(64, 64) @ torch.ones(64, 64)
    TLG.stop_profiler_trace(prof)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as fh:
        assert "traceEvents" in json.load(fh)


# ------------------------------------------------------------------- CLIP

def test_clip_encoders_raise_without_a_checkpoint(tmp_path, monkeypatch):
    """No checkpoint on disk: a clean RuntimeError, and nothing fetched
    (the checkpoint is read with local_files_only; the hub is also set
    offline here)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    for name in (str(tmp_path / "missing"), str(tmp_path)):
        with pytest.raises(RuntimeError, match="CLIP"):
            TCL.make_clip_encoders(name)


def test_similarity_map_matches():
    rng = np.random.RandomState(0)
    fm = rng.normal(size=(6, 7, 16)).astype(np.float32)
    fm[0, 0] = 0.0
    t = rng.normal(size=(16,)).astype(np.float32)
    _same(TCL.similarity_map(fm, t), JCL.similarity_map(fm, t))
    assert np.all(np.abs(TCL.similarity_map(fm, t)) <= 1.0 + 1e-6)
