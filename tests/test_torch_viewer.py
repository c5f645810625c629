"""Port parity: the live viewer and the network GUI (`viz/live_viewer.py`,
`viz/network_gui.py`, `cli view`).

* `camera_from_viewer` and `orbit_camera` against JAX's: float32 matrices
  within 1e-6 (1e-5 for the projection products), metadata equal.
* `CheckpointSource.frame` in every mode, exact and through playback,
  against JAX's sources: uint8 frames within one level (the depth
  colormap: at most 2 % of the pixels past one level, from its percentile
  stretch; centres and trajectory overlays: equal).
* The playback LRU: age reset on a camera jump, at most 4 timesteps kept,
  least recently used evicted first.
* HTTP `/`, `/meta` and `/frame` of `make_server` on port 0: each decoded
  JPEG equals `CheckpointSource.frame`'s frame JPEG-encoded here.
* A `GuiClient` <-> `NetworkGUI` round trip and the browser bridge over it.
* `cli view` without --params or --gui_host refuses.

Every socket has a timeout; every server runs on a daemon thread and is
shut down in a `finally`.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from dynamic3dgaussians_tpu.ops import rasterize as jrast
from dynamic3dgaussians_tpu.viz import live_viewer as jlv
from dynamic3dgaussians_tpu.viz import network_gui as jng
from dynamic3dgaussians_tpu_torch import cli
from dynamic3dgaussians_tpu_torch.ops import rasterize as trast
from dynamic3dgaussians_tpu_torch.viz import live_viewer as tlv
from dynamic3dgaussians_tpu_torch.viz import network_gui as tng

torch.set_num_threads(1)

TIMEOUT = 30.0
JCFG = jrast.RasterConfig(tile_h=8, tile_w=8, chunk=64,
                          max_tiles_per_gaussian=16)
TCFG = trast.RasterConfig(tile_h=8, tile_w=8, chunk=64,
                          max_tiles_per_gaussian=16)


def _toy_stacked(num_t=3, n=60, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    drift = rng.normal(0, 0.02, (num_t, 1, 3)).astype(np.float32).cumsum(0)
    quats = rng.normal(size=(num_t, n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return {
        "means3D": base[None] + drift,
        "unnorm_rotations": quats,
        "rgb_colors": np.tile(rng.uniform(0, 1, (n, 3)).astype(np.float32),
                              (num_t, 1, 1)),
        "seg_colors": np.stack([
            (np.arange(n) % 2).astype(np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.float32)], -1),
        "logit_opacities": rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.05, 0.12, (n, 3))
                             ).astype(np.float32),
    }


def _np(x):
    return np.asarray(x.cpu()) if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _same_camera(t, j, atol=1e-6):
    for key in ("w2c", "cam_center", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(_np(getattr(t, key)),
                                   np.asarray(getattr(j, key)), atol=atol,
                                   err_msg=key)
    for key in ("proj", "full_proj"):
        np.testing.assert_allclose(_np(getattr(t, key)),
                                   np.asarray(getattr(j, key)), atol=1e-5,
                                   rtol=1e-6, err_msg=key)
    assert (t.width, t.height, t.near, t.far) == (j.width, j.height,
                                                  j.near, j.far)


@pytest.mark.parametrize("az,el", [(0.7, 0.3), (2.0, -0.4), (0.0, 1.5707964)])
def test_orbit_camera_and_camera_from_viewer_match_jax(az, el):
    kw = dict(center=[0.1, -0.2, 0.3], az=az, el=el, radius=3.5, w=40, h=30,
              f=35.0)
    t = tlv.orbit_camera(**kw, device="cpu")
    j = jlv.orbit_camera(**kw)
    _same_camera(t, j)
    rng = np.random.RandomState(1)
    vm, vp = rng.normal(size=16), rng.normal(size=16)
    vm[[0, 5, 10, 15]] += 3.0      # invertible
    args = (40, 30, 0.9, 0.7, 0.02, 50.0, vm.tolist(), vp.tolist())
    _same_camera(tng.camera_from_viewer(*args, device="cpu"),
                 jng.camera_from_viewer(*args))


def _frames_close(a, b, mode):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int16) - b)
    if mode == "depth":
        assert (diff > 1).mean() <= 0.02
    elif mode == "centers":
        np.testing.assert_array_equal(a, b)
    else:
        assert diff.max() <= 1


@pytest.mark.parametrize("playback", [False, True])
def test_checkpoint_source_frames_match_jax(playback):
    stacked = _toy_stacked()
    js = jlv.CheckpointSource(stacked, config=JCFG, use_playback=playback,
                              resort_every=4)
    ts = tlv.CheckpointSource(stacked, config=TCFG, use_playback=playback,
                              resort_every=4, device="cpu")
    assert ts.meta() == js.meta() and ts.num_t == js.num_t == 3
    for i, (az, t) in enumerate([(0.0, 1), (0.03, 1), (0.06, 2),
                                 (2.5, 1)]):
        kw = dict(center=ts.center, az=az, el=0.3, radius=3.0, w=64, h=48,
                  f=50.0)
        tc, jc = tlv.orbit_camera(**kw, device="cpu"), jlv.orbit_camera(**kw)
        for mode in ("rgb", "depth", "seg", "centers"):
            _frames_close(ts.frame(tc, t, mode, i % 2 == 1),
                          js.frame(jc, t, mode, i % 2 == 1), mode)
    if playback:
        assert sorted(ts._pb) == sorted(js._pb) == [1, 2]
        assert ts._pb[1]["age"] == js._pb[1]["age"]


def test_playback_lru_age_reset_and_cap():
    stacked = _toy_stacked(num_t=6)
    src = tlv.CheckpointSource(stacked, config=TCFG, use_playback=True,
                               resort_every=8, device="cpu")
    center = src.center

    def frame(az, t):
        src.frame(tlv.orbit_camera(center, az, 0.3, 3.0, 32, 24, 25.0,
                                   device="cpu"), t, "rgb", False)

    for az in (0.0, 0.01, 0.02):            # small steps: cached frames
        frame(az, 0)
    assert src._pb[0]["age"] == 3 and src.cache_builds == 1
    frame(3.0, 0)                           # a jump rebuilds
    assert src._pb[0]["age"] == 1 and src.cache_builds == 2
    for t in range(1, 6):
        frame(3.0, t)
    assert len(src._pb) == tlv.PLAYBACK_CACHES == 4
    assert list(src._pb) == [2, 3, 4, 5]    # 0 and 1 evicted, LRU first
    frame(3.0, 2)                           # a hit moves 2 to the end
    frame(3.0, 0)
    assert list(src._pb) == [4, 5, 2, 0]
    # age: a cache serves resort_every frames, then rebuilds
    builds = src.cache_builds
    for _ in range(8):
        frame(3.0, 0)
    assert src.cache_builds == builds + 1


@pytest.fixture(scope="module")
def viewer():
    src = tlv.CheckpointSource(_toy_stacked(), config=TCFG, device="cpu")
    srv = tlv.make_server(src, port=0, w=64, h=48, f=50.0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", src
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=TIMEOUT)


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_http_page_and_meta(viewer):
    base, src = viewer
    status, ctype, body = _get(base + "/")
    assert status == 200 and "text/html" in ctype and b"frame?az=" in body
    status, ctype, body = _get(base + "/meta")
    assert status == 200 and ctype == "application/json"
    assert json.loads(body) == json.loads(json.dumps(src.meta()))
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/nothing")
    assert e.value.code == 404


@pytest.mark.parametrize("mode", ["rgb", "depth", "seg", "centers"])
def test_http_frame_every_mode(viewer, mode):
    base, src = viewer
    status, ctype, body = _get(
        base + f"/frame?az=0.7&el=0.3&r=4.0&t=1&mode={mode}&traj=1")
    assert status == 200 and ctype == "image/jpeg", body[:200]
    img = np.asarray(Image.open(io.BytesIO(body)))
    want = src.frame(tlv.orbit_camera(src.center, 0.7, 0.3, 4.0, 64, 48,
                                      50.0, device="cpu"), 1, mode, True)
    assert img.shape == want.shape == (48, 64, 3) and want.any()
    # the same frame, JPEG-encoded here: the reply carries exactly it
    again = np.asarray(Image.open(io.BytesIO(tlv._encode_jpeg(want))))
    np.testing.assert_array_equal(img, again)


def _gui(**kw):
    return tng.NetworkGUI(port=0, timeout=TIMEOUT, device="cpu", **kw)


def _serve_one(gui, render_fn, metrics_fn=None):
    """Poll `gui` on a daemon thread until it served one request (at most
    ~TIMEOUT seconds)."""
    import time
    done = threading.Event()

    def loop():
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            if gui.poll(render_fn, metrics_fn=metrics_fn) is not None:
                done.set()
                return
            time.sleep(0.02)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    return th, done


def test_gui_client_round_trip():
    gui = _gui()
    seen = {}

    def render_fn(cam, render_mode, scaling_modifier):
        seen.update(cam=cam, mode=render_mode, sm=scaling_modifier)
        img = torch.zeros((cam.height, cam.width, 3))
        img[..., 0] = 0.5
        return img

    cam = tlv.orbit_camera([0, 0, 0], az=0.5, el=0.2, radius=3.0, w=32, h=24,
                           f=30.0, device="cpu")
    client = None
    try:
        th, done = _serve_one(gui, render_fn, metrics_fn=lambda: {"it": 7})
        client = tlv.GuiClient(port=gui.port, timeout=TIMEOUT)
        assert client.render_items == tng.DEFAULT_RENDER_ITEMS
        img, metrics = client.request(cam, render_mode="Depth",
                                      scaling_modifier=0.5)
        th.join(timeout=TIMEOUT)
        assert done.is_set()
        with pytest.raises(ValueError):     # would get no reply
            client.request(tlv.orbit_camera([0, 0, 0], 0, 0, 1, 0, 24, 30.0,
                                            device="cpu"))
    finally:
        if client is not None:
            client.close()
        gui.close()
    assert img.shape == (24, 32, 3)
    assert (img[..., 0] == 127).all() and (img[..., 1] == 0).all()
    assert metrics == {"it": 7}
    assert seen["mode"] == "Depth" and seen["sm"] == 0.5
    for key in ("w2c", "full_proj"):
        np.testing.assert_allclose(getattr(seen["cam"], key).numpy(),
                                   getattr(cam, key).numpy(), atol=1e-4)
    assert (seen["cam"].width, seen["cam"].height) == (32, 24)


def test_browser_bridge_over_gui():
    """The serve_live bridge: an HTTP frame request becomes a GUI request
    answered by a render callback."""
    gui = _gui()
    srv = th_http = None
    try:
        th, done = _serve_one(
            gui, lambda cam, mode, sm: np.full((cam.height, cam.width, 3),
                                               0.25, np.float32))
        src = tlv.GuiClientSource("127.0.0.1", gui.port, radius=5.0,
                                  device="cpu")
        assert src.meta()["render_items"] == tng.DEFAULT_RENDER_ITEMS
        srv = tlv.make_server(src, port=0, w=16, h=8, f=10.0)
        th_http = threading.Thread(target=srv.serve_forever, daemon=True)
        th_http.start()
        _, ctype, body = _get(f"http://127.0.0.1:{srv.server_address[1]}"
                              "/frame?az=0&el=0&r=5&mode=rgb")
        th.join(timeout=TIMEOUT)
        assert done.is_set() and ctype == "image/jpeg"
        img = np.asarray(Image.open(io.BytesIO(body)))
        assert img.shape == (8, 16, 3) and np.abs(img.astype(int)
                                                  - 63).max() <= 2
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
            th_http.join(timeout=TIMEOUT)
        gui.close()


def test_cli_view_refuses_without_source():
    with pytest.raises(SystemExit, match="need --params or --gui_host"):
        cli.main(["view", "--device", "cpu"])
