"""Live interactive viewer: a browser orbit client over HTTP, and a client
of the network-GUI protocol.

Port of `dynamic3dgaussians_tpu/viz/live_viewer.py`:

  * `serve(stacked, ...)` serves a stacked params.npz checkpoint to any
    browser: drag to orbit, wheel to zoom, RGB / depth / segmentation /
    centres modes, a timestep scrubber with 20 fps playback, trajectory
    tails. One render per HTTP request (`/`, `/meta`, `/frame?az&el&r&t&
    mode&traj`), JPEG-encoded.
  * `GuiClient` speaks the remote-viewer wire protocol of
    `viz/network_gui.py` to a live training loop; `serve_live` bridges a
    browser to it.

Frames render on the source's device (default `cuda`). On the card,
`CheckpointSource` renders through cached-order playback
(`ops/playback.py`): each timestep keeps a cache, rebuilt after
`resort_every` frames or when the camera moves by more than 5 % of the
scene radius, in a least-recently-used table of at most 4 timesteps. The
HTTP server renders requests on threads of their own, and that table has
no lock, as in the reference (ROADMAP.md §3).
"""

from __future__ import annotations

import io
import json
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.camera import Camera, make_camera
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig
from dynamic3dgaussians_tpu_torch.viz.render import (_np, colormap_depth,
                                                     draw_lines, params_at_t,
                                                     playback_frame,
                                                     render_frame, to_uint8,
                                                     trajectory_lines)

PLAYBACK_CACHES = 4        # timesteps whose playback cache is kept
JUMP_SHARE = 0.05          # camera move, in scene radii, that rebuilds one


def orbit_camera(center, az: float, el: float, radius: float,
                 w: int, h: int, f: float, near: float = 0.01,
                 far: float = 100.0, device: DeviceLike = None) -> Camera:
    """One camera on the orbit sphere looking at `center` (y-down scenes),
    on `device` (default `cuda`)."""
    center = np.asarray(center, np.float64)
    ce, se = np.cos(el), np.sin(el)
    eye = center + radius * np.array([ce * np.cos(az), -se, ce * np.sin(az)])
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-6:  # looking straight down or up
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    up2 = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, fwd, eye
    w2c = np.linalg.inv(c2w)
    k = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    return make_camera(w, h, k, w2c, near, far, device=device)


class CheckpointSource:
    """Renders frames of a stacked params.npz dict on `device` (default
    `cuda`). use_playback None means on when the device is `cuda`."""

    def __init__(self, stacked: Dict[str, np.ndarray],
                 config: Optional[RasterConfig] = None,
                 use_playback: Optional[bool] = None,
                 resort_every: int = 8, device: DeviceLike = None):
        self.stacked = dict(stacked)
        self.config = config
        self.device = resolve_device(device)
        m = np.asarray(stacked["means3D"]).reshape(-1, 3)
        self.center = m.mean(0)
        self.radius = 2.5 * float(np.percentile(
            np.linalg.norm(m - self.center, axis=-1), 90))
        self.num_t = (stacked["means3D"].shape[0]
                      if np.asarray(stacked["means3D"]).ndim == 3 else 1)
        self.use_playback = (self.device.type == "cuda"
                             if use_playback is None else use_playback)
        self.resort_every = resort_every
        self._pb: Dict[int, Dict] = {}
        self.cache_builds = 0

    def meta(self) -> Dict:
        return {"num_timesteps": int(self.num_t),
                "center": [float(c) for c in self.center],
                "radius": float(self.radius)}

    def frame(self, cam: Camera, t: int, mode: str,
              show_traj: bool) -> np.ndarray:
        t = int(np.clip(t, 0, self.num_t - 1))
        pt = params_at_t(self.stacked, t)
        if mode == "centers":
            img = self._centers_image(pt, cam)
        else:
            if self.use_playback and self.resort_every > 1:
                out = self._playback_frame(pt, cam, t)
            else:
                out = render_frame(pt, cam, config=self.config,
                                   device=self.device)
            if mode == "depth":
                img = colormap_depth(out.depth, out.alpha)
            elif mode == "seg" and out.extra is not None:
                img = to_uint8(out.extra[..., :3])
            else:
                img = to_uint8(out.rgb)
        if show_traj and self.num_t > 1:
            segs = trajectory_lines(self.stacked, t)
            if len(segs):
                img = draw_lines(img, segs, cam, color=(255, 40, 40))
        return img

    def _playback_frame(self, pt: Dict, cam: Camera, t: int):
        """Render through timestep t's cached order, rebuilt on age or on a
        camera jump."""
        # pop and re-insert moves the entry to the end: dict order is then
        # least recently used first
        ent = self._pb.pop(t, None)
        cam_c = _np(cam.cam_center)
        if (ent is None or ent["age"] >= self.resort_every
                or np.linalg.norm(cam_c - ent["center"])
                > JUMP_SHARE * self.radius):
            ent = {"cache": None, "center": cam_c, "age": 0}
            self.cache_builds += 1
        out, ent["cache"] = playback_frame(pt, cam, ent["cache"],
                                           config=self.config,
                                           device=self.device)
        self._pb[t] = ent
        while len(self._pb) > PLAYBACK_CACHES:
            self._pb.pop(next(iter(k for k in self._pb if k != t)))
        ent["age"] += 1
        return out

    def _centers_image(self, pt: Dict, cam: Camera) -> np.ndarray:
        """Point view of the gaussian centres, near points painted last."""
        m = np.asarray(pt["means3D"])
        col = np.asarray(pt.get("rgb_colors", np.ones_like(m) * 0.7))
        w2c = _np(cam.w2c)
        p = m @ w2c[:3, :3].T + w2c[:3, 3]
        z = p[:, 2]
        ok = z > float(cam.near)
        x = _np(cam.fx) * p[:, 0] / np.maximum(z, 1e-6) + _np(cam.cx)
        y = _np(cam.fy) * p[:, 1] / np.maximum(z, 1e-6) + _np(cam.cy)
        h, w = cam.height, cam.width
        img = np.zeros((h, w, 3), np.uint8)
        xi, yi = x.astype(int), y.astype(int)
        ok &= (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        order = np.argsort(-z[ok])
        img[yi[ok][order], xi[ok][order]] = np.clip(
            col[ok][order] * 255, 0, 255).astype(np.uint8)
        return img


class GuiClient:
    """Client half of the remote-viewer protocol (`viz/network_gui.py`):
    after connecting, the server sends its render items; each request is a
    length-prefixed JSON camera and options, answered by raw RGB bytes, a
    verify string and metrics."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.render_items = self._read_json()

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return buf

    def _read_json(self):
        n = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(n).decode("utf-8"))

    def _send_json(self, data) -> None:
        payload = json.dumps(data).encode("utf-8")
        self.sock.sendall(struct.pack("I", len(payload)))
        self.sock.sendall(payload)

    def request(self, cam: Camera, render_mode: str = "RGB",
                train: bool = True, scaling_modifier: float = 1.0,
                keep_alive: bool = True):
        """Render `cam` remotely -> ((H, W, 3) uint8, metrics dict).

        The camera goes out in the viewer's convention, which the server's
        `camera_from_viewer` undoes (transposes, y/z column flips). The
        protocol has no length prefix on the image: a server whose render
        returns None sends none, and nothing at all for a zero-resolution
        request. So zero resolutions are refused here, and on a read
        timeout the socket is closed and ConnectionError raised rather
        than reading on from an unknown position (reconnect to go on).
        """
        if cam.width <= 0 or cam.height <= 0:
            raise ValueError("a zero-resolution request gets no reply and "
                             "would desync the protocol")
        w, h = cam.width, cam.height
        fovx = 2.0 * np.arctan(float(cam.tan_fovx))
        fovy = 2.0 * np.arctan(float(cam.tan_fovy))
        vm = np.array(_np(cam.w2c), np.float32).T.copy()
        vp = np.array(_np(cam.full_proj), np.float32).T.copy()
        # the flips of camera_from_viewer are involutions
        vm[:, 1] *= -1
        vm[:, 2] *= -1
        vp[:, 1] *= -1
        self._send_json({
            "resolution_x": int(w), "resolution_y": int(h),
            "train": bool(train), "fov_x": float(fovx), "fov_y": float(fovy),
            "z_near": float(cam.near), "z_far": float(cam.far),
            "keep_alive": bool(keep_alive),
            "scaling_modifier": float(scaling_modifier),
            "view_matrix": [float(v) for v in vm.reshape(-1)],
            "view_projection_matrix": [float(v) for v in vp.reshape(-1)],
            "render_mode": render_mode,
        })
        try:
            img = np.frombuffer(self._read_exact(h * w * 3), np.uint8) \
                .reshape(h, w, 3)
            n = int.from_bytes(self._read_exact(4), "little")
            self._read_exact(n)  # verify string
            metrics = self._read_json()
        except socket.timeout as e:
            self.close()
            raise ConnectionError(
                "viewer stream desynced (server replied without image "
                f"bytes?): {e}") from e
        return img, metrics

    def close(self):
        self.sock.close()


class GuiClientSource:
    """Browser frames rendered by a remote training loop. Cameras are made
    on `device` (default `cuda`) and only serialised."""

    def __init__(self, host: str, port: int, center=(0.0, 0.0, 0.0),
                 radius: float = 4.0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.client = GuiClient(host, port)
        self.center = np.asarray(center, np.float64)
        self.radius = float(radius)
        self.num_t = 1
        self.lock = threading.Lock()

    def meta(self) -> Dict:
        return {"num_timesteps": 1, "center": list(map(float, self.center)),
                "radius": self.radius,
                "render_items": self.client.render_items}

    def frame(self, cam: Camera, t: int, mode: str, show_traj: bool):
        wire_mode = {"rgb": "RGB", "depth": "Depth", "seg": "Segmentation",
                     "centers": "RGB"}.get(mode, mode)
        with self.lock:  # one TCP conversation at a time
            img, _ = self.client.request(cam, render_mode=wire_mode)
        return img


_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>dynamic3dgaussians_tpu_torch viewer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px sans-serif;
     display:flex;flex-direction:column;height:100vh}
#bar{padding:6px 10px;display:flex;gap:12px;align-items:center;
     background:#1c1c1c}
#view{flex:1;display:flex;align-items:center;justify-content:center;
      overflow:hidden}
img{max-width:100%;max-height:100%;cursor:grab}
input[type=range]{width:160px}
select,button{background:#333;color:#ddd;border:1px solid #555}
</style></head><body>
<div id="bar">
 <select id="mode"><option>rgb</option><option>depth</option>
   <option>seg</option><option>centers</option></select>
 <button id="play">play</button>
 <label>t <input id="t" type="range" min="0" max="0" value="0">
   <span id="tv">0</span></label>
 <label><input id="traj" type="checkbox"> trajectories</label>
 <span id="stat"></span>
</div>
<div id="view"><img id="im" draggable="false"></div>
<script>
let az=0.7, el=0.3, r=4.0, t=0, numT=1, playing=false, busy=false,
    dirty=true, center=[0,0,0];
const im=document.getElementById('im'), tv=document.getElementById('tv'),
      tr=document.getElementById('t'), stat=document.getElementById('stat');
fetch('meta').then(r=>r.json()).then(m=>{
  numT=m.num_timesteps; r=m.radius; tr.max=numT-1; dirty=true; });
function url(){
  return 'frame?az='+az.toFixed(4)+'&el='+el.toFixed(4)+
    '&r='+r.toFixed(4)+'&t='+t+'&mode='+mode.value+
    '&traj='+(traj.checked?1:0);}
async function tick(){
  if((dirty||playing)&&!busy){
    busy=true; dirty=false;
    if(playing){t=(t+1)%numT; tr.value=t; tv.textContent=t;}
    const t0=performance.now();
    const b=await fetch(url()).then(r=>r.blob());
    im.src=URL.createObjectURL(b);
    stat.textContent=(performance.now()-t0).toFixed(0)+' ms';
    busy=false;}
  setTimeout(tick, playing?50:16);}   // 20 fps wall-clock playback
tick();
let drag=false,px=0,py=0;
im.addEventListener('mousedown',e=>{drag=true;px=e.clientX;py=e.clientY;});
window.addEventListener('mouseup',()=>drag=false);
window.addEventListener('mousemove',e=>{ if(!drag)return;
  az+=(e.clientX-px)*0.01; el+=(e.clientY-py)*0.01;
  el=Math.max(-1.5,Math.min(1.5,el)); px=e.clientX;py=e.clientY;
  dirty=true;});
im.addEventListener('wheel',e=>{e.preventDefault();
  r*=Math.exp(e.deltaY*0.001); dirty=true;});
document.getElementById('mode').onchange=()=>dirty=true;
document.getElementById('traj').onchange=()=>dirty=true;
tr.oninput=()=>{t=+tr.value; tv.textContent=t; dirty=true;};
document.getElementById('play').onclick=function(){
  playing=!playing; this.textContent=playing?'pause':'play';};
</script></body></html>"""


def _encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    source = None       # set by make_server
    view_w, view_h, view_f = 640, 360, 500.0

    def log_message(self, *a):  # quiet
        pass

    def _reply(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        try:
            u = urlparse(self.path)
            if u.path in ("/", "/index.html"):
                self._reply(200, "text/html", _PAGE.encode())
            elif u.path == "/meta":
                self._reply(200, "application/json",
                            json.dumps(self.source.meta()).encode())
            elif u.path == "/frame":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                cam = orbit_camera(
                    self.source.center, float(q.get("az", 0.0)),
                    float(q.get("el", 0.3)),
                    float(q.get("r", self.source.radius)),
                    self.view_w, self.view_h, self.view_f,
                    device=self.source.device)
                img = self.source.frame(cam, int(q.get("t", 0)),
                                        q.get("mode", "rgb"),
                                        q.get("traj", "0") == "1")
                self._reply(200, "image/jpeg", _encode_jpeg(img))
            else:
                self._reply(404, "text/plain", b"not found")
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 -- the browser sees the error
            self._reply(500, "text/plain", repr(e).encode())


def make_server(source, host: str = "127.0.0.1", port: int = 8000,
                w: int = 640, h: int = 360, f: float = 500.0
                ) -> ThreadingHTTPServer:
    """The HTTP server over `source` (the caller runs serve_forever or
    handle_request, and closes it). port=0 binds a free port."""
    handler = type("Handler", (_Handler,), {
        "source": source, "view_w": w, "view_h": h, "view_f": f})
    return ThreadingHTTPServer((host, port), handler)


def _run(srv: ThreadingHTTPServer) -> None:
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def serve(stacked: Dict[str, np.ndarray], host: str = "127.0.0.1",
          port: int = 8000, config: Optional[RasterConfig] = None,
          w: int = 640, h: int = 360, f: float = 500.0,
          device: DeviceLike = None) -> None:
    """Serve a checkpoint to the browser, rendering on `device` (default
    `cuda`). Blocks until interrupted."""
    srv = make_server(CheckpointSource(stacked, config, device=device),
                      host, port, w, h, f)
    print(f"viewer at http://{host}:{srv.server_address[1]}/  "
          f"(drag orbit, wheel zoom)", flush=True)
    _run(srv)


def serve_live(gui_host: str = "127.0.0.1", gui_port: int = 6009,
               host: str = "127.0.0.1", port: int = 8000,
               center=(0.0, 0.0, 0.0), radius: float = 4.0,
               w: int = 640, h: int = 360, f: float = 500.0,
               device: DeviceLike = None) -> None:
    """Bridge a browser to a live training loop's network GUI. Blocks
    until interrupted."""
    srv = make_server(GuiClientSource(gui_host, gui_port, center, radius,
                                      device=device), host, port, w, h, f)
    print(f"live viewer at http://{host}:{srv.server_address[1]}/ -> gui "
          f"{gui_host}:{gui_port}", flush=True)
    _run(srv)
