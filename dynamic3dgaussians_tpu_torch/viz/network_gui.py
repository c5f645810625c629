"""Remote-viewer TCP protocol server (the 3DGS / SIBR wire format).

Port of `dynamic3dgaussians_tpu/viz/network_gui.py`, with the same wire
format:

  handshake:  uint32 length + JSON list of render_items
  request:    uint32 length + JSON {resolution_x/y, train, fov_x/y,
              z_near/far, keep_alive, scaling_modifier, view_matrix,
              view_projection_matrix, render_mode}
  response:   raw RGB bytes (H*W*3 uint8), uint32 length + ascii verify
              string, uint32 length + JSON metrics

The camera arrives as view and view-projection matrices, transposed and
with the viewer's y/z sign flips; `camera_from_viewer` turns them into the
port's `Camera`. The render callback is the caller's, so a training loop
can serve live renders between steps.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Callable, List, Optional

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.ops.camera import Camera

DEFAULT_RENDER_ITEMS = ["RGB", "Depth", "Alpha", "Segmentation"]


def camera_from_viewer(width, height, fovx, fovy, znear, zfar,
                       view_matrix, view_projection_matrix,
                       device: DeviceLike = None) -> Camera:
    """Viewer matrices -> Camera on `device` (default `cuda`).

    The viewer sends transposed (row-vector convention) matrices with the
    signs of columns 1 and 2 of the view matrix and column 1 of the
    view-projection matrix flipped.
    """
    dev = resolve_device(device)
    vm = np.asarray(view_matrix, np.float32).reshape(4, 4).copy()
    vp = np.asarray(view_projection_matrix, np.float32).reshape(4, 4).copy()
    vm[:, 1] *= -1
    vm[:, 2] *= -1
    vp[:, 1] *= -1
    w2c = vm.T
    full_proj = vp.T
    fx = width / (2.0 * np.tan(fovx / 2.0))
    fy = height / (2.0 * np.tan(fovy / 2.0))
    c2w = np.linalg.inv(w2c)
    proj = full_proj @ np.linalg.inv(w2c)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return Camera(w2c=t(w2c), proj=t(proj), full_proj=t(full_proj),
                  cam_center=t(c2w[:3, 3]), fx=t(fx), fy=t(fy),
                  cx=t(width / 2), cy=t(height / 2), height=int(height),
                  width=int(width), near=float(znear), far=float(zfar))


class NetworkGUI:
    """Non-blocking render server; call `poll` from the training loop.

    port=0 binds a free port (read `self.port`). `timeout` bounds each
    read and write of a connected viewer (None: wait as long as it
    takes); a viewer that times out is dropped.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 render_items: Optional[List[str]] = None,
                 timeout: Optional[float] = None,
                 device: DeviceLike = None):
        self.render_items = render_items or list(DEFAULT_RENDER_ITEMS)
        self.device = resolve_device(device)
        self.timeout = timeout
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.port = self.listener.getsockname()[1]
        self.conn: Optional[socket.socket] = None

    def _send_json(self, data) -> None:
        payload = json.dumps(data).encode("utf-8")
        self.conn.sendall(struct.pack("I", len(payload)))
        self.conn.sendall(payload)

    def _read_json(self):
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
        except (BlockingIOError, socket.timeout):
            return False
        self.conn.settimeout(self.timeout)
        self._send_json(self.render_items)
        return True

    def poll(self, render_fn: Callable, metrics_fn: Callable = None,
             verify: str = "ok") -> Optional[bool]:
        """Serve one request if a viewer is connected.

        render_fn(camera, render_mode, scaling_modifier) -> (H, W, 3) float
        image in [0, 1] (array or tensor) or None. Returns the request's
        `train` flag, or None when no viewer or request was served.
        """
        if not self.try_connect():
            return None
        try:
            msg = self._read_json()
            width, height = msg["resolution_x"], msg["resolution_y"]
            if width == 0 or height == 0:
                return None
            cam = camera_from_viewer(
                width, height, msg["fov_x"], msg["fov_y"], msg["z_near"],
                msg["z_far"], msg["view_matrix"],
                msg["view_projection_matrix"], device=self.device)
            img = render_fn(cam, msg.get("render_mode", "RGB"),
                            msg.get("scaling_modifier", 1.0))
            if img is not None:
                if isinstance(img, torch.Tensor):
                    img = img.detach().cpu().numpy()
                self.conn.sendall((np.clip(np.asarray(img), 0, 1) * 255)
                                  .astype(np.uint8).tobytes())
            self.conn.sendall(len(verify).to_bytes(4, "little"))
            self.conn.sendall(verify.encode("ascii"))
            self._send_json(metrics_fn() if metrics_fn else {})
            return bool(msg.get("train", True))
        except (ConnectionError, OSError):
            self.conn.close()
            self.conn = None
            return None

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
