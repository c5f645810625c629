"""The plain reference against the port on the CPU at a tiny size: its
render against the port's plain render, and its first steps against the
port's (the numbers that decide `correct`, far inside the limits)."""

import pytest
import torch

from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig, render
from portbench import check, manifest, scene
from portbench.loop import ProgramRun
from portbench.reference import render as R
from portbench.reference import train as RT
from portbench.tests.conftest import TINY, TINY_FEATURES, Deferred


def _inputs(features=False):
    cfg = dict(manifest.config("panoptic_sports"), **TINY)
    if features:
        cfg.update(TINY_FEATURES)
    return cfg, scene.make(cfg, 99, torch.device("cpu"))


@pytest.mark.parametrize("features", [False, True])
def test_render_matches_the_ports(features):
    cfg, inputs = _inputs(features)
    ref = RT.Reference(inputs, cfg)
    p = ref.params
    rots = RT.normalize(p["unnorm_rotations"])
    chans = [p["rgb_colors"], p["seg_colors"]] + (
        [p["semantic_feature"]] if features else [])
    vals = torch.cat(chans, -1)
    for cam_id in (0, 3):
        kmat, w2c = inputs["mats"][cam_id]
        img, _ = R.render(p["means3D"], torch.exp(p["log_scales"]), rots,
                          torch.sigmoid(p["logit_opacities"][:, 0]), vals,
                          inputs["cams"][cam_id], cfg["k_slots"],
                          cfg["enum_cap"])
        cam = make_camera(cfg["width"], cfg["height"], kmat, w2c,
                          device="cpu")
        out = render(cam, p["means3D"], p["rgb_colors"],
                     torch.sigmoid(p["logit_opacities"][:, 0]),
                     torch.exp(p["log_scales"]), rots,
                     extra_channels=vals[:, 3:], method="torch",
                     config=RasterConfig(max_tiles_per_gaussian=64),
                     device="cpu")
        port = torch.cat([out.rgb, out.extra], -1)
        assert img.shape == port.shape
        assert torch.allclose(img, port, atol=2e-5, rtol=0), \
            float((img - port).abs().max())


def test_first_steps_match_the_ports():
    cfg, inputs = _inputs()
    traffic = manifest.traffic("t1_eager")
    prog = ProgramRun(inputs, cfg, traffic, 99, "cpu",
                      graph_factory=Deferred)
    first = prog.first_steps(3)
    ref = RT.follow(inputs, cfg, first["cams"])
    nums = check.numbers(first, ref)
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-5
    assert nums["change_gap"] < 1e-2


def test_planted_faults_read_large():
    cfg, inputs = _inputs()
    cams = [0, 1, 2]
    truth = RT.follow(inputs, cfg, cams)
    still = check.numbers(RT.follow(inputs, cfg, cams, fault="unchanged"),
                          truth)
    assert still["change_gap"] == pytest.approx(1.0)
    half = check.numbers(RT.follow(inputs, cfg, cams, fault="half_batch"),
                         truth)
    assert half["loss_gap"] > 1e-3
