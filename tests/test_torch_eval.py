"""Port parity: evaluation (`eval/metrics.py`, `eval/lpips.py`,
`eval/suite.py`, `cli evaluate`, `cli evaluate-suite`).

Every function of `metrics.py` against its JAX counterpart on the same
numpy-seeded inputs; LPIPS on the shared `random_features_params` towers
(equal `state_sha256`), unmasked and masked with a mask whose resize to
the taps differs between torch's "nearest" and "nearest-exact", the weight
loader's checksum gate; the depth row the tile composite receives under
the evaluation's exact depth (exact float32 values, not key buckets); then
`evaluate_sequence`, `evaluate_suite` and both CLI commands against the
JAX package on a written 2-timestep layout.

Tolerances, each with its reason:
* elementwise metrics (masked PSNR in dB, SSIM, depth abs-rel, IoU, PCK,
  the (un)projections): atol 1e-5 -- float32 formulas of the same order,
  the SSIM blur and the sums reassociated; the pose errors (float64 numpy
  in both) 1e-9;
* LPIPS: rel 1e-4 -- five float32 convolutions in other summation orders
  (XLA against PyTorch's CPU kernels);
* evaluation of a layout: PSNR atol 2e-3 dB and SSIM atol 2e-5 -- the
  reference renders through its pure-XLA tiled path and the port through
  its sorted path with exact depth, whose pixels agree to ~1e-6 of a
  JPEG-quantised image.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dynamic3dgaussians_tpu import cli as jcli
from dynamic3dgaussians_tpu.eval import lpips as JLP
from dynamic3dgaussians_tpu.eval import metrics as JM
from dynamic3dgaussians_tpu.eval import suite as JS
from dynamic3dgaussians_tpu_torch import cli
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.eval import lpips as TLP
from dynamic3dgaussians_tpu_torch.eval import metrics as TM
from dynamic3dgaussians_tpu_torch.eval import suite as TS
from dynamic3dgaussians_tpu_torch.viz import export as texp

torch.set_num_threads(1)

ATOL = 1e-5


def _imgs(seed=0, h=24, w=20):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    m = (rng.uniform(0, 1, (h, w)) > 0.4).astype(np.float32)
    return a, b, m


def _poses(seed, n=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = r, rng.normal(size=3)
        out.append(m)
    return np.stack(out)


def _k():
    return np.array([[30.0, 0, 10.5], [0, 31.0, 12.0], [0, 0, 1]],
                    np.float32)


def _both(fn, *args):
    """fn on the JAX side (jnp inputs) and on the port (torch inputs)."""
    j = getattr(JM, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                          else a for a in args])
    t = getattr(TM, fn)(*[torch.as_tensor(a) if isinstance(a, np.ndarray)
                          else a for a in args])
    return t, j


def _cmp(t, j, atol=ATOL):
    if isinstance(t, tuple):
        for a, b in zip(t, j):
            _cmp(a, b, atol)
        return
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), atol=atol, rtol=0)


def _feature_fn(pkg):
    """Two feature maps from fixed channel mixes (no weights needed)."""
    mix = np.random.RandomState(4).normal(size=(3, 5)).astype(np.float32)

    def fn(img):
        if pkg == "jax":
            m = jnp.asarray(mix)
            return [img @ m, (img[::2, ::2] ** 2) @ m]
        m = torch.as_tensor(mix)
        return [img @ m, (img[::2, ::2] ** 2) @ m]
    return fn


@pytest.mark.parametrize("case", [
    "psnr", "psnr_mask", "psnr_mask3", "ssim", "ssim_mask", "pck",
    "pck_each", "mask_iou", "depth_abs_rel", "depth_abs_rel_mask", "ate",
    "rpe", "lpips_feature_fn", "unproject_image", "unproject_image_c2w",
    "reproject_points", "depth_abs_rel_reprojected"])
def test_metrics_match(case):
    a, b, m = _imgs()
    rng = np.random.RandomState(1)
    depth = rng.uniform(1.0, 3.0, a.shape[:2]).astype(np.float32)
    gt_depth = np.where(m > 0, depth + rng.normal(0, 0.1, depth.shape),
                        0.0).astype(np.float32)
    if case == "psnr":
        t, j = _both("masked_psnr", a, b)
    elif case == "psnr_mask":
        t, j = _both("masked_psnr", a, b, m)
    elif case == "psnr_mask3":
        t, j = _both("masked_psnr", a, b, np.repeat(m[..., None], 3, -1))
    elif case == "ssim":
        t, j = _both("masked_ssim", a, b)
    elif case == "ssim_mask":
        t, j = _both("masked_ssim", a, b, m)
    elif case in ("pck", "pck_each"):
        kp = rng.uniform(0, 40, (2, 7, 2)).astype(np.float32)
        kq = (kp + rng.normal(0, 2.0, kp.shape)).astype(np.float32)
        reduce = "mean" if case == "pck" else "none"
        t, j = _both("pck", kq, kp, (40, 30), 0.05, reduce)
        assert 0 < float(np.mean(np.asarray(j))) < 1
    elif case == "mask_iou":
        t, j = _both("mask_iou", a[..., 0], b[..., 0])
    elif case == "depth_abs_rel":
        t, j = _both("depth_abs_rel", depth, gt_depth)
    elif case == "depth_abs_rel_mask":
        t, j = _both("depth_abs_rel", depth, gt_depth, a[..., 1])
    elif case in ("ate", "rpe"):
        p, g = _poses(2), _poses(3)
        t = getattr(TM, case)(p, g)
        j = getattr(JM, case)(p, g)
        _cmp(np.asarray(t), np.asarray(j), atol=1e-9)
        return
    elif case == "lpips_feature_fn":
        j = JM.lpips(jnp.asarray(a), jnp.asarray(b), _feature_fn("jax"))
        t = TM.lpips(torch.as_tensor(a), torch.as_tensor(b),
                     _feature_fn("torch"))
        with pytest.raises(ValueError):
            TM.lpips(torch.as_tensor(a), torch.as_tensor(b))
    elif case == "unproject_image":
        t, j = _both("unproject_image", depth, _k())
    elif case == "unproject_image_c2w":
        t, j = _both("unproject_image", depth, _k(),
                     _poses(5, 1)[0].astype(np.float32))
    elif case == "reproject_points":
        pts = rng.normal(0, 1, (9, 3)).astype(np.float32) + [0, 0, 4]
        w2c = _poses(6, 1)[0].astype(np.float32)
        w2c[:3, :3] = np.eye(3)
        t, j = _both("reproject_points", pts.astype(np.float32), _k(), w2c)
    else:
        t, j = _both("depth_abs_rel_reprojected", depth, gt_depth, _k())
    _cmp(t, j)


# ------------------------------------------------------------------ LPIPS

def _lpips_inputs(h=67, w=83):
    rng = np.random.RandomState(2)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[5:40, 10:70] = 1.0
    mask[::7, :] = 0.0            # thin stripes that resizes disagree on
    return a, b, mask


def test_lpips_state_sha256_matches():
    for seed in (0, 3):
        assert TLP.state_sha256(TLP.random_features_params(seed)) == \
            JLP.state_sha256(JLP.random_features_params(seed))
    assert TLP.state_sha256(TLP.random_features_params(0)) != \
        TLP.state_sha256(TLP.random_features_params(1))


@pytest.mark.parametrize("masked", [False, True])
def test_lpips_fn_matches(masked):
    a, b, mask = _lpips_inputs()
    jnet, tnet = JLP.random_features_params(1), TLP.random_features_params(1)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.as_tensor(mask) if masked else None
    want = float(JLP.lpips_fn(jnet, jnp.asarray(a), jnp.asarray(b), mask=jm))
    with torch.no_grad():
        got = float(TLP.lpips_fn(tnet, torch.as_tensor(a),
                                 torch.as_tensor(b), mask=tm))
        same = float(tnet(torch.as_tensor(a), torch.as_tensor(a), tm))
    assert abs(got - want) <= 1e-4 * abs(want) and want > 0
    assert same < 1e-10
    # each tap of the two towers agrees too
    jf = JLP._features(jnet, jnp.asarray(a))
    tf = tnet.features(torch.as_tensor(a))
    for x, y in zip(tf, jf):
        assert tuple(x.shape) == tuple(y.shape)
        scale = float(np.abs(np.asarray(y)).max())
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                   atol=1e-4 * scale, rtol=0)
    if masked:
        # the taps' sizes make "nearest" and "nearest-exact" disagree on
        # this mask; the port's resize is the reference's
        m = torch.as_tensor(mask)[None, None]
        differ = 0
        for x in tf:
            size = tuple(x.shape[:2])
            near = F.interpolate(m, size=size, mode="nearest")
            exact = F.interpolate(m, size=size, mode="nearest-exact")
            differ += int((near != exact).any())
            ref = jax_resize(mask, size)
            np.testing.assert_array_equal(exact[0, 0].numpy(), ref)
        assert differ >= 1


def jax_resize(mask, size):
    import jax
    return np.asarray(jax.image.resize(jnp.asarray(mask), size, "nearest"))


def _alex_state(net):
    """A torchvision-style state dict (features.<i>.*) of a tower."""
    state = {}
    for i, conv in zip(TLP.TORCHVISION_CONVS, net.convs):
        state[f"features.{i}.weight"] = conv.weight.detach().clone()
        state[f"features.{i}.bias"] = conv.bias.detach().clone() + 0.01 * i
    return state


def test_load_torch_weights_checksum_gate(tmp_path):
    with pytest.raises(RuntimeError, match="unavailable"):
        TLP.load_torch_weights(path=str(tmp_path / "none.pth"))
    path = str(tmp_path / "alex.pth")
    state = _alex_state(TLP.random_features_params(5))
    torch.save(state, path)
    net = TLP.load_torch_weights(path=path)
    digest = TLP.state_sha256(net)
    assert TLP.load_torch_weights(digest, path=path) is not None
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        TLP.load_torch_weights("0" * 64, path=path)
    # the same convolutions through the reference's converter: one digest
    convs = []
    for i, (cout, k, s, p) in zip(TLP.TORCHVISION_CONVS, TLP.ALEX):
        w = state[f"features.{i}.weight"]
        conv = torch.nn.Conv2d(w.shape[1], cout, k, stride=s, padding=p)
        with torch.no_grad():
            conv.weight.copy_(w)
            conv.bias.copy_(state[f"features.{i}.bias"])
        convs.append(conv)
    assert JLP.state_sha256(JLP.from_torch_modules(convs)) == digest
    with pytest.raises(ValueError):
        TLP.from_torch_modules(convs[:4])
    bad = list(convs)
    bad[2] = torch.nn.Conv2d(192, 384, 3, stride=2, padding=1)
    with pytest.raises(ValueError):
        TLP.from_torch_modules(bad)
    # trained heads ride along
    heads = [np.full((c,), 0.5, np.float32) for c, _, _, _ in TLP.ALEX]
    state.update({f"lin{i}.model.1.weight": torch.as_tensor(h)[None, :, None,
                                                                None]
                  for i, h in enumerate(heads)})
    torch.save(state, path)
    net = TLP.load_torch_weights(digest, path=path)
    assert all(float(x.min()) == 0.5 for x in net.lins)


# ------------------------------------------- exact depth into the tile walk

@pytest.mark.parametrize("depth_mode", ["exact", "quantized"])
def test_evaluation_depth_rows_reach_the_tile_composite(monkeypatch,
                                                        depth_mode):
    """The record table handed to the tile composite (the CUDA route hands
    the same table to K1) holds each pair's float32 view depth under the
    evaluation's `depth_mode="exact"`, and bucket depths read back from
    the fused key under the default "quantized"."""
    from dynamic3dgaussians_tpu_torch.ops import sorted_raster as SR
    from dynamic3dgaussians_tpu_torch.ops.camera import make_camera
    from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig
    from dynamic3dgaussians_tpu_torch.viz.render import render_frame
    seen = {}
    prepare, composite = SR.prepare_records, SR.composite_tiles_torch

    def spy_prepare(pairs, table, **kw):
        seen["table"] = table
        seen["n_chan"] = kw["n_chan"]
        return prepare(pairs, table, **kw)

    def spy_composite(rec_t, starts, counts, **kw):
        seen["rec_t"], seen["n_live"] = rec_t, int(counts.sum())
        return composite(rec_t, starts, counts, **kw)

    monkeypatch.setattr(SR, "prepare_records", spy_prepare)
    monkeypatch.setattr(SR, "composite_tiles_torch", spy_composite)
    rng = np.random.RandomState(6)
    n = 300
    q = rng.normal(size=(n, 4)).astype(np.float32)
    params = {"means3D": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
              "rgb_colors": rng.rand(n, 3).astype(np.float32),
              "seg_colors": rng.rand(n, 3).astype(np.float32),
              "unnorm_rotations": q,
              "logit_opacities": rng.normal(0, 1, (n, 1)).astype(np.float32),
              "log_scales": np.full((n, 3), -3.0, np.float32)}
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    # 920 tiles leave the fused key 21 depth bits: a bucket is wider than
    # a float32 ulp of these depths
    cam = make_camera(640, 360, [[400, 0, 320], [0, 400, 180], [0, 0, 1]],
                      w2c, device="cpu")
    render_frame(params, cam, config=RasterConfig(depth_mode=depth_mode),
                 device="cpu")
    row = SR.GEOM_ROWS + seen["n_chan"]
    pair_depth = seen["rec_t"][row, :seen["n_live"]].numpy()
    table_depth = seen["table"][row].numpy()
    member = np.isin(pair_depth, table_depth)
    assert seen["n_live"] > 300
    if depth_mode == "exact":
        assert member.all()
    else:
        assert member.mean() < 0.5


# ----------------------------------------------------- evaluate a layout

NUM_T = 2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-timestep layout and a stacked params.npz of its ground truth,
    moved a little off it so the metrics are not at their ceiling."""
    root = str(tmp_path_factory.mktemp("eval"))
    scene = tsyn.make_gt_scene(n_fg=30, n_bg=60, seed=4)
    tsyn.write_reference_layout(root, "seq", num_t=NUM_T, num_cams=3, w=48,
                                h=32, f=40.0, scene=scene, device="cpu")
    rng = np.random.RandomState(9)
    o = scene["opac"]
    means = np.stack([tsyn.animate(scene, t, NUM_T) for t in range(NUM_T)])
    out = [{"means3D": (means[t] + rng.normal(0, 0.01, means[t].shape))
            .astype(np.float32),
            "rgb_colors": scene["colors"],
            "unnorm_rotations": scene["quats"]} for t in range(NUM_T)]
    out[0].update({
        "seg_colors": np.stack([scene["seg"], 0 * scene["seg"],
                                1 - scene["seg"]], -1).astype(np.float32),
        "logit_opacities": np.log(o / (1 - o))[:, None].astype(np.float32),
        "log_scales": np.log(scene["scales"]).astype(np.float32)})
    path = texp.save_params(out, os.path.join(root, "run"))
    return root, path


def _close_summary(t, j):
    assert set(t) == set(j)
    assert t["n_views"] == j["n_views"]
    assert abs(t["psnr"] - j["psnr"]) <= 2e-3
    assert abs(t["ssim"] - j["ssim"]) <= 2e-5


def test_evaluate_sequence_matches(trained):
    root, path = trained
    stacked = texp.load_params(path)
    tsum, trows = TS.evaluate_sequence(stacked, root, "seq", max_cams=2,
                                       device="cpu")
    jsum, jrows = JS.evaluate_sequence(stacked, root, "seq", max_cams=2)
    _close_summary(tsum, jsum)
    assert tsum["n_views"] == NUM_T * 2 and 20 < tsum["psnr"] < 60
    assert [(r["t"], r["cam"]) for r in trows] == \
        [(r["t"], r["cam"]) for r in jrows]
    for a, b in zip(trows, jrows):
        assert abs(a["psnr"] - b["psnr"]) <= 2e-3
        assert abs(a["ssim"] - b["ssim"]) <= 2e-5


def test_evaluate_suite_matches(trained, tmp_path):
    root, path = trained
    pairs = [("seq", path), ("seq", path)]
    tres = TS.evaluate_suite(pairs, root, max_timesteps=1, max_cams=3,
                             out_path=str(tmp_path / "t.json"), device="cpu")
    jres = JS.evaluate_suite(pairs, root, max_timesteps=1, max_cams=3,
                             out_path=str(tmp_path / "j.json"))
    assert list(tres["scenes"]) == list(jres["scenes"]) == ["seq", "seq#2"]
    assert tres["scenes"]["seq#2"]["params_path"] == path
    for key in tres["scenes"]:
        sub = {k: v for k, v in tres["scenes"][key].items()
               if k != "params_path"}
        _close_summary(sub, {k: v for k, v in jres["scenes"][key].items()
                             if k != "params_path"})
    assert set(tres["mean"]) == set(jres["mean"]) == {"psnr", "ssim"}
    t_file = json.loads((tmp_path / "t.json").read_text())
    j_file = json.loads((tmp_path / "j.json").read_text())
    assert set(t_file) == set(j_file) == {"scenes", "mean", "rows"}
    assert set(t_file["rows"]) == set(j_file["rows"])


def test_cli_evaluate_and_suite_print_reference_json(trained, tmp_path,
                                                     capsys):
    root, path = trained
    common = ["--data_root", root, "--max_timesteps", "2", "--max_cams",
              "2"]
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        out_json = str(tmp_path / f"{name}_eval.json")
        main(["evaluate", "--params", path, "--seq", "seq", "--out",
              out_json] + common + extra)
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        suite_json = str(tmp_path / f"{name}_suite.json")
        main(["evaluate-suite", "--pairs", f"seq={path},seq={path}",
              "--out", suite_json] + common + extra)
        lines = capsys.readouterr().out.strip().splitlines()
        outs[name] = dict(printed=printed,
                          file=json.loads(open(out_json).read()),
                          suite_lines=lines,
                          suite_file=json.loads(open(suite_json).read()))
    t, j = outs["port"], outs["jax"]
    _close_summary(t["printed"], j["printed"])
    assert set(t["file"]) == set(j["file"]) == {"mean_psnr", "mean_ssim",
                                                "rows"}
    assert len(t["file"]["rows"]) == len(j["file"]["rows"]) == 4
    assert [ln.split(":")[0] for ln in t["suite_lines"][:-1]] == \
        [ln.split(":")[0] for ln in j["suite_lines"][:-1]] == ["seq", "seq#2"]
    tl, jl = json.loads(t["suite_lines"][-1]), json.loads(j["suite_lines"][-1])
    assert set(tl) == set(jl) == {"mean", "n_scenes"}
    assert tl["n_scenes"] == jl["n_scenes"] == 2
    assert abs(tl["mean"]["psnr"] - jl["mean"]["psnr"]) <= 2e-3
    assert set(t["suite_file"]) == set(j["suite_file"])
    with pytest.raises(SystemExit):
        cli.main(["evaluate-suite", "--pairs", "seq", "--device", "cpu"]
                 + common)
