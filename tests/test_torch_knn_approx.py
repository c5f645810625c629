"""Port parity: Morton codes and the approximate k-NN (`knn_method="approx"`).

`morton_codes` against the JAX package bitwise on every grid of
`knn_approx` (points clipped at both ends of the box included), then
`knn_approx` against JAX's on draws whose valid points have distinct Morton
codes on every grid used (asserted: the reference's sorts are unstable, the
port's stable, so equal codes may meet different candidates): the same
found pattern, squared distances within atol 1e-6 (the candidate distance
has the reference's order of operations, but XLA may contract its
multiply-adds), the same neighbours where the distances of a row are
separated, and the same recall against exact `knn`. Then the post-t0 graph
with `knn_method="approx"` in both packages, and a port run whose t > 0
steps use that graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu.data import synthetic as jsyn
from dynamic3dgaussians_tpu.models import gaussians as JG
from dynamic3dgaussians_tpu.ops import knn as jknn
from dynamic3dgaussians_tpu.train import config as jconf
from dynamic3dgaussians_tpu.train import optim as jopt
from dynamic3dgaussians_tpu.train import trainer as jtr
from dynamic3dgaussians_tpu_torch import convert
from dynamic3dgaussians_tpu_torch.data import synthetic as tsyn
from dynamic3dgaussians_tpu_torch.ops import knn as tknn
from dynamic3dgaussians_tpu_torch.train import config as tconf
from dynamic3dgaussians_tpu_torch.train import trainer as ttr

torch.set_num_threads(1)

ATOL_D = 1e-6


def _box(pts, mask):
    sel = pts if mask is None else pts[mask]
    return sel.min(0), sel.max(0)


@pytest.mark.parametrize("grid", range(len(tknn.GRIDS)))
def test_morton_codes_match(grid):
    rng = np.random.RandomState(grid)
    pts = rng.normal(0, 1, (4000, 3)).astype(np.float32)
    lo, hi = _box(pts[:3000], None)       # the rest partly outside the box
    shift, order = tknn.GRIDS[grid]
    want = np.asarray(jknn.morton_codes(jnp.asarray(pts), jnp.asarray(lo),
                                        jnp.asarray(hi), shift=shift,
                                        order=order))
    got = tknn.morton_codes(torch.as_tensor(pts), torch.as_tensor(lo),
                            torch.as_tensor(hi), shift=shift, order=order)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 3000


def _distinct_codes(pts, mask, grids):
    lo, hi = _box(pts, mask)
    sel = pts if mask is None else pts[mask]
    for g in range(grids):
        shift, order = tknn.GRIDS[g % len(tknn.GRIDS)]
        code = tknn.morton_codes(torch.as_tensor(sel), torch.as_tensor(lo),
                                 torch.as_tensor(hi), shift=shift,
                                 order=order).numpy()
        if len(np.unique(code)) != len(code):
            return False
    return True


def _recall(idx, exact, rows):
    hits = sum(len(set(idx[r][idx[r] >= 0]) & set(exact[r][exact[r] >= 0]))
               for r in rows)
    return hits / max(sum(int((exact[r] >= 0).sum()) for r in rows), 1)


def _separated(d, tol=1e-5):
    gaps = np.diff(d, axis=1)
    return (gaps > tol * np.maximum(d[:, 1:], 1e-12)).all(axis=1)


@pytest.mark.parametrize("masked,grids,window,k", [
    (False, 2, 32, 20), (True, 2, 32, 20), (True, 1, 8, 6),
    (False, 4, 16, 10)])
def test_knn_approx_matches(masked, grids, window, k):
    rng = np.random.RandomState(7 + grids)
    n = 1500
    pts = rng.normal(0, 1, (n, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, n) > 0.3 if masked else None
    assert _distinct_codes(pts, mask, grids)
    jd, ji = jknn.knn_approx(jnp.asarray(pts), k, window=window, grids=grids,
                             mask=None if mask is None else jnp.asarray(mask))
    td, ti = tknn.knn_approx(torch.as_tensor(pts), k, window=window,
                             grids=grids, mask=None if mask is None
                             else torch.as_tensor(mask))
    jd, ji, td, ti = map(np.asarray, (jd, ji, td.numpy(), ti.numpy()))
    assert td.dtype == np.float32 and ti.dtype == np.int32
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_array_equal(ti[~fin], -1)
    np.testing.assert_allclose(td[fin], jd[fin], atol=ATOL_D, rtol=0)
    rows = np.flatnonzero(fin.all(axis=1))
    sep = rows[_separated(jd[rows])]
    assert len(sep) > 0.9 * len(rows)
    np.testing.assert_array_equal(ti[sep], ji[sep])
    if mask is not None:
        assert not fin[~mask].any()
        valid = np.flatnonzero(mask)
        assert np.isin(ti[ti >= 0], valid).all()
    _, exact = tknn.knn(torch.as_tensor(pts), k, mask=None if mask is None
                        else torch.as_tensor(mask))
    exact = exact.numpy()
    live = np.flatnonzero(np.ones(n, bool) if mask is None else mask)
    r_port, r_jax = _recall(ti, exact, live), _recall(ji, exact, live)
    assert r_port == r_jax
    assert 0.3 < r_port < 1.0      # an approximation, and not a poor one


def _cloud(n_fg=60, n_bg=40, seed=10):
    scene = jsyn.make_gt_scene(n_fg=n_fg, n_bg=n_bg, seed=seed)
    w2c = np.stack([np.asarray(c.w2c) for c in
                    jsyn.orbit_cameras((0, 0, 0), 4.0, -1.0, 4, 64, 48,
                                       55.0)])
    return jsyn.init_point_cloud(scene, noise=0.05), w2c


def test_initialize_post_first_timestep_approx_matches():
    pt, w2c = _cloud()
    jp, jv = JG.init_params(pt, w2c, capacity=256)
    js = jopt.init(jp)
    fg = (np.asarray(jp["seg_colors"])[:, 0] > 0.5) & np.asarray(jv["alive"])
    assert _distinct_codes(np.asarray(jp["means3D"]), fg, 2)
    jcfg = jconf.TrainConfig(num_knn=8, knn_method="approx")
    tcfg = tconf.TrainConfig(num_knn=8, knn_method="approx")
    jp2, jv2, _ = jtr.initialize_post_first_timestep(jp, jv, jcfg, js)
    tp2, tv2, _ = ttr.initialize_post_first_timestep(
        convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                "cpu"),
        convert.variables_from_jax({k: np.asarray(v) for k, v in jv.items()},
                                   "cpu"), tcfg,
        convert.adam_state_from_jax({k: np.asarray(v) for k, v in
                                     js.mu.items()},
                                    {k: np.asarray(v) for k, v in
                                     js.nu.items()}, 0, "cpu"))
    d = np.asarray(jv2["neighbor_dist"])
    idx = np.asarray(jv2["neighbor_indices"])
    full = (idx >= 0).all(axis=1)
    assert _separated(d[full]).all()
    assert set(tv2) == set(jv2)
    for key in ("alive", "neighbor_indices", "edge_rank", "edge_row_ptr"):
        np.testing.assert_array_equal(tv2[key].numpy(),
                                      np.asarray(jv2[key]), err_msg=key)
    for key in ("neighbor_dist", "neighbor_weight", "init_bg_pts"):
        np.testing.assert_allclose(tv2[key].numpy(), np.asarray(jv2[key]),
                                   atol=1e-5, rtol=0, err_msg=key)
    np.testing.assert_array_equal(tp2["means3D"].numpy(),
                                  np.asarray(jp2["means3D"]))


def test_train_with_approx_graph_runs_every_timestep():
    """Port only: `knn_method="approx"` no longer raises; the t > 0 steps
    run over its graph, whose rows hold foreground rows only."""
    scene = tsyn.make_gt_scene(n_fg=40, n_bg=60, seed=2)
    ds, w2c, _ = tsyn.make_dataset(scene, num_t=2, num_cams=3, w=48, h=32,
                                   f=40.0, device="cpu")
    pt = tsyn.init_point_cloud(scene)
    cfg = tconf.TrainConfig(
        num_timesteps=2, iters_first_timestep=3, iters_per_timestep=2,
        densify_start=10 ** 9, capacity=512, report_every=1, num_knn=8,
        knn_method="approx", raster=tconf.RasterSettings(chunk=64))
    losses = []
    out, params, variables = ttr.train(
        ds, cfg, pt, w2c, device="cpu", callbacks={
            "on_step": lambda t, i, m: losses.append(
                (t, float(m["loss"]), float(m["loss_rigid"])
                 if "loss_rigid" in m else 0.0))})
    assert [t for t, _, _ in losses] == [0, 0, 0, 1, 1]
    assert np.isfinite([x[1:] for x in losses]).all()
    idx = variables["neighbor_indices"]
    fg = (params["seg_colors"][:, 0] > 0.5) & variables["alive"]
    n_fg = int(fg.sum())
    assert bool(fg[:n_fg].all())                  # the fg prefix
    assert bool((idx[:n_fg] >= 0).all()) and bool((idx[n_fg:] == -1).all())
    assert bool(fg[idx[:n_fg].long()].all())
