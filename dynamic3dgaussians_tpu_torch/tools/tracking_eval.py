"""Tracking quality of a trained synthetic sequence: PCK, ATE and RPE.

    python -m dynamic3dgaussians_tpu_torch.tools.tracking_eval
        --params P.npz [--n 50000] [--timesteps 50] [--cams 8] [--hw 256]
        [--queries 256] [--knn 8] [--seed 0] [--out F.json]
        [--device cuda]

The port of `tools/tracking_eval.py`. The synthetic scene's foreground
moves by a known rigid motion (`data/synthetic.py::rigid_motion`, which
`animate` applies; the reference tool's `gt_rigid`), so every t = 0
foreground point has an exact trajectory. Queries: `--queries`
foreground points of the scene `tools/dynamic_run.py` built (the same
`--n` and `--seed`), chosen by numpy `RandomState(123)`. They are tracked
through the stacked params npz (`dynamic_run --save_params`) by
`eval/tracking.py` (attach to the `--knn` nearest foreground gaussians at
t = 0, replay their motion) and held against the true motion:

  * 2D: PCK at 0.05 max(W, H) and at 2 px, and the median pixel error,
    through each camera of the training rig, averaged over the rig;
  * 3D: the track error's mean, median, 90th percentile and its mean at
    the last timestep;
  * 6-DOF: ATE and RPE (translation, rotation in degrees) of the first
    64 queries' pose series [R_rel(t) | x(t)] against the true poses.

No render: the tracks are the gaussians' own motion. The default `--out`
is `artifacts/torch_tracking_eval_<device type>.json`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from dynamic3dgaussians_tpu_torch.data.synthetic import rigid_motion
from dynamic3dgaussians_tpu_torch.tools.dynamic_run import default_out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="tracking_eval")
    ap.add_argument("--params", type=str, required=True)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--timesteps", type=int, default=50)
    ap.add_argument("--cams", type=int, default=8)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--knn", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def run(args) -> dict:
    import torch

    from dynamic3dgaussians_tpu_torch.data import synthetic
    from dynamic3dgaussians_tpu_torch.device import resolve_device
    from dynamic3dgaussians_tpu_torch.eval.metrics import ate, pck, rpe
    from dynamic3dgaussians_tpu_torch.eval.tracking import (project_tracks,
                                                            track_points_3d,
                                                            track_rotations)
    from dynamic3dgaussians_tpu_torch.ops.camera import orbit_cameras
    from dynamic3dgaussians_tpu_torch.ops.quat import quat_to_rotmat
    from dynamic3dgaussians_tpu_torch.viz.export import load_params

    dev = resolve_device(args.device)
    stacked = load_params(args.params)
    T = stacked["means3D"].shape[0]
    if T != args.timesteps:
        raise SystemExit(f"{args.params} holds {T} timesteps, not "
                         f"--timesteps {args.timesteps}")

    # the scene dynamic_run built (the same seed), for the true queries
    scene = synthetic.make_gt_scene(n_fg=args.n // 2, n_bg=args.n // 2,
                                    seed=args.seed)
    rng = np.random.RandomState(123)
    qi = rng.choice(scene["n_fg"], size=args.queries, replace=False)
    queries = scene["means"][qi].astype(np.float32)          # (Q, 3) at t=0
    q_dev = torch.as_tensor(queries, device=dev)

    gt3 = np.stack([queries @ rigid_motion(t, T)[0].T + rigid_motion(t, T)[1]
                    for t in range(T)])                      # (T, Q, 3)
    pred3_dev = track_points_3d(stacked, q_dev, k=args.knn)  # (T, Q, 3)
    pred3 = pred3_dev.cpu().numpy()
    err3 = np.linalg.norm(pred3 - gt3, axis=-1)              # (T, Q)

    # 2D PCK through the training rig (the orbit make_dataset builds)
    cams = orbit_cameras(center=(0.0, 0.0, 0.0), radius=4.0, height=-1.0,
                         n=args.cams, w=args.hw, h=args.hw,
                         f=float(args.hw) * 0.9, device=dev)
    gt3_dev = torch.as_tensor(gt3, device=dev)
    pck05, pck2px, px_med = [], [], []
    for cam in cams:
        p2 = project_tracks(pred3_dev, cam)
        g2 = project_tracks(gt3_dev, cam)
        pck05.append(float(pck(p2, g2, (args.hw, args.hw), ratio=0.05)))
        pck2px.append(float(pck(p2, g2, (args.hw, args.hw),
                                ratio=2.0 / args.hw)))
        px_med.append(float(np.median(np.linalg.norm(
            (p2 - g2).cpu().numpy(), axis=-1))))

    # 6-DOF: per-query pose series [R_rel(t) | x(t)] against the true motion
    pq = track_rotations(stacked, q_dev, k=args.knn)         # (T, Q, 4)
    Rp = quat_to_rotmat(pq.reshape(-1, 4), normalized=True).reshape(
        T, -1, 3, 3).cpu().numpy()
    ates, rpes_t, rpes_r = [], [], []
    for q in range(min(args.queries, 64)):   # pose metrics per query
        pred_pose = np.tile(np.eye(4, dtype=np.float64), (T, 1, 1))
        gt_pose = np.tile(np.eye(4, dtype=np.float64), (T, 1, 1))
        for t in range(T):
            pred_pose[t, :3, :3] = Rp[t, q]
            pred_pose[t, :3, 3] = pred3[t, q]
            gt_pose[t, :3, :3] = rigid_motion(t, T)[0]
            gt_pose[t, :3, 3] = gt3[t, q]
        ates.append(ate(pred_pose, gt_pose))
        te, re = rpe(pred_pose, gt_pose)
        rpes_t.append(te)
        rpes_r.append(re)

    res = {
        "params": args.params, "timesteps": T, "queries": args.queries,
        "knn": args.knn, "img_hw": args.hw, "cams": args.cams,
        "pck_0.05": round(float(np.mean(pck05)), 4),
        "pck_2px": round(float(np.mean(pck2px)), 4),
        "px_err_median": round(float(np.mean(px_med)), 3),
        "err3d_mean": round(float(err3.mean()), 5),
        "err3d_median": round(float(np.median(err3)), 5),
        "err3d_p90": round(float(np.percentile(err3, 90)), 5),
        "err3d_final_t": round(float(err3[-1].mean()), 5),
        "ate_mean": round(float(np.mean(ates)), 5),
        "rpe_trans_mean": round(float(np.mean(rpes_t)), 6),
        "rpe_rot_deg_mean": round(float(np.mean(rpes_r)), 4),
    }
    out = args.out or default_out("tracking_eval", dev)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return res


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
