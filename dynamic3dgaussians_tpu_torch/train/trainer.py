"""The per-timestep training driver.

Port of `dynamic3dgaussians_tpu/train/trainer.py`:

  train(dataset, cfg, pt_cld, w2c_stack)
    init_params -> capacity-padded tables (models.gaussians)
    for t in timesteps:
      t > 0: initialize_per_timestep (forward extrapolation, the t - 1
        state the physics losses hold the step to, Adam moments of means
        and rotations reset)
      for i in iters: train_step (render RGB + seg in one pass through the
        kernels' autograd Function, losses -- the physics terms at t > 0 --,
        Adam), densify at its cadence (t = 0 only), K escalation at report
        steps, carried across timesteps
      t = 0: compact -> kNN graph -> foreground-first RCM row reorder
      the timestep's parameters -> host (all at t = 0, then means, colours
        and rotations)

The same seed gives the same camera stream as the reference (numpy
`RandomState(cfg.seed)`, picks without replacement) and the same schedule of
host actions. Per step the host reads one number from the device, the
live-pair count of the sort; the rect-drop count is summed on the device
and read only at report steps, and the metrics stay tensors until a
callback reads them.

With `steps_per_call` W > 1 the loop is the reference's: wherever no host
action (densify, opacity reset, report, checkpoint, the timestep's last
step) falls strictly inside the next W steps, they run as one window
(`make_train_scan` over the timestep's data stacked on the device,
`stack_timestep_data`); single steps cover the boundaries and remainders.
On the card a window replays one captured CUDA graph of the step
(`step_graph.py`: no host read inside a window, one at its end); on the
CPU it runs the same steps in a loop. Either way it computes what W single
steps compute, from the same camera stream.

Checkpoints follow the reference's schedule: with `checkpoint_dir` and
`checkpoint_every`, the full state (parameters, Adam state, variables and
the cursor {t, i}) is saved after every `checkpoint_every`-th global step,
before that step's densify and opacity-reset block, and once more at the
end, at global step + 1 with the cursor {t: last, i: num_iters}. `resume`
restores the latest step: the timesteps before its t are skipped (the
returned per-timestep parameters start at that t, as in the reference), its
t does not run `initialize_per_timestep` again, and its loop starts at
i + 1, so a step saved at i never runs the densify block of i. As in the
reference, what the cursor does not hold restarts: the camera stream
(numpy `RandomState(cfg.seed)`) and the densify noise (`torch.Generator`
seeded with `cfg.seed`) start from the seed, the camera permutation
(`todo`) starts empty, and K starts at the caller's `cfg`, since an
escalated K lives only in the run's local config. A mid-run resume is
therefore not the uninterrupted run; a resume from the final step returns
its state unchanged.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.models import gaussians as G
from dynamic3dgaussians_tpu_torch.ops import quat
from dynamic3dgaussians_tpu_torch.ops.camera import Camera, stack_cameras
from dynamic3dgaussians_tpu_torch.ops.knn import knn, knn_approx
from dynamic3dgaussians_tpu_torch.ops.neighbor import (EdgeReduction,
                                                       build_edge_reduction,
                                                       locality_order,
                                                       neighbor_lookup)
from dynamic3dgaussians_tpu_torch.ops.rasterize import RasterConfig, render
from dynamic3dgaussians_tpu_torch.train import densify as densify_mod
from dynamic3dgaussians_tpu_torch.train import losses as L
from dynamic3dgaussians_tpu_torch.train import optim
from dynamic3dgaussians_tpu_torch.train.checkpoint import CheckpointManager
from dynamic3dgaussians_tpu_torch.train.config import TrainConfig
from dynamic3dgaussians_tpu_torch.train.step_graph import (StepWindow,
                                                           batch_at,
                                                           window_metrics)

MAX_TILES_PER_GAUSSIAN = 64    # K escalation stops here


def raster_config(cfg: TrainConfig) -> RasterConfig:
    r = cfg.raster
    return RasterConfig(tile_h=r.tile_h, tile_w=r.tile_w, chunk=r.chunk,
                        max_per_tile=r.max_per_tile,
                        max_tiles_per_gaussian=r.max_tiles_per_gaussian,
                        pairs_per_gaussian=r.pairs_per_gaussian,
                        exact_cull=r.exact_cull)


def resize_feature_map(feat: torch.Tensor, hw) -> torch.Tensor:
    """(H, W, C) -> (h, w, C) bilinear with half-pixel centres, antialiased
    when shrinking: the reference's `jax.image.resize(..., "bilinear")`.
    Returns `feat` itself when the size already matches."""
    if tuple(feat.shape[:2]) == tuple(hw):
        return feat
    return F.interpolate(feat.permute(2, 0, 1)[None], size=tuple(hw),
                         mode="bilinear", align_corners=False,
                         antialias=True)[0].permute(1, 2, 0)


def compute_loss(params: Dict, probe: torch.Tensor, batch: Dict,
                 variables: Dict, *, is_initial: bool, cfg: TrainConfig,
                 rcfg: RasterConfig, pair_cap: Optional[int] = None,
                 pair_stats: bool = False):
    """Loss over one camera datapoint.

    batch: {camera, im (H, W, 3), seg (H, W, 3), cam_id (an int, or a 0-d
    int64 tensor on the parameters' device: a window's gathered batch, read
    without a host read), optional gt_depth (H, W) and gt_feature (h, w,
    F)}. Returns (loss, aux) with the radii for the densification
    statistics, and with a pair_cap or pair_stats (`render`'s) the record
    table's live pairs and overflow.
    """
    alive = variables["alive"]
    act = G.activated(params, alive)
    extra = params["seg_colors"]
    has_feat = "gt_feature" in batch and "semantic_feature" in params
    if has_feat:
        extra = torch.cat([extra, params["semantic_feature"]], dim=-1)
    cam = batch["camera"]
    out = render(cam, act["means3d"], act["colors"], act["opacity"],
                 act["scales"], act["rotations"], extra_channels=extra,
                 mean2d_probe_ndc=probe, config=rcfg,
                 method=cfg.raster.render_method(), device=cam.device,
                 pair_cap=pair_cap, pair_stats=pair_stats)

    cam_id = batch["cam_id"]
    if isinstance(cam_id, torch.Tensor) and \
            cam_id.device == params["cam_m"].device:
        idx = cam_id.reshape(1).long()
        cam_m = params["cam_m"].index_select(0, idx)[0]
        cam_c = params["cam_c"].index_select(0, idx)[0]
    else:
        cam_m, cam_c = params["cam_m"][int(cam_id)], \
            params["cam_c"][int(cam_id)]
    im = L.apply_cam_correction(out.rgb, cam_m, cam_c)
    losses = {"im": L.image_loss(im, batch["im"]),
              "seg": L.image_loss(out.extra[..., :3], batch["seg"])}
    if "gt_depth" in batch:
        losses["depth"] = L.depth_pearson_loss(out.depth, batch["gt_depth"])
    if has_feat:
        gt_feat = batch["gt_feature"]
        feat = resize_feature_map(out.extra[..., 3:], gt_feat.shape[:2])
        losses["feature"] = L.image_loss(feat, gt_feat)
    if not is_initial:
        is_fg = params["seg_colors"][:, 0] > 0.5
        losses.update(L.physics_losses(
            act["means3d"], act["rotations"], params["rgb_colors"],
            variables, is_fg, alive))

    w = cfg.loss_weights
    total = sum(float(w.get(k, 0.0)) * v for k, v in losses.items())
    aux = {"losses": losses, "radii": out.radii,
           "psnr": L.psnr(torch.clamp(im, 0, 1), batch["im"]),
           "n_dropped": (out.n_dropped_capacity + out.n_dropped_rect
                         + out.n_dropped_tile_overflow),
           "n_dropped_rect": out.n_dropped_rect}
    if out.n_live_pairs is not None:
        aux["n_live_pairs"] = out.n_live_pairs
        aux["n_pair_overflow"] = out.n_pair_overflow
    return total, aux


def loss_and_grads(params: Dict, variables: Dict, batch, *,
                   is_initial: bool, cfg: TrainConfig, rcfg: RasterConfig,
                   pair_cap: Optional[int] = None, pair_stats: bool = False):
    """`compute_loss` over one datapoint, or over a list of them (the mean
    loss, the largest radii, the mean PSNR and the summed drop counts),
    and its gradients w.r.t. the parameters and the mean2d probe. Returns
    (loss, aux, grads by key, probe gradient), a group that the loss does
    not reach getting zeros."""
    keys = list(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
    alive = variables["alive"]
    probe = torch.zeros((alive.shape[0], 2), dtype=torch.float32,
                        device=alive.device, requires_grad=True)
    kw = dict(is_initial=is_initial, cfg=cfg, rcfg=rcfg, pair_cap=pair_cap,
              pair_stats=pair_stats)
    if isinstance(batch, dict):
        loss, aux = compute_loss(leaves, probe, batch, variables, **kw)
    else:
        parts = [compute_loss(leaves, probe, b, variables, **kw)
                 for b in batch]
        auxs = [a for _, a in parts]
        aux = {"losses": {k: torch.stack([a["losses"][k] for a in auxs])
                          .mean() for k in auxs[0]["losses"]},
               "radii": torch.stack([a["radii"] for a in auxs]).amax(0),
               "psnr": torch.stack([a["psnr"] for a in auxs]).mean(),
               "n_dropped": sum(a["n_dropped"] for a in auxs),
               "n_dropped_rect": sum(a["n_dropped_rect"] for a in auxs)}
        if "n_live_pairs" in auxs[0]:
            aux["n_live_pairs"] = torch.stack(
                [a["n_live_pairs"] for a in auxs]).amax()
            aux["n_pair_overflow"] = sum(a["n_pair_overflow"] for a in auxs)
        loss = torch.stack([p for p, _ in parts]).mean()
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys] + [probe],
                                allow_unused=True)
    gp = {k: torch.zeros_like(params[k]) if g is None else g
          for k, g in zip(keys, grads[:-1])}
    gprobe = torch.zeros_like(probe) if grads[-1] is None else grads[-1]
    return loss.detach(), aux, gp, gprobe


def mask_dead_rows(grads: Dict, alive: torch.Tensor) -> Dict:
    """Zero the gradient rows of dead capacity slots in every per-gaussian
    group, so they never drift (their gradients can be NaN, e.g.
    normalising a zero quaternion); `alive` covers the groups' rows."""
    out = {}
    for k, g in grads.items():
        if k not in G.CAMERA_KEYS:
            m = alive.reshape((-1,) + (1,) * (g.dim() - 1))
            g = torch.where(m, g, torch.zeros_like(g))
        out[k] = g
    return out


def make_train_step(cfg: TrainConfig, rcfg: RasterConfig):
    """The train step: gradients of the loss w.r.t. the parameters and the
    mean2d probe, the dead-row gradient mask, Adam, the densification
    statistics.

    train_step(params, opt_state, variables, batch, lrs, is_initial,
    pair_cap=None, pair_stats=False) -> (params, opt_state, variables,
    metrics); `batch` is one datapoint or a list of them (cams_per_step > 1:
    mean loss, largest radii). A pair_cap renders with a record table of
    that fixed capacity (no host read, for a captured step); the metrics
    then also hold the largest live-pair count and the overflow past it
    (`n_live_pairs`, `n_pair_overflow`: a step with overflow is not the
    eager step). pair_stats adds them to an eager step's metrics too (the
    live count, and 0).
    """

    def train_step(params, opt_state, variables, batch, lrs, is_initial,
                   pair_cap=None, pair_stats=False):
        loss, aux, gp, gprobe = loss_and_grads(
            params, variables, batch, is_initial=is_initial, cfg=cfg,
            rcfg=rcfg, pair_cap=pair_cap, pair_stats=pair_stats)
        with torch.no_grad():
            gp = mask_dead_rows(gp, variables["alive"])
            new_params, new_opt = optim.step(
                {k: v.detach() for k, v in params.items()}, gp, opt_state,
                lrs)
            new_vars = densify_mod.accumulate_stats(variables, gprobe,
                                                    aux["radii"])
            metrics = {"loss": loss, "psnr": aux["psnr"].detach(),
                       "n_dropped": aux["n_dropped"],
                       "n_dropped_rect": aux["n_dropped_rect"],
                       **{f"loss_{k}": v.detach()
                          for k, v in aux["losses"].items()}}
            if "n_live_pairs" in aux:
                metrics["n_live_pairs"] = aux["n_live_pairs"]
                metrics["n_pair_overflow"] = aux["n_pair_overflow"]
        return new_params, new_opt, new_vars, metrics

    return train_step


def stack_timestep_data(data_t: List[Dict]) -> Dict:
    """One timestep's camera datapoints stacked on their device, leading
    axis the camera: cameras by `stack_cameras`, tensors by `torch.stack`,
    numbers (cam_id) as an int64 / float32 tensor. The data of a window
    (`make_train_scan`), which gathers each step's batch by index."""
    first = data_t[0]
    dev = first["camera"].device
    out = {}
    for key in first:
        vals = [d[key] for d in data_t]
        if isinstance(vals[0], Camera):
            out[key] = stack_cameras(vals)
        elif isinstance(vals[0], torch.Tensor):
            out[key] = torch.stack(vals).to(dev)
        else:
            dtype = (torch.float32 if isinstance(vals[0], float)
                     else torch.int64)
            out[key] = torch.as_tensor(vals, dtype=dtype, device=dev)
    return out


def make_train_scan(cfg: TrainConfig, rcfg: RasterConfig, train_step=None,
                    graph_factory=None, window: Optional[StepWindow] = None):
    """The multi-step window: W train steps in one call.

    train_scan(params, opt_state, variables, data_stack, cam_sel, lrs,
    is_initial) -> (params, opt_state, variables, metrics), as the
    reference's: data_stack from `stack_timestep_data`; cam_sel (W,) or
    (W, k_cams) camera indices into its leading axis (a tensor or array);
    metrics the last step's, except n_dropped / n_dropped_rect, summed over
    the window (`window_metrics`).

    On a CUDA state it is a `step_graph.StepWindow`: the step captured as a
    CUDA graph and replayed W times (its `stats` count captures, replays
    and redos). On the CPU the W steps run through `train_step` in a loop,
    each batch gathered from the stack as on the card. `graph_factory`
    (tests) runs the graph window with a stand-in for the CUDA graph.
    `window`: the StepWindow of an earlier scan to go on with (`train`'s,
    across a K escalation): it keeps its pair capacity and captures the new
    step at its next window.
    """
    step = train_step or make_train_step(cfg, rcfg)
    k_slots = rcfg.max_tiles_per_gaussian
    if window is not None:
        window.set_step(step, k_slots)

    def train_scan(params, opt_state, variables, data_stack, cam_sel, lrs,
                   is_initial):
        dev = variables["alive"].device
        if train_scan.window is None and dev.type == "cuda":
            train_scan.window = StepWindow(step, k_slots)
        if train_scan.window is not None:
            return train_scan.window(params, opt_state, variables,
                                     data_stack, cam_sel, lrs, is_initial)
        sel = torch.as_tensor(cam_sel, dtype=torch.int64).to(dev)
        ms = []
        for r in range(sel.shape[0]):
            params, opt_state, variables, m = step(
                params, opt_state, variables, batch_at(data_stack, sel[r]),
                lrs, is_initial)
            ms.append(m)
        return params, opt_state, variables, window_metrics(ms)

    if window is None and graph_factory is not None:
        window = StepWindow(step, k_slots, graph_factory)
    train_scan.window = window
    return train_scan


def densify_with_growth(params, variables, opt_state, i: int,
                        cfg: TrainConfig, generator: torch.Generator):
    """One densify pass with unbounded growth: if the pass ran out of free
    slots, grow the tables and redo the pass on the pre-densify state, so
    no row is ever dropped (the redo draws its split noise afresh, as the
    reference's redo draws a new shape from the same key). Returns
    densify's 4-tuple."""
    new_state = densify_mod.densify(params, variables, opt_state, i,
                                    generator=generator)
    dropped = int(new_state[3].n_dropped_capacity)
    if dropped > 0 and cfg.grow_capacity:
        cap = variables["alive"].shape[0]
        needed = int(new_state[3].n_alive) + dropped
        new_cap = G.round_capacity(max(2 * cap, needed))
        if cfg.max_capacity:
            new_cap = min(new_cap, G.round_capacity(cfg.max_capacity))
        if new_cap > cap:
            params, variables, opt_state = G.grow_capacity(
                params, variables, new_cap, opt_state)
            new_state = densify_mod.densify(params, variables, opt_state, i,
                                            generator=generator)
    return new_state


def initialize_per_timestep(params: Dict, variables: Dict,
                            opt_state: optim.AdamState):
    """Forward extrapolation and the t - 1 state, at the start of t > 0.

    New means and rotations x + (x - prev_x); the physics losses' t - 1
    state: the inverse rotations, the neighbour offsets of the points
    before the extrapolation (cap, K, 3), the colours, and prev_pts /
    prev_rot for the next extrapolation; the Adam moments of means and
    rotations reset. Returns (params, variables, opt_state).
    """
    with torch.no_grad():
        pts = params["means3D"]
        rot = quat.normalize(params["unnorm_rotations"])
        new_pts = pts + (pts - variables["prev_pts"])
        new_rot = quat.normalize(rot + (rot - variables["prev_rot"]))
        plan = EdgeReduction(variables["edge_rank"],
                             variables["edge_row_ptr"], 0)
        nb = neighbor_lookup(pts, variables["neighbor_indices"], plan)
        new_vars = dict(variables)
        new_vars["prev_inv_rot"] = quat.conjugate(rot)
        new_vars["prev_offset"] = nb - pts[:, None, :]
        new_vars["prev_col"] = params["rgb_colors"]
        new_vars["prev_pts"] = new_pts
        new_vars["prev_rot"] = new_rot
    new_params = dict(params)
    new_params["means3D"] = new_pts
    new_params["unnorm_rotations"] = new_rot
    opt_state = optim.reset_moments(opt_state, "means3D")
    opt_state = optim.reset_moments(opt_state, "unnorm_rotations")
    return new_params, new_vars, opt_state


def initialize_post_first_timestep(params: Dict, variables: Dict,
                                   cfg: TrainConfig, opt_state=None,
                                   timings: Optional[Dict] = None):
    """Build the foreground kNN graph and freeze the t = 0 state.

    kNN over the alive foreground rows (indices are table rows, -1 for the
    others). With `opt_state` the table is also reordered once: foreground
    rows first, in reverse Cuthill-McKee order of their graph, and the edge
    plan covers that prefix only. `timings`, when given, receives the
    seconds of the kNN ("knn_s") and of the reorder ("rcm_s").

    Returns (params, variables, opt_state).
    """
    if cfg.knn_method not in ("exact", "approx"):
        raise NotImplementedError(f"knn_method {cfg.knn_method!r} is not "
                                  f"one of 'exact', 'approx'")
    if cfg.neighbor_window:
        raise NotImplementedError("neighbor_window (the TPU windowed fetch) "
                                  "is not ported")
    timings = {} if timings is None else timings
    dev = variables["alive"].device
    alive = variables["alive"]
    is_fg = (params["seg_colors"][:, 0] > 0.5) & alive
    t0 = time.perf_counter()
    knn_fn = knn_approx if cfg.knn_method == "approx" else knn
    sq_dist, idx = knn_fn(params["means3D"], cfg.num_knn, mask=is_fg)
    sq_dist = torch.where(idx >= 0, sq_dist, torch.zeros_like(sq_dist))
    idx_h = idx.cpu().numpy()
    timings["knn_s"] = time.perf_counter() - t0

    new_vars = dict(variables)
    n_dst = None
    t0 = time.perf_counter()
    if opt_state is not None:
        cap = int(alive.shape[0])
        fg_rows = np.flatnonzero(is_fg.cpu().numpy())
        if fg_rows.size:
            perm = locality_order(idx_h, fg_rows, cap)
            inv = np.empty(cap, np.int64)
            inv[perm] = np.arange(cap)
            porder = torch.as_tensor(perm, device=dev)
            take = lambda v: v[porder]            # noqa: E731
            params = G.rows_of(params, take)
            for k in G.STAT_KEYS:
                new_vars[k] = new_vars[k][porder]
            opt_state = optim.AdamState(mu=G.rows_of(opt_state.mu, take),
                                        nu=G.rows_of(opt_state.nu, take),
                                        step=opt_state.step)
            idx_h = np.where(idx_h[perm] >= 0,
                             inv[np.maximum(idx_h[perm], 0)],
                             -1).astype(np.int32)
            idx = torch.as_tensor(idx_h, device=dev)
            sq_dist = sq_dist[porder]
            n_dst = int(fg_rows.size)  # the fg prefix carries every edge
    plan = build_edge_reduction(idx_h, n_dst=n_dst, device=dev)
    timings["rcm_s"] = time.perf_counter() - t0

    new_vars["neighbor_indices"] = idx
    new_vars["edge_rank"] = plan.rank
    new_vars["edge_row_ptr"] = plan.row_ptr
    new_vars["neighbor_weight"] = torch.exp(-cfg.knn_weight_beta * sq_dist)
    new_vars["neighbor_dist"] = torch.sqrt(sq_dist)
    rot = quat.normalize(params["unnorm_rotations"])
    new_vars["init_bg_pts"] = params["means3D"]
    new_vars["init_bg_rot"] = rot
    new_vars["prev_pts"] = params["means3D"]
    new_vars["prev_rot"] = rot
    return params, new_vars, opt_state


def params_to_cpu(params: Dict, variables: Dict, is_initial: bool) -> Dict:
    """Strip the capacity padding and copy to host numpy."""
    n = int(G.num_alive(variables))
    keys = params.keys() if is_initial else ("means3D", "rgb_colors",
                                             "unnorm_rotations")
    out = {}
    for k in keys:
        v = params[k].detach().cpu().numpy()
        out[k] = v if k in G.CAMERA_KEYS else v[:n]
    return out


def train(dataset, cfg: TrainConfig, pt_cld: np.ndarray,
          w2c_stack: np.ndarray, callbacks: Optional[Dict] = None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
          resume: bool = False, device: DeviceLike = None):
    """Optimise every timestep of a sequence.

    dataset: dataset[t] = list of camera datapoints (dicts as in
    compute_loss, on `device`), or a callable t -> that list. pt_cld (N, 7)
    initial cloud [xyz, rgb, seg]; w2c_stack (C, 4, 4) extrinsics for the
    scene radius. Callbacks (all optional): on_step(t, i, metrics) at report
    steps, on_iter(t, i, k) after every step and its host actions (after a
    window of steps_per_call steps, once, with its last i; k: the emission
    slots per gaussian the step rendered with), on_densify(t, i,
    stats), on_grow_tiles(t, i, new_k), on_graph(t, timings) after the kNN
    graph, on_timestep(t, params, variables). checkpoint_dir /
    checkpoint_every: full-state checkpoints every `checkpoint_every`
    global steps (0: only the final one); `resume` restarts from the latest
    (see the module docstring). Runs on `device` (default `cuda`).

    Returns (output_params, params, variables): the host checkpoints per
    timestep (from the resumed timestep on, after a resume) and the final
    device state.
    """
    dev = resolve_device(device)
    callbacks = callbacks or {}
    rng = np.random.RandomState(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    params, variables = G.init_params(
        pt_cld, w2c_stack, capacity=cfg.capacity or
        G.round_capacity(pt_cld.shape[0] * 4),
        semantic_dim=cfg.semantic_dim, seed=cfg.seed, generator=gen,
        device=dev)
    opt_state = optim.init(params)
    rcfg = raster_config(cfg)
    train_step = make_train_step(cfg, rcfg)
    # one window object for the run: its graph carries over from one
    # timestep to the next, its pair capacity also across K escalations
    scan_w = max(1, int(cfg.steps_per_call))
    train_scan = make_train_scan(cfg, rcfg, train_step)

    ckpt_mgr = None
    resume_t, resume_i, global_step = -1, -1, 0
    if checkpoint_dir:
        ckpt_mgr = CheckpointManager(checkpoint_dir)
        if resume:
            restored = ckpt_mgr.load(device=dev)
            if restored is not None:
                global_step, params, opt_state, variables, cursor = restored
                resume_t, resume_i = cursor["t"], cursor["i"]

    def lr_tree(frozen: bool):
        lrs = {}
        for k in params:
            base = cfg.lrs.get(k, 0.0)
            if k == "means3D":
                base = base * float(variables["scene_radius"])
            if frozen and k in cfg.freeze_after_t0:
                base = 0.0
            lrs[k] = torch.tensor(base, dtype=torch.float32, device=dev)
        return lrs

    get_t = dataset if callable(dataset) else dataset.__getitem__
    output_params = []
    num_iters = (cfg.iters_first_timestep if cfg.num_timesteps == 1
                 else cfg.iters_per_timestep)
    for t in range(cfg.num_timesteps):
        is_initial = t == 0
        if t < resume_t:
            continue           # the resumed step lies past this timestep
        data_t = get_t(t)
        if not is_initial and t != resume_t:
            params, variables, opt_state = initialize_per_timestep(
                params, variables, opt_state)
        num_iters = (cfg.iters_first_timestep if is_initial
                     else cfg.iters_per_timestep)
        lrs = lr_tree(frozen=not is_initial)
        todo: List[int] = []
        k_cams = max(1, min(cfg.cams_per_step, len(data_t)))
        # summed on the device, read at report steps only
        rect_drop_accum = torch.zeros((), dtype=torch.int32, device=dev)
        use_scan = scan_w > 1 and len(data_t) > 0
        if use_scan:
            data_stack = stack_timestep_data(data_t)

        def pick_cams(n_steps):
            """(n_steps, k_cams) indices from the without-replacement
            permutation stream (the reference's get_batch)."""
            nonlocal todo
            rows = []
            for _ in range(n_steps):
                row = []
                for _ in range(k_cams):
                    if not todo:
                        todo = list(rng.permutation(len(data_t)))
                    row.append(int(todo.pop()))
                rows.append(row)
            return np.asarray(rows, np.int64)

        def next_mult(x, m):
            return ((x + m - 1) // m) * m

        def next_host_action(i):
            """The smallest step index >= i after which the host acts."""
            a = [num_iters - 1, next_mult(i, cfg.report_every)]
            if is_initial and i <= cfg.densify_end:
                d = next_mult(max(i, cfg.densify_start), cfg.densify_every)
                if d <= cfg.densify_end:
                    a.append(d)
                a.append(next_mult(max(i, 1), cfg.opacity_reset_every))
            if ckpt_mgr and checkpoint_every:
                a.append(i + (-(global_step + 1)) % checkpoint_every)
            return min(x for x in a if x >= i)

        i = resume_i + 1 if t == resume_t else 0
        while i < num_iters:
            k_step = cfg.raster.max_tiles_per_gaussian
            if use_scan and next_host_action(i) - i + 1 >= scan_w:
                sel = pick_cams(scan_w)
                sel = torch.as_tensor(sel[:, 0] if k_cams == 1 else sel,
                                      device=dev)
                params, opt_state, variables, metrics = train_scan(
                    params, opt_state, variables, data_stack, sel, lrs,
                    is_initial)
                steps_done = scan_w
            else:
                picks = [data_t[c] for c in pick_cams(1)[0]]
                batch = picks[0] if k_cams == 1 else picks
                params, opt_state, variables, metrics = train_step(
                    params, opt_state, variables, batch, lrs, is_initial)
                steps_done = 1
            if cfg.grow_tiles:
                # a window's count is its steps' sum
                rect_drop_accum = rect_drop_accum + metrics["n_dropped_rect"]
            global_step += steps_done
            i += steps_done - 1             # the last step that ran
            if ckpt_mgr and checkpoint_every and \
                    global_step % checkpoint_every == 0:
                # before this step's densify block, as the reference saves
                ckpt_mgr.save(global_step, params, opt_state, variables,
                              {"t": t, "i": i})
            if is_initial and i <= cfg.densify_end:
                if i >= cfg.densify_start and i % cfg.densify_every == 0:
                    params, variables, opt_state, dstats = \
                        densify_with_growth(params, variables, opt_state, i,
                                            cfg, gen)
                    if "on_densify" in callbacks:
                        callbacks["on_densify"](t, i, dstats)
                if i > 0 and i % cfg.opacity_reset_every == 0:
                    params, opt_state = densify_mod.reset_opacity(params,
                                                                  opt_state)
            if i % cfg.report_every == 0:
                # K escalation: the original never truncates a gaussian's
                # tile rect; if the K emission slots overflowed on any step
                # since the last report, double K
                if (cfg.grow_tiles and int(rect_drop_accum) > 0
                        and cfg.raster.max_tiles_per_gaussian
                        < MAX_TILES_PER_GAUSSIAN):
                    new_k = min(cfg.raster.max_tiles_per_gaussian * 2,
                                MAX_TILES_PER_GAUSSIAN)
                    new_pairs = (min(new_k, cfg.pairs_budget_cap)
                                 if cfg.pairs_budget_cap else new_k)
                    new_pairs = max(cfg.raster.pairs_per_gaussian, new_pairs)
                    cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
                        cfg.raster, max_tiles_per_gaussian=new_k,
                        pairs_per_gaussian=new_pairs))
                    rcfg = raster_config(cfg)
                    train_step = make_train_step(cfg, rcfg)
                    train_scan = make_train_scan(cfg, rcfg, train_step,
                                                 window=train_scan.window)
                    if "on_grow_tiles" in callbacks:
                        callbacks["on_grow_tiles"](t, i, new_k)
                rect_drop_accum = torch.zeros_like(rect_drop_accum)
                if "on_step" in callbacks:
                    callbacks["on_step"](t, i, metrics)
            if "on_iter" in callbacks:
                callbacks["on_iter"](t, i, k_step)
            i += 1

        if is_initial:
            # alive rows to the front, then the fixed neighbour graph
            params, variables, opt_state, _ = G.compact_with_optimizer(
                params, variables, opt_state)
            timings: Dict[str, float] = {}
            params, variables, opt_state = initialize_post_first_timestep(
                params, variables, cfg, opt_state, timings=timings)
            if "on_graph" in callbacks:
                callbacks["on_graph"](t, timings)
        output_params.append(params_to_cpu(params, variables, is_initial))
        if "on_timestep" in callbacks:
            callbacks["on_timestep"](t, params, variables)
    if ckpt_mgr:
        ckpt_mgr.save(global_step + 1, params, opt_state, variables,
                      {"t": cfg.num_timesteps - 1, "i": num_iters}, wait=True)
        ckpt_mgr.close()
    return output_params, params, variables
