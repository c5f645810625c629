"""SE(3) motion bases with per-gaussian coefficients (Shape-of-Motion style).

Port of `dynamic3dgaussians_tpu/models/motion_bases.py`:

  * `compute_transforms` blends K per-frame bases {"rots" (K, F, 6),
    "transls" (K, F, 3)} with per-gaussian coefficients (G, K) BEFORE the
    6D Gram-Schmidt, and `apply_transforms` moves points by the result;
  * the coefficient inits: k-means (`kmeans`, `coefs_from_features`) or
    spectral clustering (`spectral_cluster`, `coefs_from_feature_clusters`)
    of per-gaussian features, coefs = scale * exp(-distance to the centres);
  * the Procrustes init from 3D tracks
    (`init_motion_params_with_procrustes`): every (basis, frame) weighted
    SE(3) solve in one batched SVD, low-weight frames inheriting the
    previous frame's transform outward from the canonical frame.

Every random draw comes from an explicit `torch.Generator`, or is passed in
(`noise=`, `init_idx=`, `sample_idx=`) so that a test can replay the
reference's draws. The float32 matmuls run with TF32 off on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamic3dgaussians_tpu_torch.device import (DeviceLike, no_tf32,
                                                 resolve_device)
from dynamic3dgaussians_tpu_torch.ops.quat import (cont_6d_to_rotmat,
                                                   rotmat_to_cont_6d)

Bases = Dict[str, torch.Tensor]


def _ident6(device) -> torch.Tensor:
    return rotmat_to_cont_6d(torch.eye(3, dtype=torch.float32, device=device))


def init_motion_bases(num_bases: int, num_frames: int,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      device: DeviceLike = None) -> Bases:
    """Bases near the identity: the identity's 6D vector plus 0.01 N(0, 1)
    per element (`noise`, (K, F, 6), or drawn from `generator`), zero
    translations. On `device` (default `cuda`)."""
    dev = resolve_device(device)
    shape = (num_bases, num_frames, 6)
    if noise is None:
        if generator is None:
            raise ValueError("pass a generator or the noise draw")
        noise = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
    rots = _ident6(dev).expand(shape) + 0.01 * torch.as_tensor(
        noise, dtype=torch.float32).to(dev)
    return {"rots": rots,
            "transls": torch.zeros((num_bases, num_frames, 3),
                                   dtype=torch.float32, device=dev)}


def compute_transforms(bases: Bases, ts: torch.Tensor,
                       coefs: torch.Tensor) -> torch.Tensor:
    """(G, B, 3, 4) rigid transforms of G gaussians at the B frames `ts`:
    the coefficients (G, K) blend the bases' 6D rotations and translations,
    then Gram-Schmidt makes each blended 6D vector a rotation."""
    with no_tf32():
        transls = torch.einsum("gk,kbi->gbi", coefs, bases["transls"][:, ts])
        rots6 = torch.einsum("gk,kbi->gbi", coefs, bases["rots"][:, ts])
    return torch.cat([cont_6d_to_rotmat(rots6), transls[..., None]], dim=-1)


def apply_transforms(transforms: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """(G, B, 3, 4) transforms x (G, 3) points -> (G, B, 3) moved points."""
    with no_tf32():
        return torch.einsum("gbij,gj->gbi", transforms[..., :3],
                            points) + transforms[..., 3]


def _sq_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    # the difference form: the matmul form |x|^2 - 2 x.c + |c|^2 rounds
    # differently and can reorder near-ties
    return torch.sum((x[:, None] - centers[None]) ** 2, dim=-1)


def _cluster_means(x: torch.Tensor, labels: torch.Tensor,
                   k: int) -> torch.Tensor:
    # an empty cluster divides 0 by 1: its centre goes to the origin, as in
    # the reference
    one_hot = F.one_hot(labels, k).to(x.dtype)
    counts = torch.clamp(one_hot.sum(0), min=1.0)
    with no_tf32():
        return (one_hot.T @ x) / counts[:, None]


def kmeans(x: torch.Tensor, k: int,
           generator: Optional[torch.Generator] = None, iters: int = 20,
           init_idx: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain k-means of (N, D) `x`: `iters` fixed Lloyd steps from the k
    distinct rows `init_idx` (drawn from `generator` when not given).
    Returns (centres (k, D), labels (N,)); argmin takes the first centre
    on ties."""
    if init_idx is None:
        if generator is None:
            raise ValueError("pass a generator or init_idx")
        init_idx = torch.randperm(x.shape[0], generator=generator,
                                  device=generator.device)[:k]
    centers = x[torch.as_tensor(init_idx).to(x.device).long()]
    for _ in range(iters):
        centers = _cluster_means(x, torch.argmin(_sq_dist(x, centers),
                                                 dim=-1), k)
    return centers, torch.argmin(_sq_dist(x, centers), dim=-1)


def _dist(features: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(features[:, None] - centers[None],
                                     dim=-1)


def coefs_from_features(features: torch.Tensor, num_bases: int,
                        generator: Optional[torch.Generator] = None,
                        scale: float = 10.0,
                        init_idx: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(N, K) coefficients scale * exp(-distance to the k-means centres)."""
    centers, _ = kmeans(features, num_bases, generator, init_idx=init_idx)
    return scale * torch.exp(-_dist(features, centers))


def _unit_rows(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-8)


def spectral_cluster(features: torch.Tensor, k: int,
                     generator: Optional[torch.Generator] = None,
                     sample: int = 2048, kmeans_iters: int = 25,
                     sample_idx: Optional[torch.Tensor] = None,
                     init_idx: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral clustering on cosine similarity.

    The normalized graph Laplacian of the cosine affinity (shifted to
    [0, 1]) of at most `sample` rows (`sample_idx`, drawn from `generator`
    when N > sample), its k smallest eigenvectors as the embedding, k-means
    there (from `init_idx`), then every row mapped into the embedding by
    its affinity to the sampled rows (Nystrom) and assigned to the nearest
    spectral centre. Returns (centres (k, D) in feature space, labels (N,)).
    """
    n = features.shape[0]
    f = _unit_rows(features)
    if n > sample:
        if sample_idx is None:
            if generator is None:
                raise ValueError("pass a generator or sample_idx")
            sample_idx = torch.randperm(n, generator=generator,
                                        device=generator.device)[:sample]
        fs = f[torch.as_tensor(sample_idx).to(f.device).long()]
    else:
        fs = f
    m = fs.shape[0]
    with no_tf32():
        a = (fs @ fs.T + 1.0) * 0.5
        d = torch.sum(a, dim=-1)
        dinv = 1.0 / torch.sqrt(torch.clamp(d, min=1e-8))
        lap = torch.eye(m, dtype=f.dtype, device=f.device) \
            - dinv[:, None] * a * dinv[None, :]
        _, eigvec = torch.linalg.eigh(lap)          # ascending
        emb = _unit_rows(eigvec[:, :k])
        centers_emb, _ = kmeans(emb, k, generator, iters=kmeans_iters,
                                init_idx=init_idx)
        a_all = (f @ fs.T + 1.0) * 0.5
        emb_all = a_all @ emb / torch.clamp(
            torch.sum(a_all, dim=-1, keepdim=True), min=1e-8)
    emb_all = _unit_rows(emb_all)
    labels = torch.argmin(_sq_dist(emb_all, centers_emb), dim=-1)
    return _cluster_means(features, labels, k), labels


def coefs_from_feature_clusters(features: torch.Tensor, num_bases: int,
                                generator: Optional[torch.Generator] = None,
                                scale: float = 10.0,
                                method: str = "spectral",
                                sample_idx: Optional[torch.Tensor] = None,
                                init_idx: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """scale * exp(-distance to the cluster centres), the clusters from
    `spectral_cluster` (method "spectral") or `kmeans`."""
    if method == "spectral":
        centers, _ = spectral_cluster(features, num_bases, generator,
                                      sample_idx=sample_idx,
                                      init_idx=init_idx)
    else:
        centers, _ = kmeans(features, num_bases, generator,
                            init_idx=init_idx)
    return scale * torch.exp(-_dist(features, centers))


def solve_procrustes_batched(src: torch.Tensor, dst: torch.Tensor,
                             weights: torch.Tensor):
    """Weighted SE(3) Kabsch solve, batched over the leading axes.

    src, dst (..., P, 3), weights (..., P) >= 0. Returns (R (..., 3, 3),
    t (..., 3), wsum (...)) minimizing sum_i w_i |R src_i + t - dst_i|^2.
    """
    wsum = torch.sum(weights, dim=-1)
    wn = weights / torch.clamp(wsum, min=1e-12)[..., None]
    with no_tf32():
        mu_s = torch.einsum("...p,...pi->...i", wn, src)
        mu_d = torch.einsum("...p,...pi->...i", wn, dst)
        cov = torch.einsum("...p,...pi,...pj->...ij", wn,
                           dst - mu_d[..., None, :], src - mu_s[..., None, :])
        U, _, Vt = torch.linalg.svd(cov)
        det = torch.linalg.det(U @ Vt)
        D = torch.stack([torch.ones_like(det), torch.ones_like(det), det],
                        dim=-1)
        R = (U * D[..., None, :]) @ Vt
        t = mu_d - torch.einsum("...ij,...j->...i", R, mu_s)
    return R, t, wsum


def velocity_direction_features(tracks_xyz: torch.Tensor,
                                cano_t: int) -> torch.Tensor:
    """(N, 6) per-track clustering features: the canonical position and the
    unit mean velocity direction."""
    vm = torch.mean(tracks_xyz[:, 1:] - tracks_xyz[:, :-1], dim=1)
    return torch.cat([tracks_xyz[:, cano_t], _unit_rows(vm)], dim=-1)


def init_motion_params_with_procrustes(
        tracks_xyz: torch.Tensor, num_bases: int, cano_t: int,
        generator: Optional[torch.Generator] = None,
        visibles: Optional[torch.Tensor] = None,
        confidences: Optional[torch.Tensor] = None,
        min_mean_weight: float = 0.1, outlier_quantile: float = 0.95,
        init_idx: Optional[torch.Tensor] = None):
    """Motion-basis init from (N, F, 3) 3D tracks.

    Outliers (distance from the median canonical point at or above its
    `outlier_quantile`, or never visible) get zero weight; clusters come
    from k-means (from `init_idx`, or drawn from `generator`) on the
    canonical position and mean velocity direction; every (basis, frame)
    weighted Procrustes solve runs in one batched SVD; frames whose weight
    is below `min_mean_weight` x the basis's mean weight inherit the
    previous frame's transform, sweeping outward from `cano_t`.

    Returns (bases {"rots" (K, F, 6), "transls" (K, F, 3)}, coefs (N, K),
    valid (N,) bool).
    """
    n, f, _ = tracks_xyz.shape
    dev = tracks_xyz.device
    vis = torch.ones((n, f), dtype=torch.bool, device=dev) \
        if visibles is None else visibles.to(torch.bool)
    conf = torch.ones((n, f), dtype=torch.float32, device=dev) \
        if confidences is None else confidences

    cano = tracks_xyz[:, cano_t]
    # the median of an even count averages the two middle values, as
    # jnp.median does; torch.median would return the lower one
    center = torch.quantile(cano, 0.5, dim=0)
    dists = torch.linalg.vector_norm(cano - center, dim=-1)
    thresh = torch.quantile(dists, outlier_quantile)
    valid = (dists < thresh) & torch.any(vis, dim=1)

    feats = velocity_direction_features(tracks_xyz, cano_t)
    centers, labels = kmeans(torch.where(valid[:, None], feats,
                                         feats.mean(0)), num_bases,
                             generator, init_idx=init_idx)
    coefs = 10.0 * torch.exp(-_dist(cano, centers[:, :3]))

    onehot = F.one_hot(labels, num_bases).to(torch.float32) \
        * valid[:, None].to(torch.float32)                  # (N, K)
    wf = (vis[:, cano_t:cano_t + 1] & vis).to(torch.float32) * \
        0.5 * (conf[:, cano_t:cano_t + 1] + conf)           # (N, F)
    W = torch.einsum("nk,nf->kfn", onehot, wf)              # (K, F, N)
    src = cano[None, None].expand(num_bases, f, n, 3)
    dst = tracks_xyz.permute(1, 0, 2)[None].expand(num_bases, f, n, 3)
    R, t, wsum = solve_procrustes_batched(src, dst, W)
    rots6 = rotmat_to_cont_6d(R)                            # (K, F, 6)
    ok = wsum > min_mean_weight * torch.clamp(
        torch.mean(wsum, dim=1, keepdim=True), min=1e-12)    # (K, F)

    rots_out = torch.zeros((num_bases, f, 6), dtype=torch.float32,
                           device=dev)
    t_out = torch.zeros((num_bases, f, 3), dtype=torch.float32, device=dev)
    # the canonical frame first, then outward; the backward sweep writes
    # the canonical frame again, with the same value
    for order in (range(cano_t, f), range(cano_t, -1, -1)):
        r_prev = _ident6(dev).expand(num_bases, 6)
        t_prev = torch.zeros((num_bases, 3), dtype=torch.float32, device=dev)
        for i in order:
            r_prev = torch.where(ok[:, i, None], rots6[:, i], r_prev)
            t_prev = torch.where(ok[:, i, None], t[:, i], t_prev)
            rots_out[:, i] = r_prev
            t_out[:, i] = t_prev
    return {"rots": rots_out, "transls": t_out}, coefs, valid
