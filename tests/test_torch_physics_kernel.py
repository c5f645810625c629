"""The edge terms of the physics losses through the kernel P1, on the CPU.

P1 (`csrc/physics.cu`, wrapper `ops/cuda/physics.py::edge_losses_cuda`)
runs only on the card; `tests/test_torch_gpu.py` holds it against the
plain terms there. Here `torch_physics_model.p1_model`, P1's four passes
in numpy float32 (the prefix walk, the per-block partials and their
fixed-order sum, each row's own sum, the scatter to rank[e] and the
per-destination run sum, the gradient through normalize and the
quaternion product), is held against the plain
`train/losses.py::edge_losses_torch` and its autograd gradient, on graphs
with K in {4, 20}: slots with idx -1, prefix rows that are not foreground
or not alive, foreground rows past the plan's n_dst, a full-capacity plan,
a plan whose blocks outnumber the final pass's threads, and dead prefix
rows with NaN means compared after the step's `mask_dead_rows`.

Tolerances, each from float32 and the order of the sums:
  * the losses: relative 1e-6 (read: at most 1.6e-7). The per-edge
    terms are formed in the same order of operations (rsqrt as 1 / sqrt
    on both sides); the sum over the edges is the kernel's blocks and
    tree against torch.sum's, both float32 over at most ~270,000 positive
    terms, each within a few ulp of the exact sum, and the count is exact.
  * the gradients: |model - plain| <= 2e-6 x the group's largest |plain|
    + 2e-6 |plain| (read: at most 4.6e-7 x the largest). Each gradient is
    a sum of up to ~2 K + 1 edge terms whose chain rule is taken in
    another order (the kernel sums d q per edge, autograd sums d R over K
    first and takes d q once).
  * dead rows, masked after the step: exactly 0 on both sides.

Also: `physics_losses` on CPU tensors is the plain code (its edge terms
equal `edge_losses_torch`'s, bitwise) and launches nothing; on another
device it raises, and the kernel's wrapper refuses CPU tensors.
"""

import numpy as np
import pytest
import torch

from dynamic3dgaussians_tpu_torch.ops.cuda import physics as P1
from dynamic3dgaussians_tpu_torch.train import losses as L
from dynamic3dgaussians_tpu_torch.train import trainer as T
from torch_physics_model import edge_graph, p1_model

torch.set_num_threads(1)

TERMS = ("rigid", "rot", "iso")
UPSTREAM = (4.0, 4.0, 2.0)     # the default loss weights of the terms

# (seed, cap, n_pre, K, full_plan, dead_nan)
CASES = {
    "k4_prefix": (1, 512, 301, 4, False, False),
    "k20_prefix": (2, 512, 301, 20, False, False),
    "k4_full_plan": (3, 384, 250, 4, True, False),
    "k20_full_plan": (4, 384, 250, 20, True, False),
    "k4_dead_nan": (5, 512, 333, 4, False, True),
    "k20_dead_nan": (6, 512, 333, 20, False, True),
    "k20_many_blocks": (7, 16384, 13500, 20, False, False),
}


def _plain(means, rots, variables, fg, alive):
    m = means.clone().requires_grad_(True)
    r = rots.clone().requires_grad_(True)
    out = L.edge_losses_torch(m, r, variables, fg)
    total = sum(g * out[k] for g, k in zip(UPSTREAM, TERMS))
    dm, dr = torch.autograd.grad(total, [m, r])
    masked = T.mask_dead_rows({"means3D": dm, "unnorm_rotations": dr}, alive)
    return ([float(out[k].detach()) for k in TERMS],
            masked["means3D"].numpy(), masked["unnorm_rotations"].numpy())


def _assert_grad_close(got, want, name):
    scale = np.abs(want).max()
    err = np.abs(got - want)
    bound = 2e-6 * scale + 2e-6 * np.abs(want)
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert (err <= bound).all(), (name, worst, got[worst], want[worst],
                                  scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_plain_terms(case):
    seed, cap, n_pre, k, full_plan, dead_nan = CASES[case]
    means, rots, variables, fg, alive = edge_graph(
        seed, cap, n_pre, k, full_plan=full_plan, dead_nan=dead_nan)
    n_dst = variables["edge_row_ptr"].shape[0] - 1
    assert n_dst == (cap if full_plan else -(-n_pre // 8) * 8)
    losses, count, dm, dr = p1_model(means, rots, variables, fg, UPSTREAM)
    want, want_dm, want_dr = _plain(means, rots, variables, fg, alive)
    idx = variables["neighbor_indices"]
    assert count == int((fg[:, None] & (idx >= 0)).sum())
    np.testing.assert_allclose(losses, want, rtol=1e-6, atol=0)
    a = alive.numpy()[:, None]
    dm, dr = np.where(a, dm, 0.0), np.where(a, dr, 0.0)
    assert np.isfinite(dm).all() and np.isfinite(dr).all()
    _assert_grad_close(dm, want_dm, "means")
    _assert_grad_close(dr, want_dr, "rots")
    # rows past the plan's prefix and dead rows get exact zeros
    assert not dm[n_dst:].any() and not dr[n_dst:].any()
    assert not dm[~alive.numpy()].any() and not dr[~alive.numpy()].any()
    if dead_nan:
        assert np.isnan(means.numpy()).any()


def test_model_counts_no_edge_of_a_masked_row():
    """Every edge of a row that is not foreground & alive, and every slot
    -1, adds nothing: masking them all gives zero losses and gradients."""
    means, rots, variables, fg, _ = edge_graph(11, 256, 150, 8)
    losses, count, dm, dr = p1_model(means, rots, variables,
                                     torch.zeros_like(fg), UPSTREAM)
    assert count == 0 and not losses.any()
    assert not dm.any() and not dr.any()
    plain = L.edge_losses_torch(means, rots, variables, torch.zeros_like(fg))
    assert all(float(plain[k]) == 0.0 for k in TERMS)


def _full_variables(seed=12, cap=256, n_pre=150, k=8):
    means, rots, variables, fg, alive = edge_graph(seed, cap, n_pre, k)
    rng = np.random.RandomState(seed)
    colors = torch.as_tensor(rng.uniform(size=(cap, 3)).astype(np.float32))
    variables = dict(variables, prev_col=colors * 0.9,
                     init_bg_pts=means + 0.01, init_bg_rot=rots)
    return means, rots, colors, variables, fg, alive


def test_physics_losses_on_cpu_is_plain_and_launches_nothing():
    means, rots, colors, variables, fg, alive = _full_variables()
    before = (P1.edge_losses_cuda.launches, P1.edge_grads_cuda.launches)
    m = means.clone().requires_grad_(True)
    out = L.physics_losses(m, rots, colors, variables, fg, alive)
    torch.autograd.grad(sum(out.values()), [m])
    plain = L.edge_losses_torch(means, rots, variables, fg & alive)
    assert list(out) == ["rigid", "rot", "iso", "floor", "bg",
                         "soft_col_cons"]
    for k in TERMS:
        assert torch.equal(out[k].detach(), plain[k])
    assert (P1.edge_losses_cuda.launches,
            P1.edge_grads_cuda.launches) == before


def test_physics_losses_refuses_other_devices():
    means, rots, colors, variables, fg, alive = _full_variables()
    meta = {k: v.to("meta") for k, v in variables.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        L.physics_losses(means.to("meta"), rots.to("meta"),
                         colors.to("meta"), meta, fg.to("meta"),
                         alive.to("meta"))
    with pytest.raises(ValueError, match="runs on cuda"):
        P1.edge_losses_cuda(means, rots, variables, fg)


@pytest.mark.parametrize("k", (1, 4, 20, 64, 1024))
def test_blocks_hold_at_most_max_edges(k):
    rpb = P1.rows_per_block(k)
    assert 1 <= rpb <= P1.THREADS and rpb * k <= P1.MAX_EDGES
