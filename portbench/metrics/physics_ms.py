"""physics_ms: the physics losses (`train/losses.py::physics_losses`) and
their gradient alone, on the program's state after the traced window:
median ms between CUDA events over 5 runs after one untimed run."""

import torch

from portbench.trace import cuda_events_ms


def probe(run):
    from dynamic3dgaussians_tpu_torch.models import gaussians as G
    from dynamic3dgaussians_tpu_torch.train import losses as L
    params, variables = run.program.params, run.program.variables
    leaves = {k: params[k].detach().requires_grad_(True)
              for k in ("means3D", "unnorm_rotations", "rgb_colors")}

    def once():
        act = G.activated(dict(params, **leaves), variables["alive"])
        out = L.physics_losses(act["means3d"], act["rotations"],
                               leaves["rgb_colors"], variables,
                               params["seg_colors"][:, 0] > 0.5,
                               variables["alive"])
        torch.autograd.grad(sum(out.values()), list(leaves.values()))
    run.probes["physics_ms"] = cuda_events_ms(once, 5, run.device)


def read(run):
    return run.probes.get("physics_ms")
