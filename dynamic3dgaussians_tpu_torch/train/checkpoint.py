"""Full-state training checkpoints: one torch file per saved step.

Port of `dynamic3dgaussians_tpu/train/checkpoint.py`. The reference keeps
its steps with orbax; here each step is one `torch.save` file,
`<directory>/step_<n>.pt`, holding the parameters, the Adam state (mu, nu,
step), the training variables and the cursor {t, i}, all on the CPU. A
file is written under a temporary name and renamed into place, so a crash
never leaves a half-written step behind, and read with
`torch.load(weights_only=True)`. The newest `max_to_keep` steps are kept,
as orbax keeps them.

`load` returns the reference's tuple (step, params, opt_state, variables,
cursor), with the tensors on the device the caller names.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from dynamic3dgaussians_tpu_torch.device import DeviceLike, resolve_device
from dynamic3dgaussians_tpu_torch.train.optim import AdamState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _to_cpu(tree: Dict) -> Dict:
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def _to_device(tree: Dict, dev: torch.device) -> Dict:
    return {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


class CheckpointManager:
    """Saves and restores training state; step = the global step count."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self) -> List[int]:
        """The saved steps, ascending."""
        found = (_STEP_FILE.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, params, opt_state: AdamState, variables,
             cursor: Dict[str, int], wait: bool = False):
        """Write step `step`; `wait` is accepted for the reference's
        signature (the write is synchronous)."""
        del wait
        state = {"params": _to_cpu(params), "opt_mu": _to_cpu(opt_state.mu),
                 "opt_nu": _to_cpu(opt_state.nu),
                 "opt_step": opt_state.step.detach().cpu(),
                 "variables": _to_cpu(variables),
                 "cursor": {k: int(v) for k, v in cursor.items()}}
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def load(self, step: Optional[int] = None, device: DeviceLike = None):
        """(step, params, opt_state, variables, cursor) of `step` (default:
        the latest) on `device` (default `cuda`), or None when no step is
        saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        dev = resolve_device(device)
        state = torch.load(self.path(step), map_location="cpu",
                           weights_only=True)
        opt_state = AdamState(mu=_to_device(state["opt_mu"], dev),
                              nu=_to_device(state["opt_nu"], dev),
                              step=state["opt_step"].to(dev))
        cursor = {k: int(v) for k, v in state["cursor"].items()}
        return (int(step), _to_device(state["params"], dev), opt_state,
                _to_device(state["variables"], dev), cursor)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def close(self):
        """Nothing is pending: every save has finished when it returns."""
