"""physics_step_ms: the device time of the physics losses inside a replayed
step: from the `physics` mark to `image_loss_bwd` (the losses, the weighted
sum and their backward), in ms; a mean over the marked stretch of
`spans.probe` (`portbench/spans.py`)."""

from portbench import spans

probe = spans.probe


def read(run):
    return spans.read(run, "physics_step_ms")
