"""render_ms: the device time of the render phases of a replayed step: from
the `render` mark to `image_loss` (activation, projection, emission, sort,
K1) plus from `render_bwd` to `update` (K2 and the gradients back to the
parameters), in ms; a mean over the marked stretch of `spans.probe`
(`portbench/spans.py`)."""

from portbench import spans

probe = spans.probe


def read(run):
    return spans.read(run, "render_ms")
