"""image_loss_ms: the device time of the image losses of a replayed step: from
the `image_loss` mark to `physics` (camera correction, image, segmentation
and feature losses) plus from `image_loss_bwd` to `render_bwd` (their
backward), in ms; a mean over the marked stretch of `spans.probe`
(`portbench/spans.py`)."""

from portbench import spans

probe = spans.probe


def read(run):
    return spans.read(run, "image_loss_ms")
