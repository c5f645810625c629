"""device_idle.eager: the device's idle share of a step, in %: its busy time per
step in the traced window over the step time of the untraced stretch
before it (`readers.idle_share`)."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
