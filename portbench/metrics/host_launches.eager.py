"""host_launches.eager: the host's kernel and graph launch calls per step in
the traced window, from the profiler's runtime events."""


def read(run):
    return run.trace.launches / run.steps if run.steps else None
