"""host_syncs.eager: the host's synchronising runtime calls (stream, device
and event synchronise, blocking copies) per step in the traced window."""


def read(run):
    return run.trace.syncs / run.steps if run.steps else None
