"""window_redo_share: the windows the program's `StepWindow` ran again at a
larger pair capacity (`stats["redos"]`) over the windows run, in %."""


def read(run):
    st = run.window_stats
    if not st or not st["windows"]:
        return None
    return 100.0 * st["redos"] / st["windows"]
