"""Milliseconds per window cycle of the scheduler's host stage
``snapshot`` (``Scheduler.stage_s``, summed over the window's cycles)."""


def read(run):
    if not run.window_cycles:
        return None
    return run.stage_s["snapshot"] / run.window_cycles * 1e3
