"""Milliseconds per window cycle of the scheduler's host stage
``auction`` (``Scheduler.stage_s``, summed over the window's cycles)."""


def read(run):
    if not run.window_cycles:
        return None
    return run.stage_s["auction"] / run.window_cycles * 1e3
