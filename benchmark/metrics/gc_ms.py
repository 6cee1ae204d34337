"""Milliseconds per window cycle in which the interpreter's cyclic garbage
collector ran (every generation; ``gc.callbacks``, host clock): the pauses
that make the fill cells' rates spread from run to run."""


def read(run):
    if not run.window_cycles:
        return None
    return run.gc_s / run.window_cycles * 1e3
