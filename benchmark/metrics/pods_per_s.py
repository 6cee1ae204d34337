"""Pods bound per second over the window's whole cycles (host clock)."""


def read(run):
    return run.window_binds / run.window_s if run.window_s > 0 else None
