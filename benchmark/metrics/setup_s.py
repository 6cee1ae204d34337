"""Seconds from process start through the warm-up cycles (host clock)."""


def read(run):
    return run.setup_s
