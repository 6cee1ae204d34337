"""Share of the traced auction rounds in which no operation ran on the
card, in %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.rounds or not tr.window_s or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
