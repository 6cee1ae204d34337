"""Share of the traced whole cycles in which no operation ran on the card:
one less the union of the device operations' intervals over the window,
in %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.cycles or not tr.window_s or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
