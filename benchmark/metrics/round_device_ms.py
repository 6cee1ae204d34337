"""Device milliseconds per auction round over the traced rounds: the union
of the device operations' intervals over the rounds."""


def read(run):
    tr = run.trace
    if tr is None or not tr.rounds or tr.busy_s <= 0:
        return None
    return tr.busy_s / tr.rounds * 1e3
