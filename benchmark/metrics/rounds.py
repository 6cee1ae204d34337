"""Mean auction rounds per window cycle (``Scheduler.gang_rounds``)."""


def read(run):
    return sum(run.rounds) / len(run.rounds) if run.rounds else None
