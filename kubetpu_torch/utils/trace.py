"""The flight recorder's call sites, without the recorder.

The JAX package records every cycle's stages into a flight recorder
(kubetpu/utils/trace.py ``Trace``: ``stage``, ``finish``, ``rec``), which
/debug/flightz serves and the ring-slot tags of the pipelined drain
annotate.  That recorder is not ported yet (ROADMAP queue 1 item 11);
the scheduler and the pipelined executor call this stand-in at the same
places, so the recorder can be filled in behind them.  Disarmed, as the
reference's recorder is by default, every call does nothing.
"""

from __future__ import annotations

import contextlib


class NoTrace:
    """A cycle's trace with the recorder disarmed: ``rec`` is None, a
    stage is an empty context and ``finish`` records nothing."""

    rec = None

    def stage(self, name: str, **meta):
        return contextlib.nullcontext()

    def finish(self, **meta) -> None:
        pass


NO_TRACE = NoTrace()
