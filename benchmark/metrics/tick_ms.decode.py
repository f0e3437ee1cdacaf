"""``tick_ms.decode`` (model step): the seconds of the window before the
traced slice over the tick program's replays in it, in ms: the time a
decode tick takes under load, the admissions between ticks included."""

from benchmark.core import readers


def read(run):
    ticks = readers.replays(run, "tick", "pre")
    if not ticks:
        return None
    return (run.s0 - run.w0) * 1e3 / ticks
