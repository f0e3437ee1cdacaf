"""``tick_loop_ms.decode`` (LLM scheduler): the mean host time from a tick
job's end on the device worker to the next tick's submission, in the
window before the traced slice: the event loop's emits, the consumers'
wake-ups and the next snapshot."""

from benchmark.core import records


def read(run):
    ticks = records.jobs(run, ("tick",), captured=True)
    if ticks is None:
        return None
    loops = [(b.t_submit - a.t_end) * 1e3 for a, b in zip(ticks, ticks[1:])
             if not (a.captured or b.captured)]
    return records.mean(loops)
