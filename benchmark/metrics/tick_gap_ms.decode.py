"""``tick_gap_ms.decode`` (device): the device idle of the window before
the traced slice per decode tick, untraced: the sum over the engine's jobs
there of the idle between the previous job's end event and the job's
start event, over the tick jobs."""

from benchmark.core import records


def read(run):
    done = records.jobs(run)
    if done is None:
        return None
    ticks = sum(1 for j in done if j.kind == "tick")
    gaps = [j.gap_ms for j in done]
    if not ticks or None in gaps:
        return None
    return sum(gaps) / ticks
