"""``tick_context.decode`` (kernels): the mean context tokens a decode
tick job attended in the window before the traced slice (each active
row's position + 1, summed over its rows: kernel K2's work in the tick),
from the engine's job records."""

from benchmark.core import records


def read(run):
    ticks = records.jobs(run, ("tick",), captured=True)
    return None if ticks is None else records.mean(
        j.context for j in ticks)
