"""``tick_rows.decode`` (LLM scheduler): the mean active rows of a decode
tick job in the window before the traced slice, from the engine's job
records: the busy slots each tick carried, counted where the tick is
made (``decode_rows.decode`` works the same out from the tokens)."""

from benchmark.core import records


def read(run):
    ticks = records.jobs(run, ("tick",), captured=True)
    return None if ticks is None else records.mean(j.rows for j in ticks)
