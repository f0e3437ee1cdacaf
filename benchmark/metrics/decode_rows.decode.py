"""``decode_rows.decode`` (LLM scheduler): tokens the decode ticks made in
the window before the traced slice over the tick program's replays there:
the mean number of busy slots a tick carried."""

from benchmark.core import readers


def read(run):
    ticks = readers.replays(run, "tick", "pre")
    if not ticks:
        return None
    return len(readers.decode_contexts(run, "pre")) / ticks
