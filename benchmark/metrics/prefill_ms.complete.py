"""``prefill_ms.complete`` (model step): the mean device time of a prefill
job (the prompt's bucket and its first token's draw) in the window before
the traced slice, from the engine's job records."""

from benchmark.core import records


def read(run):
    jobs = records.jobs(run, ("prefill",))
    return None if jobs is None else records.mean(j.device_ms for j in jobs)
