"""``tick_device_ms.decode`` (model step): the mean device time of a decode
tick job in the window before the traced slice, from the CUDA event pair
the engine records around each job (its job records)."""

from benchmark.core import records


def read(run):
    ticks = records.jobs(run, ("tick",))
    return None if ticks is None else records.mean(
        j.device_ms for j in ticks)
