"""K2's share of its roofline (kernels): the least time of the attention
of every token the slice's ticks made, over its context, on the card,
over K2's device time in the slice."""

from benchmark.core import readers


def read(run):
    return readers.llm_roofline(run, "k2")
