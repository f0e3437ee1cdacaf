"""K1's share of its roofline in a language-model cell (kernels): the
least time of the slice's K1 launches (every tick's products over all
slots, every prefill's over its padded bucket) on the card, over K1's
device time in the slice."""

from benchmark.core import readers


def read(run):
    return readers.llm_roofline(run, "k1")
