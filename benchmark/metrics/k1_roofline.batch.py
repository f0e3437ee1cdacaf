"""K1's share of its roofline in the batch-scoring cell (kernels): the
least time of the slice's forwards' K1 launches (the 1x1 convs and the
head at the mean padded bucket) on the card, over K1's device time."""

from benchmark.core import readers


def read(run):
    return readers.resnet_roofline(run)
