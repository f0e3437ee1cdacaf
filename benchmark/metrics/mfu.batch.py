"""MFU of the batch-scoring cell (model step): the useful work of the
images run in the window before the traced slice at the card's int8 and
bf16 peaks, over its seconds."""

from benchmark.core import readers


def read(run):
    return readers.resnet_mfu(run)
