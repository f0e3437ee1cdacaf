"""K3's share of its roofline (kernels): the least time of the causal
attention of every prefill in the slice, over its padded bucket, on the
card, over K3's device time in the slice."""

from benchmark.core import readers


def read(run):
    return readers.llm_roofline(run, "k3")
