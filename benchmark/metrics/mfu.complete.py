"""MFU of a language-model cell (model step): the useful model work of the
window before the traced slice (each generated token at its context, each
prompt at its true length) at the card's int8 and bf16 peaks, over its
seconds."""

from benchmark.core import readers


def read(run):
    return readers.llm_mfu(run)
