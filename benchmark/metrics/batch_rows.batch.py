"""``batch_rows.batch`` (batcher): rows the segment batchers ran in the
window before the traced slice over their batches there: how full a batch
the dynamic batcher forms."""

from benchmark.core import readers


def read(run):
    got = readers.resnet_batches(run, "pre")
    return None if got is None else got[1] / got[0]
