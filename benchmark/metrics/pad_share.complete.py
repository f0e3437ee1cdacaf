"""``pad_share.complete`` (LLM scheduler): the share of the tokens the
slice's prefills ran that were padding: 1 - prompt tokens / padded
bucket tokens, the buckets the port's captured prefill keys."""

from benchmark.core import readers


def read(run):
    pf = readers.prefills(run)
    if not pf:
        return None
    return 100.0 * (1.0 - sum(L for L, _ in pf) / sum(b for _, b in pf))
