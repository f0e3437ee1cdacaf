"""``prefill_pad_share.complete`` (LLM scheduler): the share of the tokens
the prefill and extend jobs of the window before the traced slice ran
that were padding, 1 - true tokens / padded tokens, from the engine's job
records (``pad_share.complete`` works it out from the slice's captured
prefill keys)."""

from benchmark.core import records


def read(run):
    jobs = records.jobs(run, ("prefill", "extend"), captured=True)
    if jobs is None:
        return None
    padded = sum(j.padded for j in jobs)
    return 100.0 * (1.0 - sum(j.tokens for j in jobs) / padded)
