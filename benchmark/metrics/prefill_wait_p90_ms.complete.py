"""``prefill_wait_p90_ms.complete`` (LLM scheduler): the 90th percentile,
over the requests that arrived in the window before the traced slice, of
their wait from arrival in the engine to the start of their first prefill
job: the slot and page waits and the queue behind other jobs on the
engine's one device worker (a p95 of about 195 requests would rest on
fewer than ten beyond it)."""

from benchmark.core import records, stats


def read(run):
    reqs = records.requests(run)
    if reqs is None:
        return None
    waits = [(r.jobs[0].t_start - r.t_arrive) * 1e3 for r in reqs
             if r.jobs and r.jobs[0].t_start is not None]
    return stats.percentile(waits, 90) if waits else None
