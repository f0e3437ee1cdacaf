"""What the per-layer readers share: a span's requests, tokens and program
counters, and the work they stand for (``costs/``).  Every function
returns None where the span holds nothing to read.

Two spans of a traced run: the slice (``"slice"``, ``[s0, s1)``), which
the profiler watched, and the window before it (``"pre"``, ``[w0, s0)``),
which it did not.  Rooflines need the device trace and read the slice;
rates of work (MFU, rows a tick, ms a tick, rows a batch)
read the span before it, where the tracer's own cost (each CUDA-graph
launch instrumented node by node) does not slow the host."""

from __future__ import annotations

from typing import Optional

from benchmark.costs import k1, k2, k3, resnet50, transformer

__all__ = ["span", "replays", "decode_contexts", "prefills", "llm_roofline",
           "llm_mfu", "resnet_batches", "resnet_roofline",
           "resnet_mfu"]


def span(run, edge: str) -> tuple:
    """``(start, end)`` on the host clock of ``"slice"`` or ``"pre"``."""
    return (run.s0, run.s1) if edge == "slice" else (run.w0, run.s0)


def replays(run, program: str, edge: str = "slice") -> Optional[int]:
    """Replays (captured or eager runs) of ``program`` in ``edge``."""
    def count(c):
        p = c.get(program)
        return 0 if p is None else p["replays"] + p["eager_runs"]
    return run.delta(edge, count)


def decode_contexts(run, edge: str = "slice") -> list:
    """The context length of every token a decode tick made in the span:
    a request's token j >= 1 attended over its prompt and j tokens."""
    a, b = span(run, edge)
    out = []
    for r in run.requests:
        for j, t in enumerate(r.token_times[1:], start=1):
            if a <= t < b:
                out.append(r.prompt_len + j)
    return out


def _buckets(run) -> list:
    """The prefill program's captured (rows, bucket) keys at the slice's
    end: the buckets the port pads prompts to."""
    prog = (run.counters.get("slice_end") or {}).get("prefill")
    if not prog:
        return []
    keys = []
    for k in prog["keys"]:
        rows, bucket = (int(x) for x in k.strip("()").split(","))
        keys.append((rows, bucket))
    return sorted(keys)


def prefills(run, edge: str = "slice") -> Optional[list]:
    """``(prompt tokens, padded bucket)`` of each request whose prefill
    answered in the span (its first token), the bucket the smallest
    captured one-row key that holds the prompt.  None when the span's
    prefill replays and these requests differ by more than two (the
    edges), or when a prompt has no captured bucket."""
    a, b = span(run, edge)
    firsts = [r for r in run.requests
              if r.t_first is not None and a <= r.t_first < b]
    n = replays(run, "prefill", edge)
    if n is None or abs(n - len(firsts)) > 2:
        return None
    buckets = [b for rows, b in _buckets(run) if rows == 1]
    out = []
    for r in firsts:
        fit = [b for b in buckets if b >= r.prompt_len]
        if not fit:
            return None
        out.append((r.prompt_len, min(fit)))
    return out


def _pct(ideal: float, actual: Optional[float]) -> Optional[float]:
    if actual is None or actual <= 0 or ideal <= 0:
        return None
    return 100.0 * ideal / actual


def llm_roofline(run, kernel: str) -> Optional[float]:
    """A kernel's share of its roofline over the slice: the least time its
    launches in the slice need on the card over their device time."""
    if run.peaks is None or run.slice is None:
        return None
    d = run.dims
    if kernel == "k1":
        ticks = replays(run, "tick")
        pf = prefills(run)
        if ticks is None or pf is None:
            return None
        rows = run.config["engine"]["max_slots"]
        ideal = k1.ideal_s(transformer.k1_tick(d, rows), run.peaks) * ticks
        for _, bucket in pf:
            ideal += k1.ideal_s(transformer.k1_prefill(d, bucket), run.peaks)
        pats = k1.KERNELS
    elif kernel == "k2":
        ideal = sum(k2.ideal_s(transformer.k2_token(d, c), run.peaks)
                    for c in decode_contexts(run))
        pats = k2.KERNELS
    else:
        pf = prefills(run)
        if pf is None:
            return None
        ideal = sum(k3.ideal_s(transformer.k3_prefill(d, b), run.peaks)
                    for _, b in pf)
        pats = k3.KERNELS
    return _pct(ideal, run.slice.kernel_s(pats))


def llm_mfu(run) -> Optional[float]:
    """The useful model work of the window before the slice at the card's
    peaks over its seconds: each generated token at its context and each
    prefill at its true length, int8 products against the int8 peak and
    attention against the bf16 peak."""
    if run.peaks is None or run.slice is None:
        return None
    d = run.dims
    pf = prefills(run, "pre")
    if pf is None:
        return None
    i8 = f16 = 0.0
    for c in decode_contexts(run, "pre"):
        a, b = transformer.decode_token_work(d, c)
        i8, f16 = i8 + a, f16 + b
    for L, _ in pf:
        a, b = transformer.prefill_work(d, L)
        i8, f16 = i8 + a, f16 + b
    t = i8 / run.peaks["int8_ops"] + f16 / run.peaks["bf16_flops"]
    return _pct(t, run.s0 - run.w0)


def resnet_batches(run, edge: str = "slice") -> Optional[tuple]:
    """``(batches, rows, padded rows)`` the segment batchers ran in the
    span."""
    b = run.delta(edge, lambda c: c["batches"])
    if not b:
        return None
    return (b, run.delta(edge, lambda c: c["rows"]),
            run.delta(edge, lambda c: c["pad_rows"]))


def _resnet_shape(run) -> dict:
    c = run.config
    return {"stage_sizes": tuple(c["stage_sizes"]), "image": c["image_size"],
            "classes": c["num_classes"]}


def resnet_roofline(run) -> Optional[float]:
    """K1's share of its roofline over the slice: each batch's forward at
    the slice's mean bucket (rows + pad rows over batches)."""
    got = resnet_batches(run)
    if run.peaks is None or run.slice is None or got is None:
        return None
    batches, rows, pad = got
    bucket = (rows + pad) / batches
    ideal = batches * k1.ideal_s(
        resnet50.k1_forward(bucket, **_resnet_shape(run)), run.peaks)
    return _pct(ideal, run.slice.kernel_s(k1.KERNELS))


def resnet_mfu(run) -> Optional[float]:
    """The useful work of the images the batchers ran in the window before
    the slice at the peaks over its seconds (padded rows are no useful
    work)."""
    got = resnet_batches(run, "pre")
    if run.peaks is None or run.slice is None or got is None:
        return None
    i8, f16 = resnet50.image_work(**_resnet_shape(run))
    t = got[1] * (i8 / run.peaks["int8_ops"] + f16 / run.peaks["bf16_flops"])
    return _pct(t, run.s0 - run.w0)
