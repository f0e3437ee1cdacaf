"""The served model's tokens against the plain reference: the widest gap,
over a sample of finished requests, by which a served token's reference
logit lies below the reference's best at its position.

Every served token is greedy, so a sound program serves the reference's
best token up to a near-tie that its lower precision can flip; a wrong
token, cache or kernel serves one far below it.  The reference runs once
over each sampled prompt with its served tokens (its logits at the
prompt's last position and after each served token but the last).

The control (``tools/control.py``) is judged the same way: its answers,
put in the program's place, are the tokens that the reference computed in
the precision below the configuration's puts first at each of the same
positions (the served tokens stay the context, ``"context"``).
"""

from __future__ import annotations

import torch

__all__ = ["gaps", "compare", "control_answers"]


def _positions(sample: list) -> tuple:
    seqs = [list(r["prompt"]) + list(r.get("context", r["served"])[:-1])
            for r in sample]
    starts = [len(r["prompt"]) - 1 for r in sample]
    return seqs, starts


def gaps(ref, w, d, sample: list) -> list:
    """Per sampled request, the gap of each served token (a float32
    tensor)."""
    seqs, starts = _positions(sample)
    out = []
    for lg, r in zip(ref.logits(w, d, seqs, starts), sample):
        served = torch.as_tensor(r["served"], device=lg.device)[:, None]
        out.append((lg.max(dim=1).values - lg.gather(1, served)[:, 0]).cpu())
    return out


def compare(ref, w, d, sample: list, limit: float) -> tuple:
    """``({"logit_gap": {"value", "limit"}}, tokens compared)``; the gap
    of an empty sample is infinite (nothing was shown correct)."""
    g = gaps(ref, w, d, sample)
    widest = max(float(x.max()) for x in g) if g else float("inf")
    return ({"logit_gap": {"value": widest, "limit": limit}},
            sum(int(x.numel()) for x in g))


def control_answers(ref, w, d, sample: list) -> list:
    """The control's answers in the program's place: per sampled request,
    at each position of its prompt and served tokens, the token that the
    reference in the precision below the configuration's (``control=True``:
    int4 weights where it states int8) puts first."""
    seqs, starts = _positions(sample)
    return [{"prompt": r["prompt"], "context": r["served"],
             "served": lc.argmax(dim=1).tolist()}
            for lc, r in zip(ref.logits(w, d, seqs, starts, control=True),
                             sample)]
