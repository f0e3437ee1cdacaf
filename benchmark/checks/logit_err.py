"""A classifier's answers against the plain reference: over a sample of
answered images, the largest error of the program's log-probabilities
against the reference's logits, each centred over the classes (a
softmax's answers fix logits up to a constant), as a share of the spread
of that image's reference logits (their standard deviation).

A sound int8 forward moves each logit by a small share of that spread; a
wrong row, kernel or answer moves it by about the spread itself.

The control (``tools/control.py``) is judged the same way: its answers,
put in the program's place, are the softmax of the reference computed in
the precision below the configuration's.
"""

from __future__ import annotations

import torch

__all__ = ["errors", "from_probs", "compare", "control_answers"]


def errors(log_probs: torch.Tensor, ref_logits: torch.Tensor
           ) -> torch.Tensor:
    """Per image, ``max |centred log_probs - centred ref_logits| /
    std(ref_logits)``."""
    a = log_probs.double()
    z = ref_logits.double()
    d = (a - a.mean(dim=1, keepdim=True)) - (z - z.mean(dim=1, keepdim=True))
    return d.abs().amax(dim=1) / z.std(dim=1)


def from_probs(probs: torch.Tensor) -> torch.Tensor:
    """Log-probabilities of a softmax's answers (a zero, which no finite
    logit gives, reads as 1e-300)."""
    return torch.log(probs.double().clamp_min(1e-300))


def compare(probs: torch.Tensor, ref_logits: torch.Tensor,
            limit: float) -> dict:
    e = errors(from_probs(probs), ref_logits)
    value = float(e.max()) if e.numel() else float("inf")
    return {"logit_err": {"value": value, "limit": limit}}


def control_answers(ctl_logits: torch.Tensor) -> torch.Tensor:
    """The control's answers in the program's place: the softmax of its
    logits, as the deployment answers (in float64, so that no class
    underflows to a zero the program's answers would not hold)."""
    return torch.softmax(ctl_logits.double(), dim=1)
