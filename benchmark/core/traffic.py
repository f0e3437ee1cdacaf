"""The one traffic generator: a cell's ``traffic`` parameters and a seed in,
the requests out.

Every seed draws the same multiset of sizes and of gaps between arrivals,
in another order: lengths are the distribution's quantiles at ``(i + 0.5)
/ n`` (stratified), gaps the exponential's, and the seed permutes them and
draws the token ids.  So two seeds ask for the same work and differ in its
order and contents, and a run's spread is the system's, not the draw's.

Parameters (a cell's ``traffic``):

- ``loop``: ``"closed"`` (``clients`` clients, each sending its next
  request when the last has answered, their first sends spread evenly over
  ``stagger_s``; ``rounds`` requests drawn for each) or ``"open"``
  (arrivals at ``rate`` per second, Poisson gaps, sent whether or not
  earlier requests have answered, over the warm-up and the window);
- ``prompt``, ``output``: ``{"median", "sigma", "min", "max"}`` of a
  lognormal length in tokens, clipped;
- ``rows_per_request``: rows (images) a request carries, for a model that
  takes rows rather than tokens;
- ``order``: ``"seeded"`` (the default: the seed orders the sizes and
  gaps) or ``"fixed"`` (one order for every seed, the seed drawing only
  the contents: token ids and weights).  An open loop's tail follows the
  order of its bursts and long prompts, so a cell whose tails are judged
  takes the fixed order: its runs differ by the system's spread alone.

A cell's driver names the loops it runs and the keys it reads in each
(``TRAFFIC_KEYS``); :func:`validate` refuses any other loop, key or value,
so a cell cannot ask for traffic that no code makes.
"""

from __future__ import annotations

import math
import statistics
from typing import Optional

import numpy as np

__all__ = ["rng_of", "lognormal_lengths", "exponential_gaps",
           "closed_loop", "open_loop", "token_ids", "validate"]

_NORMAL = statistics.NormalDist()

#: the values of the keys that name a choice
ORDERS = ("seeded", "fixed")
#: the keys of a length distribution (``prompt``, ``output``)
LENGTH_KEYS = ("median", "sigma", "min", "max")


def validate(traffic: dict, keys: dict) -> dict:
    """``traffic`` if its ``loop`` is one of ``keys`` (loop -> the keys a
    driver reads in that loop) and it holds no other key, its ``order`` is
    one of :data:`ORDERS` and each length distribution exactly
    :data:`LENGTH_KEYS`; else ValueError."""
    loop = traffic.get("loop")
    if loop not in keys:
        raise ValueError(f"traffic loop {loop!r} is not one of "
                         f"{sorted(keys)}")
    unknown = sorted(set(traffic) - set(keys[loop]) - {"loop"})
    if unknown:
        raise ValueError(f"traffic keys that nothing reads in a {loop} "
                         f"loop: {unknown}")
    if traffic.get("order", "seeded") not in ORDERS:
        raise ValueError(f"traffic order {traffic['order']!r} is not one "
                         f"of {list(ORDERS)}")
    for key in ("prompt", "output"):
        if key in traffic and sorted(traffic[key]) != sorted(LENGTH_KEYS):
            raise ValueError(f"traffic {key} holds {sorted(traffic[key])}, "
                             f"not {sorted(LENGTH_KEYS)}")
    return traffic


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """A generator for one purpose (``stream``) of one seed; any whole
    number is a seed."""
    return np.random.default_rng([int(stream), int(seed) & (2**64 - 1),
                                  int(seed) >> 64])


def lognormal_lengths(n: int, dist: dict) -> np.ndarray:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of a lognormal of
    ``dist["median"]`` and ``dist["sigma"]``, clipped to ``[min, max]``;
    ascending."""
    q = (np.arange(n) + 0.5) / n
    z = np.array([_NORMAL.inv_cdf(float(p)) for p in q])
    x = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    """``n`` gaps at the quantiles ``(i + 0.5) / n`` of an exponential of
    mean ``1 / rate`` seconds."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def token_ids(rng: np.random.Generator, n: int, vocab: int) -> list:
    """``n`` ids uniform over ``[1, vocab)`` (0 is no id a prompt needs)."""
    return rng.integers(1, vocab, size=int(n), dtype=np.int64).tolist()


def _sizes(traffic: dict, n: int, rng: np.random.Generator) -> list:
    """``n`` (prompt, output) pairs: each length's stratified multiset,
    each permuted on its own."""
    out = []
    cols = []
    for key in ("prompt", "output"):
        if key in traffic:
            cols.append(rng.permutation(lognormal_lengths(n, traffic[key])))
        else:
            cols.append(np.zeros(n, np.int64))
    for p, o in zip(*cols):
        out.append((int(p), int(o)))
    return out


def closed_loop(traffic: dict, seed: int) -> list:
    """Per client, its start offset in seconds and its requests, each
    ``{"prompt_len", "n_out"}``.  The clients' k-th requests together are
    the same multiset of sizes for every seed (round k takes every
    ``rounds``-th value of the stratified lengths), dealt to the clients
    in the seed's order; so a window that sees each client's first few
    requests sees the same work under every seed."""
    clients = int(traffic["clients"])
    rounds = int(traffic.get("rounds", 1))
    rng = rng_of(0 if traffic.get("order") == "fixed" else seed, 1)
    cols = {}
    for key in ("prompt", "output"):
        if key in traffic:
            vals = lognormal_lengths(clients * rounds, traffic[key])
            cols[key] = [rng.permutation(vals[k::rounds])
                         for k in range(rounds)]
    stagger = float(traffic.get("stagger_s", 0.0))
    out = []
    for c in range(clients):
        reqs = [{"prompt_len": int(cols["prompt"][k][c])
                 if "prompt" in cols else 0,
                 "n_out": int(cols["output"][k][c])
                 if "output" in cols else 0} for k in range(rounds)]
        out.append({"start_s": stagger * c / clients, "requests": reqs})
    return out


def open_loop(traffic: dict, seed: int, seconds: float,
              rate: Optional[float] = None) -> list:
    """Arrivals over ``seconds`` at ``rate`` (default the cell's): each
    ``{"at_s", "prompt_len", "n_out"}``, ``at_s`` from the load's start."""
    rate = float(traffic["rate"] if rate is None else rate)
    n = max(int(math.ceil(rate * seconds)), 1)
    rng = rng_of(0 if traffic.get("order") == "fixed" else seed, 2)
    gaps = rng.permutation(exponential_gaps(n, rate))
    sizes = _sizes(traffic, n, rng)
    at = np.cumsum(gaps) - gaps[0]
    return [{"at_s": float(t), "prompt_len": p, "n_out": o}
            for t, (p, o) in zip(at, sizes) if t < seconds]
