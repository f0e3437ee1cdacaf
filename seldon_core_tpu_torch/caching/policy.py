"""Runtime cacheability: which graph nodes may serve from the cache (port
of ``seldon_core_tpu/caching/policy.py``).

The rule is strict by construction — a cache hit must be provably
byte-identical to the cold path, so only nodes that are **pure tensor
functions** qualify (the same test the graph-plan compiler applies for
fusibility, ``graph/plan.py extract_stage``), further narrowed by
determinism:

- ROUTER nodes never cache: branch choice is data-dependent control flow
  and RNG/learned routers (RANDOM_ABTEST, EPSILON_GREEDY — registered
  non-deterministic in ``models/__init__.py``) must re-run per request;
- components declaring ``deterministic = False`` never cache —
  stateful/learning components like the Mahalanobis outlier scorer change
  answer with traffic;
- a node's ``cacheable`` BOOL parameter can only NARROW: ``false`` opts
  a safe node out; ``true`` on an unsafe node silently bypasses — the
  runtime never lets an annotation poison the cache.

Caching applies at **maximal cacheable subtrees**: the largest subtrees
whose every node passes the test serve as single cache units (one key,
one stored response, one meta-delta replay), mirroring how the plan
compiler fuses maximal segments.  In fused-plan mode the segments ARE
those units, so the engine caches per segment instead.
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "node_cacheable",
    "subtree_cacheable",
    "maximal_cacheable_roots",
    "impl_deterministic",
]


def impl_deterministic(impl: Any) -> bool:
    """Live-object determinism: a component (or its wrapped user object)
    may declare ``deterministic = False``; absence means deterministic —
    but only pure-fn nodes ever reach this check."""
    for obj in (impl, getattr(impl, "handle", None)):
        if obj is None:
            continue
        user = getattr(obj, "user", obj)
        if getattr(user, "deterministic", True) is False:
            return False
    return True


def node_cacheable(node: Any) -> bool:
    """One engine ``_Node``: pure tensor function AND deterministic AND
    not opted out via the ``cacheable`` parameter."""
    if node.unit.parameters.get("cacheable") is False:
        return False
    if node.type == "ROUTER":
        return False
    if not impl_deterministic(node.impl):
        return False
    from seldon_core_tpu_torch.graph.plan import extract_stage

    return extract_stage(node) is not None


def subtree_cacheable(node: Any) -> bool:
    return node_cacheable(node) and all(
        subtree_cacheable(c) for c in node.children
    )


def maximal_cacheable_roots(root: Any) -> list[Any]:
    """Roots of the maximal fully-cacheable subtrees — the walk-mode cache
    units.  Descendants of a returned node are never returned (no nested
    double-caching)."""
    out: list[Any] = []

    def visit(node: Any) -> None:
        if subtree_cacheable(node):
            out.append(node)
            return
        for c in node.children:
            visit(c)

    visit(root)
    return out
