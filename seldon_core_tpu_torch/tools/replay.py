"""Flight-recorder replay: re-issue a captured request, verify parity.

The gateway's flight recorder (docs/observability.md) keeps the raw
request body of every recent request (bounded ring, bodies capped at
``flightrecorder.REQUEST_CAP_BYTES``).  This tool closes the loop: pull
a record by puid — from a running gateway's ``/admin/flightrecorder``
endpoint or from a saved JSON dump — and POST the captured bytes back
at a deployment, either to reproduce an incident or to check that two
runtimes (canonically: ``seldon.io/graph-plan`` walk vs fused) answer
with byte-identical payloads.

Responses legitimately differ in per-request metadata (a fresh puid is
minted per call, routing tags carry timing), so parity is judged on the
canonicalized body with volatile ``meta`` fields dropped — ``--strict``
demands raw byte equality instead.

Usage::

    python -m seldon_core_tpu_torch.tools.replay --from http://gw:8080 \
        --puid 3f2a... --to http://gw:8080
    python -m seldon_core_tpu_torch.tools.replay --record flight.json \
        --to http://walk:8000 --compare http://fused:8000

No external dependencies: stdlib ``urllib`` only, same as the repo's
other admin tooling.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional, Tuple

__all__ = [
    "fetch_record",
    "load_record",
    "replay_record",
    "canonical_body",
    "artifact_source",
    "device_plane_tag",
    "compare_responses",
    "main",
]

#: meta fields that are freshly minted per request and therefore never
#: byte-stable across a replay (messages.Meta)
_VOLATILE_META = ("puid", "tags", "metrics", "requestPath", "routing")


def _http(url: str, body: Optional[bytes] = None,
          content_type: str = "application/json",
          token: str = "", timeout_s: float = 30.0) -> Tuple[int, bytes]:
    headers = {"Content-Type": content_type} if body is not None else {}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def fetch_record(base_url: str, puid: str, token: str = "",
                 timeout_s: float = 30.0) -> dict:
    """Pull one flight record by puid from ``/admin/flightrecorder``."""
    url = (base_url.rstrip("/") + "/admin/flightrecorder?"
           + urllib.parse.urlencode({"puid": puid, "n": 1}))
    status, body = _http(url, token=token, timeout_s=timeout_s)
    if status != 200:
        raise RuntimeError(
            f"flight recorder fetch failed: HTTP {status}: "
            f"{body[:200].decode('utf-8', 'replace')}"
        )
    doc = json.loads(body)
    records = doc.get("records", [])
    if not records:
        raise RuntimeError(f"no flight record for puid {puid!r}")
    return records[0]


def load_record(path: str, puid: str = "") -> dict:
    """Load a record from a saved JSON dump — either one record, a
    ``{"records": [...]}`` endpoint response, or a JSON-lines file."""
    with open(path) as f:
        text = f.read().strip()
    candidates: list = []
    try:
        doc = json.loads(text)
        if isinstance(doc, dict) and "records" in doc:
            candidates = list(doc["records"])
        elif isinstance(doc, list):
            candidates = list(doc)
        elif isinstance(doc, dict):
            candidates = [doc]
    except ValueError:
        for line in text.splitlines():
            line = line.strip()
            if line:
                try:
                    candidates.append(json.loads(line))
                except ValueError:
                    continue
    if puid:
        candidates = [r for r in candidates if r.get("puid") == puid]
    if not candidates:
        raise RuntimeError(
            f"no flight record in {path!r}"
            + (f" with puid {puid!r}" if puid else "")
        )
    return candidates[0]


def replay_record(record: dict, base_url: str, path: str = "",
                  token: str = "", timeout_s: float = 30.0
                  ) -> Tuple[int, bytes]:
    """POST the record's captured body at ``base_url`` and return
    ``(status, response_bytes)``.  The captured path wins unless an
    explicit ``path`` overrides it (replaying a gateway capture against
    a bare engine, whose prediction route differs)."""
    req = record.get("request")
    if not isinstance(req, dict) or "body" not in req:
        raise RuntimeError(
            "record has no captured request body (engine-side records "
            "carry timings only — replay from a gateway capture, or a "
            "record whose body exceeded the capture cap)"
        )
    target = base_url.rstrip("/") + (path or req.get("path") or
                                     "/api/v1.0/predictions")
    return _http(
        target,
        body=req["body"].encode("utf-8"),
        content_type=req.get("contentType") or "application/json",
        token=token,
        timeout_s=timeout_s,
    )


def canonical_body(body: bytes) -> bytes:
    """Canonical form for parity: parse as JSON, drop volatile per-request
    meta fields, re-serialize with sorted keys.  Non-JSON bodies are
    returned verbatim."""
    try:
        doc = json.loads(body)
    except ValueError:
        return body
    if isinstance(doc, dict) and isinstance(doc.get("meta"), dict):
        doc["meta"] = {k: v for k, v in doc["meta"].items()
                       if k not in _VOLATILE_META}
    return json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def artifact_source(body: bytes) -> str:
    """The engine's compiler-path stamp from a response body:
    ``meta.tags["artifact-source"]`` is ``"aot-cache"`` when every
    fused-segment bucket the replica has dispatched was hydrated from
    the artifact store, ``"live"`` otherwise, and ``""`` when the
    artifact plane is off or the body is not a SeldonMessage.  Read
    BEFORE canonicalization — tags are volatile meta and are dropped
    from the parity comparison."""
    try:
        doc = json.loads(body)
    except ValueError:
        return ""
    meta = doc.get("meta") if isinstance(doc, dict) else None
    if isinstance(meta, dict) and isinstance(meta.get("tags"), dict):
        return str(meta["tags"].get("artifact-source", ""))
    return ""


def device_plane_tag(body: bytes) -> str:
    """The engine's device-plane stamp from a response body:
    ``meta.tags["device-plane"]`` is ``"on"`` when the answering engine
    served with the device-resident tensor plane enabled, ``""``
    otherwise.  Like ``artifact_source``, read BEFORE canonicalization —
    the stamp is volatile meta, so a plane-on response still compares
    byte-parity-equal against a plane-off one (that equality IS the
    plane's correctness proof)."""
    try:
        doc = json.loads(body)
    except ValueError:
        return ""
    meta = doc.get("meta") if isinstance(doc, dict) else None
    if isinstance(meta, dict) and isinstance(meta.get("tags"), dict):
        return str(meta["tags"].get("device-plane", ""))
    return ""


def compare_responses(a: bytes, b: bytes, strict: bool = False
                      ) -> Tuple[bool, str]:
    """Parity verdict for two response bodies: ``(equal, detail)``."""
    if a == b:
        return True, "byte-identical"
    if strict:
        return False, f"raw bytes differ ({len(a)} vs {len(b)} bytes)"
    ca, cb = canonical_body(a), canonical_body(b)
    if ca == cb:
        return True, "canonically identical (volatile meta differs)"
    # first divergent offset helps aim the debugging
    n = min(len(ca), len(cb))
    at = next((i for i in range(n) if ca[i] != cb[i]), n)
    lo, hi = max(0, at - 30), at + 30
    return False, (
        f"payloads diverge at canonical offset {at}: "
        f"{ca[lo:hi]!r} != {cb[lo:hi]!r}"
    )


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="replay",
        description="re-issue a flight-recorded request; optionally "
                    "verify response parity between two deployments",
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--from", dest="from_url", default="",
                     help="base URL of a gateway/engine to pull the "
                          "record from (/admin/flightrecorder)")
    src.add_argument("--record", default="",
                     help="path to a saved flight-record JSON dump")
    ap.add_argument("--puid", default="",
                    help="record puid (required with --from)")
    ap.add_argument("--to", required=True,
                    help="base URL to replay the request against")
    ap.add_argument("--compare", default="",
                    help="second base URL; replay there too and check "
                         "response parity (walk vs fused)")
    ap.add_argument("--path", default="",
                    help="override the captured request path")
    ap.add_argument("--token", default="",
                    help="bearer token for OAuth-guarded gateways")
    ap.add_argument("--strict", action="store_true",
                    help="demand raw byte equality (volatile meta "
                         "fields included)")
    ap.add_argument("--expect-artifact-source",
                    choices=["aot-cache", "live"], default="",
                    help="assert the replay target answered through "
                         "this compiler path (meta.tags artifact-source "
                         "stamp): 'aot-cache' proves a warm start — "
                         "every dispatched bucket hydrated from the "
                         "artifact store — 'live' proves a cold one")
    ap.add_argument("--expect-device-plane",
                    choices=["on", "off"], default="",
                    help="assert the replay target's device-plane "
                         "posture (meta.tags device-plane stamp): 'on' "
                         "proves tensors rode HBM handles across "
                         "interpreter-boundary edges, 'off' proves the "
                         "host-copy baseline — pair with --compare to "
                         "prove plane-on ≡ plane-off byte parity")
    ap.add_argument("--timeout", type=float, default=30.0)
    args = ap.parse_args(argv)

    if args.from_url:
        if not args.puid:
            ap.error("--from requires --puid")
        record = fetch_record(args.from_url, args.puid, token=args.token,
                              timeout_s=args.timeout)
    else:
        record = load_record(args.record, puid=args.puid)
    print(f"record puid={record.get('puid', '?')} "
          f"deployment={record.get('deployment', '?')} "
          f"status={record.get('status', '?')} "
          f"durationMs={record.get('durationMs', '?')}")

    try:
        status, body = replay_record(record, args.to, path=args.path,
                                     token=args.token,
                                     timeout_s=args.timeout)
    except RuntimeError as e:
        print(f"replay: {e}", file=sys.stderr)
        return 2
    print(f"replay -> {args.to}: HTTP {status}, {len(body)} bytes")
    if args.expect_artifact_source:
        got = artifact_source(body)
        if got != args.expect_artifact_source:
            print(f"artifact-source: MISMATCH — expected "
                  f"{args.expect_artifact_source!r}, response stamped "
                  f"{got!r}", file=sys.stderr)
            return 1
        print(f"artifact-source: {got} (as expected)")
    if args.expect_device_plane:
        got = device_plane_tag(body) or "off"
        if got != args.expect_device_plane:
            print(f"device-plane: MISMATCH — expected "
                  f"{args.expect_device_plane!r}, response stamped "
                  f"{got!r}", file=sys.stderr)
            return 1
        print(f"device-plane: {got} (as expected)")
    if not args.compare:
        print(body.decode("utf-8", "replace")[:2000])
        return 0 if status < 400 else 1

    status2, body2 = replay_record(record, args.compare, path=args.path,
                                   token=args.token, timeout_s=args.timeout)
    print(f"replay -> {args.compare}: HTTP {status2}, {len(body2)} bytes")
    equal, detail = compare_responses(body, body2, strict=args.strict)
    print(f"parity: {'OK' if equal and status == status2 else 'MISMATCH'}"
          f" — {detail}" + ("" if status == status2 else
                            f" (HTTP {status} vs {status2})"))
    return 0 if equal and status == status2 else 1


if __name__ == "__main__":
    sys.exit(main())
