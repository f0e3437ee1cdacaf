"""Request/response firehose — the reference's Kafka logging path.

Reference: every gateway prediction is published fire-and-forget to a Kafka
topic named after the client, as a ``RequestResponse`` proto
(``api-frontend/.../kafka/KafkaRequestResponseProducer.java:68-75``, enabled
by ``seldon.kafka.enable``).  The sink is pluggable: JSONL file per client
(consumable by any log shipper), an in-memory ring (tests/inspection), a
segmented offset log, the framed network broker (``firehose_net.py``), the
Kafka wire protocol (``firehose_kafka.py``), or a user-provided sink
object.

Port of ``seldon_core_tpu/gateway/firehose.py``: the same names, bodies and
behaviour, on the standard library.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional, Protocol


class FirehoseSink(Protocol):
    def publish(self, client_id: str, request: dict, response: dict) -> None: ...


def _safe_client_id(client_id: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in client_id)


class MemoryFirehose:
    """Bounded in-memory ring per client."""

    def __init__(self, maxlen: int = 1000):
        self._rings: dict[str, deque] = {}
        self._lock = threading.Lock()
        self.maxlen = maxlen

    def publish(self, client_id: str, request: dict, response: dict) -> None:
        with self._lock:
            ring = self._rings.setdefault(client_id, deque(maxlen=self.maxlen))
            ring.append(
                {"ts": time.time(), "request": request, "response": response}
            )

    def records(self, client_id: str) -> list[dict]:
        with self._lock:
            return list(self._rings.get(client_id, ()))


class JsonlFirehose:
    """One append-only ``<client_id>.jsonl`` per client under ``base_dir`` —
    the topic-per-client layout, durable and shipper-friendly."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self._lock = threading.Lock()

    def publish(self, client_id: str, request: dict, response: dict) -> None:
        safe = _safe_client_id(client_id)
        line = json.dumps(
            {"ts": time.time(), "request": request, "response": response},
            separators=(",", ":"),
        )
        with self._lock:
            with open(os.path.join(self.base_dir, f"{safe}.jsonl"), "a") as f:
                f.write(line + "\n")


class NullFirehose:
    def publish(self, client_id: str, request: dict, response: dict) -> None:
        pass


class SegmentedFirehose:
    """Durable per-client topic as a segmented append-log — the kafka-style
    option (reference KafkaRequestResponseProducer.java: topic per client,
    fire-and-forget, retention by the broker).  Layout::

        <base>/<client>/00000000000000000042.jsonl   # name = first offset

    - records carry a monotonically increasing per-client ``offset``;
    - the active segment rolls at ``segment_bytes``;
    - at most ``retain_segments`` closed segments are kept (size-bounded
      durability, like a broker's retention policy);
    - ``read(client, from_offset)`` replays in order across segments — a
      shipper can resume from its last committed offset after a restart.
    """

    def __init__(self, base_dir: str, segment_bytes: int = 64 * 1024 * 1024,
                 retain_segments: int = 8):
        self.base_dir = base_dir
        self.segment_bytes = segment_bytes
        self.retain_segments = retain_segments
        self._lock = threading.Lock()
        self._state: dict[str, tuple[int, str, int]] = {}  # cl -> (next_off, seg_path, seg_size)
        os.makedirs(base_dir, exist_ok=True)

    # -- helpers --------------------------------------------------------
    @staticmethod
    def _safe(client_id: str) -> str:
        # hash suffix: sanitization alone could merge distinct clients
        # ("a/b" and "a b" -> "a_b"), interleaving their topics under one
        # offset sequence — a cross-principal data leak on read()
        import hashlib

        digest = hashlib.sha256(client_id.encode()).hexdigest()[:8]
        return f"{_safe_client_id(client_id)}-{digest}"

    def _dir(self, client_id: str) -> str:
        return os.path.join(self.base_dir, self._safe(client_id))

    def _segments(self, client_id: str) -> list[str]:
        d = self._dir(client_id)
        if not os.path.isdir(d):
            return []
        return sorted(f for f in os.listdir(d) if f.endswith(".jsonl"))

    def _recover(self, client_id: str) -> tuple[int, str, int]:
        """Next offset + active segment from disk (restart resume)."""
        segs = self._segments(client_id)
        d = self._dir(client_id)
        os.makedirs(d, exist_ok=True)
        if not segs:
            path = os.path.join(d, f"{0:020d}.jsonl")
            return 0, path, 0
        last = os.path.join(d, segs[-1])
        next_off = int(segs[-1].split(".")[0])
        good_bytes = 0
        with open(last, "rb") as f:
            for line in f:
                if line.strip():
                    try:
                        next_off = json.loads(line)["offset"] + 1
                    except (ValueError, KeyError):
                        # torn tail from an unclean shutdown: truncate it
                        # (kafka-style recovery) — otherwise every publish
                        # would re-raise here and the firehose would be dead
                        # forever
                        with open(last, "rb+") as tf:
                            tf.truncate(good_bytes)
                        break
                good_bytes += len(line)
        return next_off, last, good_bytes

    # -- sink protocol --------------------------------------------------
    def publish(self, client_id: str, request: dict, response: dict,
                ts: Optional[float] = None) -> None:
        """``ts``: producer-side timestamp — the network broker passes the
        GATEWAY'S stamp through so backlog drained after an outage keeps
        request time (and at-least-once duplicates keep an identical
        (client, ts) dedupe key); None stamps now (in-process sinks)."""
        with self._lock:
            state = self._state.get(client_id)
            if state is None:
                state = self._recover(client_id)
            off, seg, size = state
            if size >= self.segment_bytes:
                seg = os.path.join(self._dir(client_id), f"{off:020d}.jsonl")
                size = 0
                self._gc(client_id)
            line = json.dumps(
                {"offset": off, "ts": time.time() if ts is None else ts,
                 "request": request, "response": response},
                separators=(",", ":"),
            ) + "\n"
            with open(seg, "a") as f:
                f.write(line)
            self._state[client_id] = (off + 1, seg, size + len(line))

    def _gc(self, client_id: str) -> None:
        segs = self._segments(client_id)
        # the about-to-be-created segment counts toward the budget
        excess = len(segs) - (self.retain_segments - 1)
        for name in segs[:max(excess, 0)]:
            try:
                os.unlink(os.path.join(self._dir(client_id), name))
            except OSError:
                pass

    # -- consumer -------------------------------------------------------
    def read(self, client_id: str, from_offset: int = 0,
             max_records: int = 1000) -> list[dict]:
        out: list[dict] = []
        d = self._dir(client_id)
        with self._lock:
            segs = self._segments(client_id)
        # skip whole segments below the requested offset: a segment's
        # records are bounded by the NEXT segment's base offset (= filename)
        bases = [int(name.split(".")[0]) for name in segs]
        for i, name in enumerate(segs):
            if i + 1 < len(segs) and bases[i + 1] <= from_offset:
                continue
            try:
                f = open(os.path.join(d, name))
            except OSError:
                continue  # unlinked by retention gc between list and open
            with f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail not yet truncated by recovery
                    if rec["offset"] >= from_offset:
                        out.append(rec)
                        if len(out) >= max_records:
                            return out
        return out


def make_firehose(kind: str = "", base_dir: Optional[str] = None,
                  target: Optional[str] = None):
    if kind == "jsonl":
        return JsonlFirehose(base_dir or "./firehose")
    if kind == "segmented":
        return SegmentedFirehose(base_dir or "./firehose")
    if kind == "memory":
        return MemoryFirehose()
    if kind == "network":
        # shared broker for multi-gateway deployments
        # (gateway/firehose_net.py; reference: Kafka producer → broker)
        from seldon_core_tpu_torch.gateway.firehose_net import NetworkFirehose

        return NetworkFirehose(target or "127.0.0.1:7788")
    if kind == "kafka":
        # REAL Kafka wire protocol (topic = client id), so existing Kafka
        # consumer pipelines ingest the firehose directly — reference
        # KafkaRequestResponseProducer parity (gateway/firehose_kafka.py)
        from seldon_core_tpu_torch.gateway.firehose_kafka import KafkaFirehose

        return KafkaFirehose(bootstrap=target or "127.0.0.1:9092")
    return NullFirehose()
