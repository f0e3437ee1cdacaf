"""Kafka-producer firehose sink: request/response logging to a REAL Kafka
broker, so existing Kafka consumer pipelines ingest the firehose directly.

Reference parity: the apife publishes every request/response pair to Kafka
with ``topic = clientId``
(``api-frontend/.../kafka/KafkaRequestResponseProducer.java:68-75``,
fire-and-forget with a bounded max.block.ms, enabled by
``seldon.kafka.enable``; broker add-on ``kafka/kafka.json``).  Beside the
framed broker (gateway/firehose_net.py), this module lets an existing Kafka
consumer pipeline ingest the firehose: a minimal PRODUCE-ONLY Kafka client
speaking the wire protocol directly on ``socket`` and ``struct`` (the port
needs no kafka package), small enough to audit:

- Metadata v1 on first use of a topic (also triggers broker-side topic
  auto-creation when enabled),
- Produce v3 with RecordBatch v2 (magic 2, crc32c) — the record format
  every Kafka >= 0.11 and all mainstream consumers understand,
- one background thread batches queued records per topic and reconnects
  on failure; publishes never block the request path (reference
  fire-and-forget semantics).

Scope (documented trade): the partition-0 leader is assumed to be
reachable at the bootstrap address after a Metadata exchange — the
single-broker deployment the reference's add-on ships (``kafka/kafka.json``
is one broker).  Multi-broker clusters with remote partition leaders need
a full client; this sink targets the logging bus use case.

Payload: UTF-8 JSON ``{"client": ..., "request": ..., "response": ...,
"ts": ...}`` per record — the JSON twin of the reference's
``RequestResponse`` proto payload.

Wire format verified hermetically: tests/test_firehose_kafka.py runs a
strict in-process broker double that parses the frames (header, Metadata
v1, Produce v3, RecordBatch v2 incl. crc32c re-computation and varint
record decode) and rejects anything malformed.

Port of ``seldon_core_tpu/gateway/firehose_kafka.py``: the same names, bodies and
behaviour, on the standard library.
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import struct
import threading
import time
from typing import Optional

from seldon_core_tpu_torch.gateway.firehose import _safe_client_id

logger = logging.getLogger(__name__)

__all__ = ["KafkaFirehose", "crc32c"]

API_PRODUCE = 0
API_METADATA = 3


# ---------------------------------------------------------------- crc32c

def _make_crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    """Pure-python CRC-32C (Castagnoli) — the RecordBatch v2 checksum.
    Table-driven; fine at firehose rates (the payload is one JSON blob)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ------------------------------------------------------------- primitives

def _str(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _varint(v: int) -> bytes:
    """Zigzag varint (Kafka record fields)."""
    z = (v << 1) ^ (v >> 63)
    out = bytearray()
    while True:
        if z & ~0x7F:
            out.append((z & 0x7F) | 0x80)
            z >>= 7
        else:
            out.append(z)
            return bytes(out)


def _record(ts_delta: int, offset_delta: int, value: bytes) -> bytes:
    body = (
        b"\x00"  # attributes
        + _varint(ts_delta)
        + _varint(offset_delta)
        + _varint(-1)  # null key
        + _varint(len(value))
        + value
        + _varint(0)  # no headers
    )
    return _varint(len(body)) + body


def record_batch(values: list, first_ts_ms: int) -> bytes:
    """RecordBatch v2 for ``values`` (one batch, baseOffset 0 — the broker
    rewrites offsets on append)."""
    records = b"".join(
        _record(0, i, v) for i, v in enumerate(values)
    )
    # fields covered by the crc: attributes .. records
    crc_part = (
        struct.pack(">h", 0)                       # attributes
        + struct.pack(">i", len(values) - 1)       # lastOffsetDelta
        + struct.pack(">q", first_ts_ms)           # firstTimestamp
        + struct.pack(">q", first_ts_ms)           # maxTimestamp
        + struct.pack(">q", -1)                    # producerId
        + struct.pack(">h", -1)                    # producerEpoch
        + struct.pack(">i", -1)                    # baseSequence
        + struct.pack(">i", len(values))           # numRecords
        + records
    )
    head = (
        struct.pack(">i", -1)                      # partitionLeaderEpoch
        + b"\x02"                                  # magic
        + struct.pack(">I", crc32c(crc_part))
    )
    batch_len = len(head) + len(crc_part)
    return struct.pack(">q", 0) + struct.pack(">i", batch_len) + head + crc_part


def _req_header(api_key: int, api_version: int, corr: int,
                client_id: str) -> bytes:
    return (
        struct.pack(">hhi", api_key, api_version, corr) + _str(client_id)
    )


def metadata_request(corr: int, client_id: str, topic: str) -> bytes:
    body = struct.pack(">i", 1) + _str(topic)  # [topics] of 1
    return _req_header(API_METADATA, 1, corr, client_id) + body


def produce_request(corr: int, client_id: str, topic: str, batch: bytes,
                    acks: int = 1, timeout_ms: int = 5000) -> bytes:
    body = (
        _str(None)  # transactional_id (KIP-98: mandatory field in v3+)
        + struct.pack(">h", acks)
        + struct.pack(">i", timeout_ms)
        + struct.pack(">i", 1)            # [topic_data] of 1
        + _str(topic)
        + struct.pack(">i", 1)            # [partition_data] of 1
        + struct.pack(">i", 0)            # partition 0
        + _bytes(batch)
    )
    return _req_header(API_PRODUCE, 3, corr, client_id) + body


def parse_produce_response(frame: bytes) -> int:
    """Return the first partition's error code (0 = ok).  Layout (v3):
    corr i32, [topic: name, [partition i32, error i16, offset i64, ...]],
    throttle i32 (trailing)."""
    off = 4  # correlation id
    (n_topics,) = struct.unpack_from(">i", frame, off)
    off += 4
    if n_topics < 1:
        return -1
    (tl,) = struct.unpack_from(">h", frame, off)
    off += 2 + tl
    (n_parts,) = struct.unpack_from(">i", frame, off)
    off += 4
    if n_parts < 1:
        return -1
    _part, err = struct.unpack_from(">ih", frame, off)
    return err


# ------------------------------------------------------------------ sink

class KafkaFirehose:
    """FirehoseSink publishing to a Kafka broker, topic = client id
    (reference ``KafkaRequestResponseProducer`` semantics).  Fire and
    forget: ``publish`` enqueues and returns; a worker thread batches per
    topic, awaits acks=1, reconnects with backoff, and drops on sustained
    failure (bounded queue — the logging bus must never stall serving)."""

    def __init__(self, bootstrap: str = "127.0.0.1:9092",
                 client_id: str = "seldon-gateway",
                 topic_prefix: str = "", max_queue: int = 10000,
                 flush_interval_s: float = 0.05):
        if ":" in bootstrap:
            host, _, port = bootstrap.rpartition(":")
        else:
            host, port = bootstrap, ""  # host-only: default port
        self._addr = (host or "127.0.0.1", int(port or 9092))
        self._client_id = client_id
        self._prefix = topic_prefix
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._flush_s = flush_interval_s
        self._sock: Optional[socket.socket] = None
        self._corr = 0
        self._known_topics: set = set()
        self._stop = threading.Event()
        self.stats = {"published": 0, "dropped": 0, "errors": 0}
        self._thread = threading.Thread(
            target=self._run, name="kafka-firehose", daemon=True
        )
        self._thread.start()

    # -- sink protocol ---------------------------------------------------
    def publish(self, client_id: str, request: dict,
                response: dict) -> None:
        rec = json.dumps({
            "client": client_id, "request": request, "response": response,
            "ts": time.time(),
        }).encode()
        try:
            # sanitized like the sibling sinks: raw client ids may contain
            # characters illegal in Kafka topic names
            self._q.put_nowait((self._prefix + _safe_client_id(client_id),
                                rec))
        except queue.Full:
            self.stats["dropped"] += 1

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- worker ----------------------------------------------------------
    def _run(self) -> None:
        backoff = 0.2
        while not self._stop.is_set():
            # drain a batch window
            by_topic: dict[str, list] = {}
            try:
                topic, rec = self._q.get(timeout=self._flush_s)
                by_topic.setdefault(topic, []).append(rec)
            except queue.Empty:
                continue
            t0 = time.monotonic()
            while time.monotonic() - t0 < self._flush_s:
                try:
                    topic, rec = self._q.get_nowait()
                    by_topic.setdefault(topic, []).append(rec)
                except queue.Empty:
                    break
            failed = False
            for topic, recs in by_topic.items():
                if failed:
                    # connection already torn down this window: this
                    # topic's records are dropped, not re-tried (fire and
                    # forget; the bus must never build unbounded state)
                    self.stats["dropped"] += len(recs)
                    continue
                try:
                    self._produce(topic, recs)
                except (OSError, struct.error) as e:
                    failed = True
                    self.stats["errors"] += 1
                    self.stats["dropped"] += len(recs)  # per-topic: earlier
                    # topics in this window already counted as published
                    logger.warning("kafka firehose produce failed: %s", e)
                    self._disconnect()
            if failed:
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 5.0)
            else:
                backoff = 0.2

    def _disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        # a reconnect may be talking to a restarted broker with wiped
        # state: re-prime Metadata (and topic auto-creation) per topic
        self._known_topics.clear()

    def _roundtrip(self, payload: bytes) -> bytes:
        if self._sock is None:
            self._sock = socket.create_connection(self._addr, timeout=5)
            self._sock.settimeout(5)
        s = self._sock
        s.sendall(struct.pack(">i", len(payload)) + payload)
        head = b""
        while len(head) < 4:
            chunk = s.recv(4 - len(head))
            if not chunk:
                raise OSError("broker closed connection")
            head += chunk
        (n,) = struct.unpack(">i", head)
        if n < 0 or n > (16 << 20):
            raise OSError(f"bad response length {n}")
        frame = b""
        while len(frame) < n:
            chunk = s.recv(n - len(frame))
            if not chunk:
                raise OSError("broker closed mid-frame")
            frame += chunk
        return frame

    def _produce(self, topic: str, values: list) -> None:
        if topic not in self._known_topics:
            # Metadata primes the broker (and auto-creates the topic when
            # the broker allows); the response body is not needed for the
            # single-broker scope documented above
            self._corr += 1
            self._roundtrip(
                metadata_request(self._corr, self._client_id, topic)
            )
            self._known_topics.add(topic)
        self._corr += 1
        batch = record_batch(values, int(time.time() * 1000))
        frame = self._roundtrip(
            produce_request(self._corr, self._client_id, topic, batch)
        )
        err = parse_produce_response(frame)
        if err != 0:
            self.stats["errors"] += 1
            self.stats["dropped"] += len(values)
            # forget the topic so the next batch re-primes Metadata —
            # UNKNOWN_TOPIC_OR_PARTITION after a broker state wipe heals
            # via re-triggered auto-creation instead of failing forever
            self._known_topics.discard(topic)
            logger.warning(
                "kafka produce to %s returned error code %d", topic, err
            )
        else:
            self.stats["published"] += len(values)

    def flush(self, timeout_s: float = 2.0) -> None:
        """Best-effort wait for the queue to drain (tests/shutdown)."""
        deadline = time.monotonic() + timeout_s
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(self._flush_s * 2)
