"""Network firehose: push sink + broker + consumer over the framed protocol.

The reference's firehose is a real network path — gateways produce to a
Kafka broker (``api-frontend/.../kafka/KafkaRequestResponseProducer.java:68-75``,
broker manifests ``kafka/kafka.json``) and consumers tail topics
(``kafka/tests/src/read_predictions.py``).  The segmented offset-log
(firehose.py SegmentedFirehose) is the storage half; this module adds the
network half so MULTIPLE gateways share ONE durable firehose:

- :class:`FirehoseBroker` — a server holding the segmented log, speaking
  the SELF framed protocol (native epoll server, meta-only frames with a
  JSON op envelope).  Standalone: ``python -m
  seldon_core_tpu_torch.gateway.firehose_net --dir DIR --port P``.  Binds
  loopback by default; exposing it (``--bind 0.0.0.0``) REQUIRES a shared
  ``--token`` — the log holds every principal's request/response bodies,
  so an open read op would be a cross-principal exfiltration hole (the
  same concern SegmentedFirehose._safe guards on disk).
- :class:`NetworkFirehose` — a gateway-side sink: ``publish()`` is
  fire-and-forget into a bounded queue; a background thread batches
  records into framed ``publish_batch`` ops with reconnect + resend
  (at-least-once, like the reference's Kafka producer with retries).
  Overflow drops the oldest (fire-and-forget semantics; ``dropped``
  counts, failures are logged with backoff).
- consumer ops — ``read`` (offset replay, :func:`broker_read`), resumable
  by offset like the reference's consumer scripts.

Port of ``seldon_core_tpu/gateway/firehose_net.py``: the same names, ops and
records, on the port's ``native.py`` framing (``FrameCodec``,
``FramedServer``) and ``serving/framed.py`` ``FramedClient``.
"""

from __future__ import annotations

import hmac
import json
import logging
import queue
import threading
import time
from typing import Optional

from seldon_core_tpu_torch.gateway.firehose import SegmentedFirehose

logger = logging.getLogger(__name__)

__all__ = ["FirehoseBroker", "NetworkFirehose", "broker_read"]


def _encode_op(codec, msg_type: int, op: dict) -> bytes:
    return codec.encode(msg_type, meta=json.dumps(op).encode())


class FirehoseBroker:
    """Framed-protocol broker over a :class:`SegmentedFirehose`.

    Ops (frame meta JSON; with ``token`` configured every op must carry a
    matching ``"auth"`` field):
    - ``{"op": "publish_batch", "records": [{"client", "ts", "request",
      "response"}, ...]}`` → ``{"acked": N}``
    - ``{"op": "read", "client": C, "from_offset": O, "max": M}`` →
      ``{"records": [...]}`` (offset-ordered replay across segments)
    - ``{"op": "ping"}`` → ``{"ok": true}``

    The handler runs on the native server's IO thread; the segmented log's
    appends are short synchronous file writes, the same work the in-process
    sink does on the gateway loop today.
    """

    def __init__(self, base_dir: str, port: int = 0,
                 bind: str = "127.0.0.1", token: str = "", **log_kw):
        from seldon_core_tpu_torch.native import (
            MSG_ERROR,
            MSG_RESPONSE,
            FrameCodec,
            FramedServer,
        )

        self.log = SegmentedFirehose(base_dir, **log_kw)
        self.token = token
        self._codec = FrameCodec()
        self._msg_response = MSG_RESPONSE
        self._msg_error = MSG_ERROR
        self._server = FramedServer(self._handle, port=port, bind=bind)

    def _handle(self, payload: bytes) -> bytes:
        try:
            frame = self._codec.decode(payload)
            op = json.loads(frame.meta or b"{}")
            # constant-time compare; note the token itself travels in
            # cleartext on the framed protocol — a non-loopback broker bind
            # needs a TLS tunnel / mTLS in front (docs/production.md)
            if self.token and not hmac.compare_digest(
                str(op.get("auth", "")).encode(), self.token.encode()
            ):
                return _encode_op(
                    self._codec, self._msg_error, {"error": "unauthorized"}
                )
            kind = op.get("op")
            if kind == "publish_batch":
                n = 0
                for rec in op.get("records", ()):
                    self.log.publish(
                        rec.get("client", "unknown"),
                        rec.get("request", {}), rec.get("response", {}),
                        ts=rec.get("ts"),  # producer stamp passes through
                    )
                    n += 1
                out = {"acked": n}
            elif kind == "read":
                out = {
                    "records": self.log.read(
                        op.get("client", ""),
                        from_offset=int(op.get("from_offset", 0)),
                        max_records=min(int(op.get("max", 1000)), 10000),
                    )
                }
            elif kind == "ping":
                out = {"ok": True}
            else:
                return _encode_op(
                    self._codec, self._msg_error,
                    {"error": f"unknown op {kind!r}"},
                )
            return _encode_op(self._codec, self._msg_response, out)
        except Exception as e:  # broker must never die on a bad frame
            logger.exception("firehose broker op failed")
            return _encode_op(
                self._codec, self._msg_error,
                {"error": f"{type(e).__name__}: {e}"},
            )

    def start(self) -> "FirehoseBroker":
        self._server.start()
        return self

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self) -> None:
        self._server.stop()

    def __enter__(self) -> "FirehoseBroker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class _BrokerConn:
    """One framed connection carrying JSON op envelopes — a thin wrapper
    over serving/framed.py's blocking FramedClient (ONE implementation of
    the wire framing; ``ping_raw`` is the raw round-trip)."""

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0,
                 io_timeout: float = 30.0, token: str = ""):
        from seldon_core_tpu_torch.native import MSG_PREDICT, FrameCodec
        from seldon_core_tpu_torch.serving.framed import FramedClient

        self._codec = FrameCodec()
        self._msg = MSG_PREDICT
        self._token = token
        # connect bounded tightly (a blackholed broker must not pin the
        # producer thread); per-op I/O gets its own, longer budget — a big
        # batch the broker takes seconds to append is NOT a failure
        self._client = FramedClient(host, port, timeout=connect_timeout)
        self._client._sock.settimeout(io_timeout)

    def request(self, op: dict) -> dict:
        if self._token:
            op = {**op, "auth": self._token}
        raw = self._client.ping_raw(_encode_op(self._codec, self._msg, op))
        out = json.loads(self._codec.decode(raw).meta or b"{}")
        if "error" in out:
            raise RuntimeError(f"broker error: {out['error']}")
        return out

    def close(self) -> None:
        self._client.close()


class NetworkFirehose:
    """Gateway-side push sink: fire-and-forget publish into a bounded
    queue; a daemon thread batches to the broker with reconnect + resend.

    At-least-once: a batch is only dropped from the resend buffer after
    the broker acks it, so a broker restart mid-batch may duplicate
    records (consumers dedupe by (client, ts) if they care) but never
    silently loses acked ones.  Queue overflow drops the OLDEST records
    (``dropped`` counts them; failures log with backoff) — the producer
    never blocks the gateway's request path, matching the reference
    producer's fire-and-forget mode.  ``flush()`` waits on an outstanding
    counter (queued + in-flight), so it cannot report done while a record
    is still unacked.
    """

    _LOG_EVERY_S = 30.0

    def __init__(
        self,
        target: str,
        max_queue: int = 10000,
        max_batch: int = 200,
        max_delay_s: float = 0.2,
        retry_backoff_s: float = 0.5,
        token: str = "",
        autostart: bool = True,
    ):
        host, _, port = target.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.retry_backoff_s = retry_backoff_s
        self.token = token
        self.dropped = 0
        self.sent = 0
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._outstanding = 0  # queued + in the push thread's batch
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._last_log = 0.0
        self._thread = threading.Thread(
            target=self._run, name="firehose-push", daemon=True
        )
        if autostart:  # tests use autostart=False to probe queue behavior
            self._thread.start()

    # -- sink protocol --------------------------------------------------
    def publish(self, client_id: str, request: dict, response: dict) -> None:
        rec = {"client": client_id, "ts": time.time(),
               "request": request, "response": response}
        while True:
            try:
                self._q.put_nowait(rec)
                with self._cond:
                    self._outstanding += 1
                return
            except queue.Full:
                try:
                    self._q.get_nowait()  # drop oldest, count it
                    with self._cond:
                        self._outstanding -= 1
                    self.dropped += 1
                except queue.Empty:
                    pass

    def _settle(self, n: int) -> None:
        with self._cond:
            self._outstanding -= n
            if self._outstanding <= 0:
                self._cond.notify_all()

    def _log_failure(self, e: Exception) -> None:
        now = time.monotonic()
        if now - self._last_log >= self._LOG_EVERY_S:
            self._last_log = now
            logger.warning(
                "firehose push to %s:%d failing (%s: %s); queued=%d "
                "dropped=%d — retrying with backoff",
                self.host, self.port, type(e).__name__, e,
                self._q.qsize(), self.dropped,
            )

    # -- push thread -----------------------------------------------------
    def _run(self) -> None:
        conn: Optional[_BrokerConn] = None
        batch: list = []
        while True:
            # gather a batch; waits are CHUNKED (<=0.25s) so stop/close are
            # noticed promptly even under a long max_delay_s
            deadline = time.monotonic() + self.max_delay_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    break
                try:
                    batch.append(
                        self._q.get(timeout=min(remaining, 0.25))
                    )
                except queue.Empty:
                    continue
            if not batch:
                if self._stop.is_set() and self._q.empty():
                    break
                continue
            # send with reconnect + resend until acked (at-least-once);
            # on stop with the broker unreachable the batch is DROPPED
            # (counted) so shutdown always terminates
            while batch:
                try:
                    if conn is None:
                        conn = _BrokerConn(self.host, self.port,
                                           connect_timeout=2.0,
                                           token=self.token)
                    conn.request({"op": "publish_batch", "records": batch})
                    self.sent += len(batch)
                    self._settle(len(batch))
                    batch = []
                except Exception as e:
                    if conn is not None:
                        conn.close()
                        conn = None
                    self._log_failure(e)
                    if self._stop.is_set():
                        self.dropped += len(batch)
                        self._settle(len(batch))
                        batch = []
                        break
                    self._stop.wait(self.retry_backoff_s)
        if conn is not None:
            conn.close()

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Wait until everything queued so far is ACKED (tests/shutdown) —
        counter-based, so an in-flight batch still counts as pending."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def close(self, timeout_s: float = 5.0) -> None:
        self.flush(timeout_s)
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout_s)


def broker_read(target: str, client: str, from_offset: int = 0,
                max_records: int = 1000, token: str = "") -> list[dict]:
    """One-shot consumer read against a broker (CLI + tests)."""
    host, _, port = target.rpartition(":")
    conn = _BrokerConn(host or "127.0.0.1", int(port), token=token)
    try:
        return conn.request(
            {"op": "read", "client": client, "from_offset": from_offset,
             "max": max_records},
        )["records"]
    finally:
        conn.close()


def main(argv=None) -> None:
    """Standalone broker: ``python -m seldon_core_tpu_torch.gateway.firehose_net
    --dir ./firehose --port 7788`` (add ``--bind 0.0.0.0 --token SECRET``
    to serve non-local gateways)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="./firehose")
    ap.add_argument("--port", type=int, default=7788)
    ap.add_argument("--bind", default="127.0.0.1")
    ap.add_argument("--token", default="",
                    help="shared secret all ops must carry; REQUIRED for "
                         "non-loopback binds")
    args = ap.parse_args(argv)
    if args.bind not in ("127.0.0.1", "localhost") and not args.token:
        raise SystemExit(
            "refusing to serve the firehose on a non-loopback bind without "
            "--token: the log contains every principal's request/response "
            "bodies"
        )
    broker = FirehoseBroker(
        args.dir, port=args.port, bind=args.bind, token=args.token
    ).start()
    print(f"firehose broker on {args.bind}:{broker.port} -> {args.dir}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        broker.stop()


if __name__ == "__main__":
    main()
