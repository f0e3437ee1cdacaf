"""The port's firehoses (``seldon_core_tpu_torch/gateway/firehose*.py``)
against the reference's on the CPU.

The same publishes go into each package's sink and the records come out
EQUAL except ``ts``: the memory ring, the jsonl files, the segmented
offset log (segment names, rolling, retention, offset replay, torn-tail
recovery), the network broker over the framed protocol (each package's
producer into each package's broker), and the Kafka wire protocol (the
RecordBatch, Metadata and Produce bytes of the two packages equal for the
same inputs, and the port's sink's produce requests pass the reference's
strict fake broker with the same decoded records).
"""

import json
import os
import time

import pytest

from seldon_core_tpu.gateway import firehose as jfh
from seldon_core_tpu.gateway import firehose_kafka as jkafka
from seldon_core_tpu_torch.gateway import firehose as tfh
from seldon_core_tpu_torch.gateway import firehose_kafka as tkafka
from tests.test_firehose_kafka import FakeKafkaBroker

RECORDS = [
    ("client-a", {"data": {"ndarray": [[i, i + 0.5]]}},
     {"data": {"ndarray": [[2 * i]]}, "meta": {"puid": f"p{i}"}})
    for i in range(7)
] + [("we/ird id", {"jsonData": {"q": 1}}, {"jsonData": {"r": 2}}),
     ("client-b", {"strData": "x"}, {"strData": "y"})]


def _no_ts(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "ts"}


def _publish(sink, records=RECORDS):
    for client, req, resp in records:
        sink.publish(client, req, resp)


def test_memory_rings_equal():
    j, t = jfh.MemoryFirehose(maxlen=4), tfh.MemoryFirehose(maxlen=4)
    _publish(j)
    _publish(t)
    for client in ("client-a", "we/ird id", "client-b", "nobody"):
        assert [_no_ts(r) for r in t.records(client)] == \
            [_no_ts(r) for r in j.records(client)]


def _tree(base) -> dict:
    """Every file under ``base`` as its lines' records without ``ts``."""
    out = {}
    for dirpath, _, files in os.walk(base):
        for fn in files:
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                out[os.path.relpath(path, base)] = [
                    _no_ts(json.loads(ln)) for ln in f if ln.strip()]
    return out


def test_jsonl_files_equal(tmp_path):
    _publish(jfh.JsonlFirehose(str(tmp_path / "j")))
    _publish(tfh.JsonlFirehose(str(tmp_path / "t")))
    j, t = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert t == j and set(t) == {"client-a.jsonl", "we_ird_id.jsonl",
                                 "client-b.jsonl"}


def test_segmented_log_equal(tmp_path):
    """Small segments so it rolls and retention drops the oldest; offset
    replay from the middle; recovery after a torn tail."""
    kw = dict(segment_bytes=150, retain_segments=3)
    j = jfh.SegmentedFirehose(str(tmp_path / "j"), **kw)
    t = tfh.SegmentedFirehose(str(tmp_path / "t"), **kw)
    _publish(j)
    _publish(t)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    for client in ("client-a", "we/ird id"):
        for off in (0, 3, 6, 99):
            assert [_no_ts(r) for r in t.read(client, off)] == \
                [_no_ts(r) for r in j.read(client, off)]
    # a torn tail (unclean shutdown): both truncate it and resume
    for base, cls in (("j", jfh.SegmentedFirehose),
                      ("t", tfh.SegmentedFirehose)):
        d = tmp_path / base / cls._safe("client-b")
        seg = sorted(os.listdir(d))[-1]
        with open(d / seg, "a") as f:
            f.write('{"offset": 1, "tr')
        fresh = cls(str(tmp_path / base), **kw)
        fresh.publish("client-b", {"after": 1}, {"ok": True})
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def test_make_firehose_kinds_equal(tmp_path):
    for kind in ("", "jsonl", "segmented", "memory"):
        j = jfh.make_firehose(kind, str(tmp_path / "j"))
        t = tfh.make_firehose(kind, str(tmp_path / "t"))
        assert type(t).__name__ == type(j).__name__


# ---- network broker ---------------------------------------------------------

@pytest.mark.parametrize("producer,broker", [
    ("port", "port"), ("port", "ref"), ("ref", "port")])
def test_network_firehose_records_equal(tmp_path, producer, broker):
    """Records through each (producer, broker) pair equal the reference
    pair's, except ``ts``; the producer's stamp passes through."""
    from seldon_core_tpu.gateway import firehose_net as jnet
    from seldon_core_tpu_torch.gateway import firehose_net as tnet

    mods = {"ref": jnet, "port": tnet}

    def run(pmod, bmod, where):
        with bmod.FirehoseBroker(str(tmp_path / where),
                                 token="s3cret") as b:
            target = f"127.0.0.1:{b.port}"
            sink = pmod.NetworkFirehose(target, max_delay_s=0.02,
                                        token="s3cret")
            try:
                t0 = time.time()
                _publish(sink)
                assert sink.flush(20)
            finally:
                sink.close()
            got = {c: bmod.broker_read(target, c, token="s3cret")
                   for c in ("client-a", "we/ird id", "client-b")}
            with pytest.raises(RuntimeError, match="unauthorized"):
                bmod.broker_read(target, "client-a")
        assert all(r["ts"] >= t0 for rs in got.values() for r in rs)
        return {c: [_no_ts(r) for r in rs] for c, rs in got.items()}

    want = run(jnet, jnet, "ref")
    assert run(mods[producer], mods[broker], "pair") == want
    assert [r["offset"] for r in want["client-a"]] == list(range(7))


# ---- Kafka wire ------------------------------------------------------------

def test_kafka_wire_bytes_equal():
    values = [json.dumps({"i": i}).encode() for i in range(5)] + [b""]
    for fn, args in (
            ("record_batch", (values, 1_700_000_000_123)),
            ("metadata_request", (7, "seldon-gateway", "topic-a")),
            ("produce_request", (8, "seldon-gateway", "topic-a",
                                 jkafka.record_batch(values, 5)))):
        assert getattr(tkafka, fn)(*args) == getattr(jkafka, fn)(*args), fn
    for data in (b"", b"123456789", bytes(range(256))):
        assert tkafka.crc32c(data) == jkafka.crc32c(data)
    assert tkafka.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check
    for v in (0, 1, -1, 63, -64, 300, -(1 << 40)):
        assert tkafka._varint(v) == jkafka._varint(v)


class _Recording(FakeKafkaBroker):
    """The reference's strict fake broker, keeping each produce body."""

    def __init__(self):
        self.bodies = []
        super().__init__()

    def _produce(self, body, corr):
        self.bodies.append(body)
        return super()._produce(body, corr)


@pytest.mark.parametrize("prefix", ["", "seldon."])
def test_kafka_sink_passes_the_strict_broker_equal(prefix):
    def run(mod):
        broker = _Recording()
        fh = mod.KafkaFirehose(bootstrap=f"127.0.0.1:{broker.port}",
                               topic_prefix=prefix, flush_interval_s=0.02)
        try:
            _publish(fh)
            deadline = time.monotonic() + 10
            while (fh.stats["published"] < len(RECORDS)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        finally:
            fh.close()
            broker.close()
        assert not broker.errors, broker.errors
        assert fh.stats == {"published": len(RECORDS), "dropped": 0,
                            "errors": 0}
        topics = {t: [_no_ts(json.loads(v)) for v in vs]
                  for t, vs in broker.topics.items()}
        return topics, sorted(broker.metadata_topics)

    want = run(jkafka)
    got = run(tkafka)
    assert got == want
    assert set(got[0]) == {prefix + t for t in
                           ("client-a", "we_ird_id", "client-b")}
