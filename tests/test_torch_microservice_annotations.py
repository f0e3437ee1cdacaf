"""The port's component microservice reads the pod's downward-API
annotations as the reference's does (``serving/microservice.py``
``load_annotations``) and hands them to its gRPC server, whose message
limit follows ``seldon.io/grpc-max-message-size``.  Both packages' CLIs run
on the CPU with a stand-in gRPC server that records the limit it was
given."""

import pytest

from seldon_core_tpu.serving import grpc_api as jgrpc
from seldon_core_tpu.serving import microservice as jmicro
from seldon_core_tpu_torch.serving import grpc_api as tgrpc
from seldon_core_tpu_torch.serving import microservice as tmicro

ANNOTATIONS = (
    'seldon.io/grpc-max-message-size="7340032"\n'
    "\n"
    'seldon.io/engine-separate-pod="false"\n'
    "not a pair\n"
    "seldon.io/plain=value\n"
)


class _RecordingServer:
    """Stands in for each package's ``GrpcServer``: records its message
    limit and serves nothing."""

    limits: list = []

    def __init__(self, handlers, port=0, host="", max_message_size=None,
                 **kw):
        type(self).limits.append(max_message_size)

    async def start(self):
        return 0

    async def wait(self):
        return None

    async def stop(self, grace=None):
        return None


@pytest.fixture
def annotations_file(tmp_path):
    path = tmp_path / "annotations"
    path.write_text(ANNOTATIONS)
    return str(path)


def test_load_annotations_equal(annotations_file, tmp_path):
    got = tmicro.load_annotations(annotations_file)
    assert got == jmicro.load_annotations(annotations_file)
    assert got["seldon.io/grpc-max-message-size"] == "7340032"
    missing = str(tmp_path / "absent")
    assert tmicro.load_annotations(missing) == \
        jmicro.load_annotations(missing) == {}


def test_grpc_microservice_takes_the_annotated_message_limit(
        annotations_file, monkeypatch):
    limits = {}
    for name, micro, grpc, argv in (
            ("reference", jmicro, jgrpc,
             ["seldon_core_tpu.models.iris:IrisClassifier", "GRPC",
              "--port", "0"]),
            ("port", tmicro, tgrpc,
             ["seldon_core_tpu_torch.models.iris:IrisClassifier", "GRPC",
              "--port", "0", "--device", "cpu"])):
        read = micro.load_annotations
        monkeypatch.setattr(micro, "load_annotations",
                            lambda path=None, read=read: read(
                                annotations_file))
        server = type("Server", (_RecordingServer,), {"limits": []})
        monkeypatch.setattr(grpc, "GrpcServer", server)
        micro.main(argv)
        limits[name] = server.limits
    assert limits["port"] == limits["reference"] == [7340032]
