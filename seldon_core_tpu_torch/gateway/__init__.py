"""External API gateway — the reference "apife" (``api-frontend/``).

Multi-tenant front door: OAuth2 client-credentials auth where each
deployment's ``oauth_key``/``oauth_secret`` is a client, principal→deployment
routing, REST + gRPC forwarding to the per-deployment engine, and a
request/response firehose (the reference publishes to Kafka per client —
``api-frontend/.../kafka/KafkaRequestResponseProducer.java:68-75``).

Port of ``seldon_core_tpu/gateway/``: the same exports; the server is
``gateway/app.py`` (``python -m seldon_core_tpu_torch.gateway.app``).
"""

from seldon_core_tpu_torch.gateway.oauth import OAuthProvider, TokenStore
from seldon_core_tpu_torch.gateway.store import DeploymentRecord, DeploymentStore
from seldon_core_tpu_torch.gateway.firehose import (
    FirehoseSink,
    JsonlFirehose,
    MemoryFirehose,
)

__all__ = [
    "OAuthProvider",
    "TokenStore",
    "DeploymentRecord",
    "DeploymentStore",
    "FirehoseSink",
    "JsonlFirehose",
    "MemoryFirehose",
]
