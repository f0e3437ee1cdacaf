"""Contract testers: drive a component or a deployed graph with generated
traffic (port of ``seldon_core_tpu/tools/tester.py``, on the port's own
clients: ``serving/client.py`` for REST, ``serving/grpc_api.py`` for gRPC,
``serving/framed.py`` for the framed wire).

Two reference tools, one implementation:

- **Component tester** (``wrappers/testing/tester.py``): hits a standalone
  wrapped component's internal API (``/predict``, ``/send-feedback``)
  directly — REST, gRPC, or SELF-framed TCP.
- **API tester** (``util/api_tester/api-tester.py:26-60``): hits a deployed
  graph through the external API — engine directly, or gateway with the
  OAuth2 client-credentials dance.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from seldon_core_tpu_torch.tools.contract import Contract, validate_response


@dataclass
class TestReport:
    sent: int
    failures: List[str]
    responses: List[dict]

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> dict:
        return {
            "sent": self.sent,
            "ok": self.ok,
            "failures": self.failures,
            "responses": self.responses,
        }


async def _rest_call(url: str, payload: dict,
                     headers: Optional[dict] = None) -> dict:
    from seldon_core_tpu_torch.serving.client import HttpSession

    sess = HttpSession()
    try:
        _, _, raw = await sess.request(
            "POST", url, json.dumps(payload).encode(),
            {"Content-Type": "application/json", **(headers or {})},
            timeout_s=30)
    finally:
        await sess.close()
    return json.loads(raw)


async def test_component(
    contract: Contract,
    host: str = "127.0.0.1",
    port: int = 8000,
    transport: str = "rest",  # rest | grpc | framed
    endpoint: str = "predict",  # predict | send-feedback
    n_requests: int = 1,
    batch_size: int = 1,
    tensor: bool = True,
    seed: Optional[int] = None,
) -> TestReport:
    """Reference ``wrappers/testing/tester.py`` semantics against our
    microservice servers."""
    rng = np.random.default_rng(seed)
    failures: List[str] = []
    responses: List[dict] = []

    for i in range(n_requests):
        if endpoint == "send-feedback":
            payload = contract.feedback_request(batch_size, rng=rng)
        else:
            payload = contract.rest_request(batch_size, tensor=tensor, rng=rng)

        if transport == "rest":
            path = "/predict" if endpoint == "predict" else "/send-feedback"
            body = await _rest_call(f"http://{host}:{port}{path}", payload)
        elif transport == "grpc":
            from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
            from seldon_core_tpu_torch.serving.grpc_api import GrpcComponentClient

            client = GrpcComponentClient(f"{host}:{port}")
            try:
                if endpoint == "predict":
                    out = await client.predict(SeldonMessage.from_dict(payload))
                else:
                    out = await client.send_feedback(Feedback.from_dict(payload))
                body = out.to_dict() if out is not None else {}
            finally:
                await client.close()
        elif transport == "framed":
            from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
            from seldon_core_tpu_torch.serving.framed import FramedClient

            def _framed_once() -> dict:
                with FramedClient(host, port) as client:
                    if endpoint == "predict":
                        return client.predict(
                            SeldonMessage.from_dict(payload)
                        ).to_dict()
                    return client.send_feedback(
                        Feedback.from_dict(payload)
                    ).to_dict()

            body = await asyncio.get_running_loop().run_in_executor(
                None, _framed_once
            )
        else:
            raise ValueError(f"unknown transport {transport!r}")

        responses.append(body)
        if endpoint == "predict":
            for p in validate_response(contract, body):
                failures.append(f"request {i}: {p}")
        else:
            st = (body or {}).get("status") or {}
            if st.get("status") == "FAILURE":
                failures.append(f"request {i}: feedback FAILURE: {st.get('info')}")
    return TestReport(sent=n_requests, failures=failures, responses=responses)


async def test_api(
    contract: Contract,
    base_url: str,
    oauth_key: str = "",
    oauth_secret: str = "",
    grpc_target: str = "",
    endpoint: str = "predict",  # predict | feedback
    n_requests: int = 1,
    batch_size: int = 1,
    tensor: bool = True,
    seed: Optional[int] = None,
) -> TestReport:
    """Reference ``util/api_tester/api-tester.py`` semantics: optional OAuth
    dance, then the external prediction/feedback API (REST or gRPC)."""
    rng = np.random.default_rng(seed)
    token = ""
    if oauth_key:
        from seldon_core_tpu_torch.tools.loadtest import oauth_token

        token = await oauth_token(base_url, oauth_key, oauth_secret)

    failures: List[str] = []
    responses: List[dict] = []
    for i in range(n_requests):
        if endpoint == "feedback":
            payload = contract.feedback_request(batch_size, rng=rng)
        else:
            payload = contract.rest_request(batch_size, tensor=tensor, rng=rng)

        if grpc_target:
            from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
            from seldon_core_tpu_torch.serving.grpc_api import SeldonGrpcClient

            client = SeldonGrpcClient(grpc_target, token=token)
            try:
                if endpoint == "predict":
                    out = await client.predict(SeldonMessage.from_dict(payload))
                else:
                    out = await client.send_feedback(Feedback.from_dict(payload))
                body = out.to_dict()
            finally:
                await client.close()
        else:
            path = (
                "/api/v0.1/predictions"
                if endpoint == "predict"
                else "/api/v0.1/feedback"
            )
            headers = {"Authorization": f"Bearer {token}"} if token else {}
            body = await _rest_call(f"{base_url.rstrip('/')}{path}", payload, headers)

        responses.append(body)
        if endpoint == "predict":
            for p in validate_response(contract, body):
                failures.append(f"request {i}: {p}")
        else:
            st = (body or {}).get("status") or {}
            if st.get("status") == "FAILURE":
                failures.append(f"request {i}: feedback FAILURE: {st.get('info')}")
    return TestReport(sent=n_requests, failures=failures, responses=responses)
