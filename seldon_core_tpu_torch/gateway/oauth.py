"""OAuth2 client-credentials provider for the gateway.

Reference: each SeldonDeployment's ``oauth_key``/``oauth_secret`` becomes an
OAuth client (``api-frontend/.../api/oauth/InMemoryClientDetailsService.java``
+ ``ClientBuilder.java``); tokens come from ``POST /oauth/token`` with HTTP
Basic client auth and ``grant_type=client_credentials``; the token store is
in-memory or Redis (``config/AuthorizationServerConfiguration.java``,
``config/RedisConfig.java``).  Here the store is in-memory with optional
JSON-file spill so a restarted gateway keeps honoring issued tokens (the
Redis-parity knob without a Redis dependency).

Port of ``seldon_core_tpu/gateway/oauth.py``: the same names, bodies and
behaviour, on the standard library.
"""

from __future__ import annotations

import base64
import hmac
import json
import os
import secrets
import threading
import time
from dataclasses import dataclass
from typing import Optional

DEFAULT_TOKEN_TTL_S = 43200.0  # 12h, Spring OAuth2 default


def _token_ttl_s() -> float:
    """Per-install TTL override (chart gateway.tokenTtl → env
    SELDON_TOKEN_TTL).  Read lazily — an import-time read would freeze the
    value before embedders/tests can set it, and a malformed value would
    crash the import with an opaque traceback instead of logging."""
    raw = os.environ.get("SELDON_TOKEN_TTL")
    if not raw:
        return DEFAULT_TOKEN_TTL_S
    try:
        return float(raw)
    except ValueError:
        import logging

        logging.getLogger(__name__).warning(
            "ignoring malformed SELDON_TOKEN_TTL=%r (want seconds)", raw
        )
        return DEFAULT_TOKEN_TTL_S


@dataclass
class _TokenInfo:
    client_id: str
    expires_at: float


class TokenStore:
    """token → (client, expiry); optionally persisted to a JSON file."""

    def __init__(self, spill_path: Optional[str] = None):
        self._tokens: dict[str, _TokenInfo] = {}
        self._lock = threading.Lock()
        self._spill = spill_path
        if spill_path and os.path.exists(spill_path):
            try:
                with open(spill_path) as f:
                    for tok, (cid, exp) in json.load(f).items():
                        self._tokens[tok] = _TokenInfo(cid, float(exp))
            except (ValueError, OSError):
                pass

    def issue(self, client_id: str,
              ttl_s: Optional[float] = None) -> tuple[str, float]:
        if ttl_s is None:
            ttl_s = _token_ttl_s()
        token = secrets.token_urlsafe(32)
        with self._lock:
            self._tokens[token] = _TokenInfo(client_id, time.time() + ttl_s)
            self._gc()
            self._save()
        return token, ttl_s

    def principal(self, token: str) -> Optional[str]:
        with self._lock:
            info = self._tokens.get(token)
        if info is None or info.expires_at < time.time():
            return None
        return info.client_id

    def revoke_client(self, client_id: str) -> None:
        with self._lock:
            self._tokens = {
                t: i for t, i in self._tokens.items() if i.client_id != client_id
            }
            self._save()

    def _gc(self) -> None:
        now = time.time()
        if len(self._tokens) > 10000:
            self._tokens = {
                t: i for t, i in self._tokens.items() if i.expires_at >= now
            }

    _SAVE_DEBOUNCE_S = 1.0
    _last_save = 0.0

    def _save(self, force: bool = False) -> None:
        """Spill to disk, expired tokens purged; debounced so a token-issue
        burst doesn't serialize the whole store on every request."""
        if not self._spill:
            return
        now = time.time()
        if not force and now - self._last_save < self._SAVE_DEBOUNCE_S:
            return
        self._last_save = now
        live = {
            t: [i.client_id, i.expires_at]
            for t, i in self._tokens.items()
            if i.expires_at >= now
        }
        tmp = self._spill + ".tmp"
        with open(tmp, "w") as f:
            json.dump(live, f)
        os.replace(tmp, self._spill)

    def flush(self) -> None:
        with self._lock:
            self._save(force=True)


class SignedTokenStore:
    """STATELESS tokens: HMAC-SHA256-signed ``v1.<payload>.<sig>`` — any
    gateway replica holding the shared signing key validates any replica's
    tokens with zero shared storage, closing the multi-replica gap the
    reference solves with a Redis token store
    (``api-frontend/.../config/RedisConfig.java``,
    ``AuthorizationServerConfiguration.java``).

    Key distribution is the chart's job (one Secret mounted into every
    gateway replica → env ``SELDON_TOKEN_SIGNING_KEY``).  Trade-off vs the
    stateful store: individual tokens cannot be revoked before expiry —
    ``revoke_client`` is a documented no-op; rotate the signing key to
    invalidate everything at once (same lever as a Redis FLUSH).
    """

    def __init__(self, key: str):
        if not key:
            raise ValueError("signing key must be non-empty")
        self._key = key.encode()

    def _sign(self, payload: bytes) -> str:
        mac = hmac.new(self._key, payload, "sha256").digest()
        return base64.urlsafe_b64encode(mac).rstrip(b"=").decode()

    def issue(self, client_id: str,
              ttl_s: Optional[float] = None) -> tuple[str, float]:
        if ttl_s is None:
            ttl_s = _token_ttl_s()
        payload = base64.urlsafe_b64encode(json.dumps(
            {"c": client_id, "e": round(time.time() + ttl_s, 3)},
            separators=(",", ":"),
        ).encode()).rstrip(b"=").decode()
        return f"v1.{payload}.{self._sign(payload.encode())}", ttl_s

    def principal(self, token: str) -> Optional[str]:
        parts = token.split(".")
        if len(parts) != 3 or parts[0] != "v1":
            return None
        payload, sig = parts[1], parts[2]
        if not hmac.compare_digest(self._sign(payload.encode()), sig):
            return None
        try:
            data = json.loads(base64.urlsafe_b64decode(
                payload + "=" * (-len(payload) % 4)
            ))
        except (ValueError, TypeError):
            return None
        if float(data.get("e", 0)) < time.time():
            return None
        cid = data.get("c")
        return cid if isinstance(cid, str) else None

    def revoke_client(self, client_id: str) -> None:
        import logging

        logging.getLogger(__name__).warning(
            "revoke_client(%s) is a no-op with stateless signed tokens; "
            "rotate SELDON_TOKEN_SIGNING_KEY to invalidate outstanding "
            "tokens", client_id,
        )

    def flush(self) -> None:
        pass  # nothing to persist


def default_token_store(spill_path: Optional[str] = None):
    """The deployment-selected token backend: stateless signed tokens when
    ``SELDON_TOKEN_SIGNING_KEY`` is set (multi-replica gateways), else the
    in-memory store with optional JSON spill (single replica)."""
    key = os.environ.get("SELDON_TOKEN_SIGNING_KEY", "")
    if key:
        return SignedTokenStore(key)
    return TokenStore(spill_path)


class OAuthProvider:
    """Validates client credentials against the deployment store and mints
    bearer tokens."""

    def __init__(self, store, tokens: Optional[TokenStore] = None):
        self.store = store  # DeploymentStore: client_id → record w/ secret
        self.tokens = tokens or default_token_store()

    # -- token endpoint --------------------------------------------------
    def token_request(
        self,
        authorization_header: Optional[str],
        form: dict,
    ) -> tuple[int, dict]:
        """Handle ``POST /oauth/token``.  Client auth via HTTP Basic or form
        fields (both allowed by RFC 6749 §2.3.1).  Returns (http_status, body).
        """
        grant = form.get("grant_type", "")
        if grant != "client_credentials":
            return 400, {
                "error": "unsupported_grant_type",
                "error_description": f"grant_type {grant!r} not supported",
            }
        client_id, client_secret = self._client_creds(authorization_header, form)
        if not client_id:
            return 401, {"error": "invalid_client"}
        rec = self.store.by_oauth_key(client_id)
        # a record without a secret must never authenticate (compare_digest
        # of two empty strings is True)
        if (
            rec is None
            or not rec.oauth_secret
            or not hmac.compare_digest(
                rec.oauth_secret.encode(), (client_secret or "").encode()
            )
        ):
            return 401, {"error": "invalid_client"}
        token, ttl = self.tokens.issue(client_id)
        return 200, {
            "access_token": token,
            "token_type": "bearer",
            "expires_in": int(ttl),
            "scope": "read write",
        }

    @staticmethod
    def _client_creds(
        authorization_header: Optional[str], form: dict
    ) -> tuple[Optional[str], Optional[str]]:
        if authorization_header and authorization_header.lower().startswith("basic "):
            try:
                raw = base64.b64decode(authorization_header[6:]).decode()
                cid, _, secret = raw.partition(":")
                return cid, secret
            except Exception:
                return None, None
        return form.get("client_id"), form.get("client_secret")

    # -- resource auth ---------------------------------------------------
    def principal_for_bearer(self, authorization_header: Optional[str]) -> Optional[str]:
        if not authorization_header:
            return None
        parts = authorization_header.split(None, 1)
        if len(parts) != 2 or parts[0].lower() != "bearer":
            return None
        return self.tokens.principal(parts[1])

    def principal_for_token(self, token: Optional[str]) -> Optional[str]:
        """gRPC path: raw token from ``oauth_token`` metadata
        (``HeaderServerInterceptor.java:37-53``)."""
        if not token:
            return None
        return self.tokens.principal(token)
