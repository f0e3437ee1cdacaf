"""User-component contract (port of ``seldon_core_tpu/runtime/component.py``).

A user class may define any of

- ``predict(X, feature_names)``            (MODEL)
- ``route(X, feature_names)``              (ROUTER)
- ``aggregate(Xs, feature_names_list)``    (COMBINER)
- ``transform_input(X, feature_names)``    (TRANSFORMER)
- ``transform_output(X, feature_names)``   (OUTPUT_TRANSFORMER)
- ``score(X, feature_names)``              (OUTLIER_DETECTOR)
- ``send_feedback(request, names, reward, truth[, routing=])``
- ``class_names`` / ``tags()`` / ``metrics()``

or a pure tensor function ``predict_fn(params, X)`` (with a ``params``
attribute) or ``predict_fn(X)``.  The handle runs ``predict_fn`` eagerly
under ``torch.inference_mode()``; a numpy input goes to the component's
``device`` first (:meth:`ComponentHandle._to_device`, which a fused
segment of ``graph/plan.py`` calls too, so both convert alike).  The
plan compiler reads the same pure functions from the user object
(``predict_fn``, ``transform_input_fn``, ``transform_output_fn``,
``aggregate_fn``).  The reference runs jax with 64-bit types off, so there a
float64 (int64) input reaches ``predict_fn`` as float32 (int32); the handle
converts the same way.  Outputs stay where ``predict_fn`` left them (on the
card) until a message is serialized.

A component that sets ``accepts_messages = True`` implements the
message-level surface itself (``runtime.llm.LLMComponent``): the handle
forwards to it.
"""

from __future__ import annotations

import importlib
import inspect
import logging
from typing import Any, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.messages import (
    Feedback,
    Meta,
    Metric,
    MetricType,
    SeldonMessage,
)

__all__ = ["SERVICE_TYPES", "SeldonComponentError", "ComponentHandle",
           "load_component", "host_dtype"]

logger = logging.getLogger(__name__)

SERVICE_TYPES = ("MODEL", "ROUTER", "COMBINER", "TRANSFORMER",
                 "OUTPUT_TRANSFORMER", "OUTLIER_DETECTOR")
_METHODS = ("predict", "route", "aggregate", "transform_input",
            "transform_output", "send_feedback", "tags", "metrics", "score")
# what jax (64-bit types off) makes of a host array it is given
_JAX_DTYPES = {np.dtype(np.float64): np.float32,
               np.dtype(np.int64): np.int32,
               np.dtype(np.uint64): np.uint32}


def host_dtype(x: Any) -> str:
    """The dtype name ``x`` has once a handle has moved it to its device
    (a float64 host array becomes float32, as jax makes it)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    dt = np.dtype(x.dtype) if hasattr(x, "dtype") else np.asarray(x).dtype
    return np.dtype(_JAX_DTYPES.get(dt, dt)).name


class SeldonComponentError(Exception):
    """Maps to a FAILURE Status on the wire."""

    def __init__(self, message: str, status_code: int = 400, reason: str = ""):
        super().__init__(message)
        self.status_code = status_code
        self.reason = reason


def validate_metrics(metrics: Any) -> list[Metric]:
    """A user ``metrics()`` value as Metrics; malformed entries raise
    ``MICROSERVICE_BAD_METRIC``."""
    if metrics is None:
        return []
    if not isinstance(metrics, (list, tuple)):
        raise SeldonComponentError("metrics() must return a list",
                                   reason="MICROSERVICE_BAD_METRIC")
    out = []
    for m in metrics:
        if isinstance(m, Metric):
            out.append(m)
            continue
        if not isinstance(m, dict) or "key" not in m or "value" not in m:
            raise SeldonComponentError(f"bad metric entry: {m!r}",
                                       reason="MICROSERVICE_BAD_METRIC")
        try:
            mtype = MetricType(m.get("type", "COUNTER"))
            value = float(m["value"])
        except (ValueError, TypeError) as e:
            raise SeldonComponentError(f"bad metric entry: {m!r}: {e}",
                                       reason="MICROSERVICE_BAD_METRIC")
        out.append(Metric(key=str(m["key"]), type=mtype, value=value,
                          tags=dict(m.get("tags", {}))))
    return out


def _positional_params(fn) -> list:
    return [p for p in inspect.signature(fn).parameters.values()
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD)]


def _as_array(Y: Any):
    return Y if hasattr(Y, "dtype") else np.asarray(Y)


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ComponentHandle:
    """Wraps a user object and adapts it to SeldonMessage in and out."""

    def __init__(self, user_object: Any, name: str = "",
                 service_type: str = "MODEL"):
        if service_type not in SERVICE_TYPES:
            raise ValueError(f"unknown service_type {service_type}")
        self.user = user_object
        self.name = name or type(user_object).__name__
        self.service_type = service_type
        self._has = {m: callable(getattr(user_object, m, None))
                     for m in _METHODS}
        self.device = torch.device(getattr(user_object, "device", "cpu"))
        self._fn = None
        predict_fn = getattr(user_object, "predict_fn", None)
        if callable(predict_fn):
            # arity decides the calling convention: (params, X) vs (X)
            self._takes_params = len(_positional_params(predict_fn)) >= 2
            if self._takes_params and not hasattr(user_object, "params"):
                raise ValueError(
                    f"{self.name}: predict_fn takes (params, X) but the "
                    "component has no `params` attribute")
            self._fn = predict_fn
        if getattr(user_object, "accepts_messages", False):
            for m in ("predict", "route", "aggregate", "transform_input",
                      "transform_output", "send_feedback", "score", "stream"):
                fn = getattr(user_object, m, None)
                if callable(fn):
                    setattr(self, m, fn)
            user_has = getattr(user_object, "has", None)
            if callable(user_has):
                self.has = user_has  # type: ignore[method-assign]

    def has(self, method: str) -> bool:
        if method == "predict":
            return self._fn is not None or self._has["predict"]
        if method == "stream":
            return callable(getattr(self, "stream", None))
        return self._has.get(method, False)

    # ---- response assembly --------------------------------------------
    def _component_meta(self) -> Meta:
        meta = Meta()
        if self._has["tags"]:
            try:
                meta.tags.update(self.user.tags() or {})
            except Exception:
                logger.exception("tags() failed for %s", self.name)
        if self._has["metrics"]:
            meta.metrics.extend(validate_metrics(self.user.metrics()))
        return meta

    def _class_names(self, X: Any, fallback: Sequence[str]) -> list[str]:
        cn = getattr(self.user, "class_names", None)
        if cn is not None:
            return list(cn)
        if getattr(X, "ndim", np.ndim(X)) >= 2:
            return [f"t:{i}" for i in range(X.shape[-1])]
        return list(fallback)

    # ---- methods -------------------------------------------------------
    def _to_device(self, X: Any) -> Any:
        if isinstance(X, torch.Tensor):
            return X.to(self.device)
        if isinstance(X, (np.ndarray, list, tuple)):
            arr = np.asarray(X)
            arr = arr.astype(_JAX_DTYPES.get(arr.dtype, arr.dtype),
                             copy=False)
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        return X

    def predict(self, msg: SeldonMessage) -> SeldonMessage:
        if self._fn is not None:
            X = (self._to_device(msg.data) if msg.data is not None
                 else self._decode_nontensor(msg))
            with torch.inference_mode():
                Y = (self._fn(self.user.params, X) if self._takes_params
                     else self._fn(X))
            return SeldonMessage(data=Y, names=self._class_names(Y, msg.names),
                                 meta=self._component_meta())
        if not self._has["predict"]:
            raise SeldonComponentError(f"{self.name} has no predict()",
                                       reason="MICROSERVICE_NO_METHOD")
        Y = self.user.predict(self._user_input(msg), msg.names)
        return SeldonMessage(data=_as_array(Y),
                             names=self._class_names(Y, msg.names),
                             meta=self._component_meta())

    def route(self, msg: SeldonMessage) -> int:
        """ROUTER: the branch index; -1 means every child."""
        if not self._has["route"]:
            return -1
        branch = self.user.route(self._user_input(msg), msg.names)
        return int(_host(branch).ravel()[0])

    def aggregate(self, msgs: Sequence[SeldonMessage]) -> SeldonMessage:
        if not self._has["aggregate"]:
            raise SeldonComponentError(f"{self.name} has no aggregate()",
                                       reason="MICROSERVICE_NO_METHOD")
        Y = self.user.aggregate([self._user_input(m) for m in msgs],
                                [m.names for m in msgs])
        names = self._class_names(Y, msgs[0].names if msgs else [])
        return SeldonMessage(data=_as_array(Y), names=names,
                             meta=self._component_meta())

    def transform_input(self, msg: SeldonMessage) -> SeldonMessage:
        if self.service_type == "OUTLIER_DETECTOR" and self._has["score"]:
            # an outlier detector passes the data through and tags per-row
            # scores
            scores = self.score(msg)
            out = SeldonMessage(data=msg.data, names=list(msg.names),
                                meta=self._component_meta(),
                                encoding=msg.encoding)
            out.meta.tags["outlierScore"] = np.asarray(scores).ravel().tolist()
            return out
        if not self._has["transform_input"]:
            return msg
        Y = self.user.transform_input(self._user_input(msg), msg.names)
        return SeldonMessage(data=_as_array(Y),
                             names=self._transformed_names(msg.names),
                             meta=self._component_meta())

    def transform_output(self, msg: SeldonMessage) -> SeldonMessage:
        if not self._has["transform_output"]:
            return msg
        Y = self.user.transform_output(self._user_input(msg), msg.names)
        return SeldonMessage(
            data=_as_array(Y),
            names=self._transformed_names(msg.names, output=True),
            meta=self._component_meta())

    def score(self, msg: SeldonMessage) -> np.ndarray:
        return np.asarray(self.user.score(self._user_input(msg), msg.names))

    def send_feedback(self, fb: Feedback) -> Optional[SeldonMessage]:
        if not self._has["send_feedback"]:
            return None
        req = fb.request.host_data() if fb.request is not None else None
        names = fb.request.names if fb.request is not None else []
        truth = fb.truth.host_data() if fb.truth is not None else None
        resp = fb.response
        routing = None
        if resp is not None and self.name in resp.meta.routing:
            routing = resp.meta.routing[self.name]
        if "routing" in inspect.signature(self.user.send_feedback).parameters:
            ret = self.user.send_feedback(req, names, fb.reward, truth,
                                          routing=routing)
        else:
            ret = self.user.send_feedback(req, names, fb.reward, truth)
        return None if ret is None else SeldonMessage(data=_as_array(ret))

    # ---- helpers -------------------------------------------------------
    def _user_input(self, msg: SeldonMessage) -> Any:
        if msg.data is not None:
            if self._fn is not None or getattr(self.user, "accepts_tensors",
                                               False):
                return msg.data
            return msg.host_data()
        return self._decode_nontensor(msg)

    @staticmethod
    def _decode_nontensor(msg: SeldonMessage) -> Any:
        if msg.bin_data is not None:
            return msg.bin_data
        if msg.str_data is not None:
            return msg.str_data
        return msg.json_data

    def _transformed_names(self, names: list[str],
                           output: bool = False) -> list[str]:
        cn = getattr(self.user, "class_names" if output else "feature_names",
                     None)
        return list(cn) if cn is not None else list(names)


def load_component(model_class: str, parameters: Optional[dict] = None,
                   service_type: str = "MODEL", **extra: Any
                   ) -> ComponentHandle:
    """Import ``pkg.module:Class``, build it from the node's typed
    parameters and ``extra`` (for example ``device=``), and wrap it in a
    :class:`ComponentHandle`.  Parameters the constructor does not take are
    dropped, as the reference does, unless it takes ``**kwargs``."""
    mod_name, _, cls_name = model_class.partition(":")
    mod = importlib.import_module(mod_name)
    cls = getattr(mod, cls_name or mod_name.rsplit(".", 1)[-1])
    kwargs = {**(parameters or {}), **extra}
    sig = inspect.signature(cls)
    if not any(p.kind == inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values()):
        kwargs = {k: v for k, v in kwargs.items() if k in sig.parameters}
    return ComponentHandle(cls(**kwargs), service_type=service_type)
