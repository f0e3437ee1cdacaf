"""Component boot and errors (port of the parts of
``seldon_core_tpu/runtime/component.py`` this slice needs)."""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Optional

__all__ = ["SeldonComponentError", "load_component"]


class SeldonComponentError(Exception):
    """Maps to a FAILURE Status on the wire."""

    def __init__(self, message: str, status_code: int = 400, reason: str = ""):
        super().__init__(message)
        self.status_code = status_code
        self.reason = reason


def load_component(model_class: str, parameters: Optional[dict] = None,
                   **extra: Any):
    """Import ``pkg.module:Class`` and build it from the node's typed
    parameters; ``extra`` (for example ``device=``) joins them.  Parameters
    the constructor does not take are dropped, as the reference does, unless
    it takes ``**kwargs``."""
    mod_name, _, cls_name = model_class.partition(":")
    mod = importlib.import_module(mod_name)
    cls = getattr(mod, cls_name or mod_name.rsplit(".", 1)[-1])
    kwargs = {**(parameters or {}), **extra}
    sig = inspect.signature(cls)
    if not any(p.kind == inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values()):
        kwargs = {k: v for k, v in kwargs.items() if k in sig.parameters}
    return cls(**kwargs)
