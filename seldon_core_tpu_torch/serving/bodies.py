"""JSON request bodies, and a helper process that parses the large ones.

A body of nested numbers (an image as ``ndarray`` is 150,528 of them)
takes tens of milliseconds to parse, in ``json.loads`` and in
``np.asarray`` of the nested lists: two C calls that hold the GIL
throughout.  Parsed on a thread of the serving process, they stall the
event loop's thread every time it wants the GIL back, and a batch's
forward on the loop wants it back after every torch operation: 20
operations behind 35 ms parses cost 700 ms, enough to age queued requests
past ``seldon.io/batch-shed-after-ms``.  So a body of at least
``HELPER_BYTES`` is parsed by :class:`BodyParser`'s helper process (this
module run as a script, on the standard library and numpy only): the
serving process then holds the GIL only to copy bytes through a pipe and to
unpickle the arrays.  The answer is the parsed JSON with every message's
``data.ndarray`` already a numpy array, which ``SeldonMessage.from_dict``
takes as it is.

Run ``python -m seldon_core_tpu_torch.serving.bodies`` only as
:class:`BodyParser` does: it reads length-prefixed pickled requests on
stdin and exits at end of input.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import subprocess
import sys
import threading
from pathlib import Path
from typing import Any, Optional
from urllib.parse import parse_qs

import numpy as np

__all__ = ["BadRequest", "HELPER_BYTES", "payload_json", "parse_body",
           "BodyParser"]

#: bodies at least this large go to the helper process
HELPER_BYTES = 1 << 16

_LEN = struct.Struct("<Q")


class BadRequest(Exception):
    """Answers 400 with the reference's FAILURE body."""


def payload_json(body: bytes, ctype: str) -> Any:
    """A raw JSON body or the form field ``json=`` (the reference's wire
    compatibility)."""
    if not body:
        raise BadRequest("empty request body")
    try:
        if "application/x-www-form-urlencoded" in ctype \
                or body[:5] == b"json=":
            return json.loads(parse_qs(body.decode())["json"][0])
        return json.loads(body)
    except (ValueError, KeyError) as e:
        raise BadRequest(f"malformed request: {e}")


def _ndarray_to_numpy(msg: Any) -> None:
    data = msg.get("data") if isinstance(msg, dict) else None
    if isinstance(data, dict) and isinstance(data.get("ndarray"), list):
        try:
            data["ndarray"] = np.asarray(data["ndarray"])
        except ValueError:
            pass  # ragged: SeldonMessage.from_dict raises the same error


def parse_body(body: bytes, ctype: str) -> Any:
    """:func:`payload_json`, with the ``ndarray`` of every message it holds
    (the body itself, a feedback's parts, an aggregate's list) as a numpy
    array."""
    d = payload_json(body, ctype)
    if isinstance(d, dict):
        _ndarray_to_numpy(d)
        for part in ("request", "response", "truth"):
            _ndarray_to_numpy(d.get(part))
        for m in d.get("seldonMessages") or ():
            _ndarray_to_numpy(m)
    return d


def _write(f, payload: bytes) -> None:
    f.write(_LEN.pack(len(payload)))
    f.write(payload)
    f.flush()


def _read(f) -> bytes:
    head = f.read(_LEN.size)
    if len(head) < _LEN.size:
        raise EOFError("body parser closed its pipe")
    n = _LEN.unpack(head)[0]
    out = f.read(n)
    if len(out) < n:
        raise EOFError("body parser closed its pipe")
    return out


class BodyParser:
    """The serving process's side of the helper: :meth:`parse` sends one
    body and waits for its answer (one at a time; call it from the
    server's decoder thread).  The helper starts at the first call, and
    again if it has died."""

    def __init__(self):
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()

    def _start(self) -> subprocess.Popen:
        if self._proc is None or self._proc.poll() is not None:
            root = str(Path(__file__).resolve().parents[2])
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (root, env.get("PYTHONPATH")) if p)
            self._proc = subprocess.Popen(
                [sys.executable, "-m", __name__], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, env=env)
        return self._proc

    def parse(self, body: bytes, ctype: str) -> Any:
        """:func:`parse_body` of ``body`` in the helper process; raises
        :class:`BadRequest` as it does."""
        req = pickle.dumps((body, ctype), protocol=5)
        with self._lock:
            for attempt in (0, 1):
                proc = self._start()
                try:
                    _write(proc.stdin, req)
                    kind, value = pickle.loads(_read(proc.stdout))
                    break
                except (OSError, EOFError):
                    self._stop()  # died: start a new one, once
                    if attempt:
                        raise
        if kind == "bad":
            raise BadRequest(value)
        if kind == "error":
            raise RuntimeError(f"body parser: {value}")
        return value

    def _stop(self) -> None:
        proc, self._proc = self._proc, None
        if proc is not None:
            for f in (proc.stdin, proc.stdout):
                try:
                    f.close()
                except OSError:
                    pass
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def close(self) -> None:
        with self._lock:
            self._stop()


def _serve() -> None:
    """The helper's loop: one answer per request, until end of input."""
    fin, fout = sys.stdin.buffer, sys.stdout.buffer
    while True:
        try:
            body, ctype = pickle.loads(_read(fin))
        except EOFError:
            return
        try:
            out = ("ok", parse_body(body, ctype))
        except BadRequest as e:
            out = ("bad", str(e))
        except Exception as e:
            out = ("error", f"{type(e).__name__}: {e}")
        _write(fout, pickle.dumps(out, protocol=5))


if __name__ == "__main__":
    _serve()
