"""A YAML reader for the subset the repo's helm charts use, so the chart
renderer (``operator/chart.py``) needs no PyYAML.

Covered: documents split by ``---``; block mappings and sequences
(a sequence may sit at its key's indent); flow sequences and mappings,
over several lines too; plain, single- and double-quoted scalars (the
quoted ones over several lines, with YAML's line folding and every
double-quoted escape); literal and folded block scalars with chomping
indicators; anchors and aliases; comments.  Plain scalars resolve as
PyYAML's ``safe_load`` resolves them (YAML 1.1: null, bool, int, float,
else a string).  Tags, complex keys, merge keys and timestamps are not
covered: a chart that needs them fails loudly here rather than reading
differently.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, Optional

__all__ = ["YamlError", "safe_load", "safe_load_all"]


class YamlError(ValueError):
    pass


_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE",
                          "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF"), False)}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9_]+(?:[eE][-+][0-9]+)?
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(s: str, conv) -> Any:
    sign = -1 if s.startswith("-") else 1
    value = 0
    for part in s.lstrip("+-").split(":"):
        value = value * 60 + conv(part)
    return sign * value


def _resolve(s: str) -> Any:
    """A plain scalar's value, as PyYAML's safe resolver reads it."""
    if _NULL.match(s):
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        t = s.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        body = t.lstrip("+-")
        if ":" in body:
            return sign * _sexagesimal(body, int)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        if ":" in t:
            return _sexagesimal(t, float)
        return float(t)
    if _TIMESTAMP.match(s):
        raise YamlError(f"timestamps are not supported: {s!r}")
    return s


def _strip_comment(s: str) -> str:
    """A plain scalar without its trailing `` # comment``."""
    m = re.search(r"(^|\s)#", s)
    return (s[:m.start()] if m else s).rstrip()


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _blank(line: str) -> bool:
    s = line.strip()
    return not s or s.startswith("#")


class _Reader:
    def __init__(self, lines: list[str]):
        self.lines = lines
        self.i = 0
        self.anchors: dict[str, Any] = {}

    # -- navigation ------------------------------------------------------
    def _next(self) -> Optional[int]:
        """Index of the next significant line, or None."""
        while self.i < len(self.lines) and _blank(self.lines[self.i]):
            self.i += 1
        return self.i if self.i < len(self.lines) else None

    def document(self) -> Any:
        if self._next() is None:
            return None
        value = self._block(_indent(self.lines[self.i]))
        if self._next() is not None:
            raise YamlError(f"unexpected content at line {self.i + 1}: "
                            f"{self.lines[self.i]!r}")
        return value

    # -- block nodes -----------------------------------------------------
    def _block(self, indent: int) -> Any:
        line = self.lines[self.i]
        content = line.strip()
        if content == "-" or content.startswith("- "):
            return self._sequence(indent)
        if self._key_split(content) is not None:
            return self._mapping(indent)
        self.i += 1
        return self._inline(content, indent - 1)

    def _sequence(self, indent: int) -> list:
        out: list = []
        while self._next() is not None:
            line = self.lines[self.i]
            content = line.strip()
            if _indent(line) != indent or not (
                    content == "-" or content.startswith("- ")):
                break
            rest = content[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                self.i += 1
                out.append(self._nested(indent, allow_same=False))
                continue
            col = indent + (len(content) - len(rest))
            if (rest.startswith("- ") or rest == "-"
                    or self._key_split(rest) is not None):
                # the item is itself a block node starting mid-line:
                # re-read the line as if it began at that column
                self.lines[self.i] = " " * col + rest
                out.append(self._block(col))
                continue
            self.i += 1
            out.append(self._inline(rest, indent))
        return out

    def _mapping(self, indent: int) -> dict:
        out: dict = {}
        while self._next() is not None:
            line = self.lines[self.i]
            if _indent(line) != indent:
                break
            content = line.strip()
            split = self._key_split(content)
            if split is None:
                break
            key, rest = split
            if key in out:
                raise YamlError(f"duplicate key {key!r}")
            self.i += 1
            if not rest or rest.startswith("#"):
                out[key] = self._nested(indent, allow_same=True)
            else:
                out[key] = self._inline(rest, indent)
        return out

    def _nested(self, indent: int, allow_same: bool) -> Any:
        """The block node under a key or dash whose line ended there."""
        if self._next() is None:
            return None
        line = self.lines[self.i]
        ind = _indent(line)
        if ind > indent:
            return self._block(ind)
        content = line.strip()
        if allow_same and ind == indent and (
                content == "-" or content.startswith("- ")):
            return self._sequence(indent)
        return None

    def _key_split(self, content: str) -> Optional[tuple]:
        """``(key, rest)`` when the line is a ``key: value`` entry."""
        if (not content or content[0] in "[{&*!|>%@`#" or content == "-"
                or content.startswith("- ")):
            return None
        if content[0] in "\"'":
            end = self._quote_end(content, content[0])
            if end is None:
                return None
            after = content[end + 1:]
            if after.startswith(":") and (len(after) == 1
                                          or after[1] in " \t"):
                key = (self._double(content[1:end]) if content[0] == '"'
                       else content[1:end].replace("''", "'"))
                return key, after[1:].strip()
            return None
        m = re.search(r":(\s|$)", content)
        if m is None:
            return None
        key = content[:m.start()].rstrip()
        if " #" in key or "\t#" in key:
            return None
        return _resolve(key), content[m.end():].strip()

    @staticmethod
    def _quote_end(s: str, q: str, start: int = 1) -> Optional[int]:
        j = start
        while j < len(s):
            c = s[j]
            if q == '"' and c == "\\":
                j += 2
                continue
            if c == q:
                if q == "'" and j + 1 < len(s) and s[j + 1] == "'":
                    j += 2
                    continue
                return j
            j += 1
        return None

    # -- inline values ---------------------------------------------------
    def _inline(self, rest: str, indent: int) -> Any:
        """The value that starts on the current line with ``rest`` (the
        line itself already consumed) under a node at ``indent``."""
        if rest.startswith("&"):
            name, _, tail = rest[1:].partition(" ")
            tail = tail.strip()
            if not tail or tail.startswith("#"):
                value = self._nested(indent, allow_same=True)
            else:
                value = self._inline(tail, indent)
            self.anchors[name] = value
            return value
        if rest.startswith("*"):
            name = _strip_comment(rest[1:])
            if name not in self.anchors:
                raise YamlError(f"unknown alias *{name}")
            return self.anchors[name]
        if rest[0] in "|>":
            return self._block_scalar(rest, indent)
        if rest[0] in "\"'":
            return self._quoted(rest, indent)
        if rest[0] in "[{":
            return self._flow_text(rest)
        if rest.startswith("!"):
            raise YamlError(f"tags are not supported: {rest!r}")
        return self._plain(rest, indent)

    def _continuation(self, indent: int) -> list[str]:
        """Raw lines that continue a scalar begun under ``indent``."""
        out = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.strip() and _indent(line) <= indent:
                break
            out.append(line)
            self.i += 1
        return out

    def _plain(self, rest: str, indent: int) -> Any:
        first = _strip_comment(rest)
        if first != rest.rstrip():
            return _resolve(first)  # a comment ends a plain scalar
        parts = [first]
        save = self.i
        more = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            s = line.strip()
            if s and (_indent(line) <= indent or s.startswith("#")):
                break
            if s and (self._key_split(s) is not None or s.startswith("- ")):
                break
            more.append(s)
            self.i += 1
        while more and not more[-1]:
            more.pop()
            self.i -= 1
        if not more:
            self.i = save
            return _resolve(first)
        return _fold([*parts, *more])

    def _quoted(self, rest: str, indent: int) -> str:
        q = rest[0]
        text = rest
        end = self._quote_end(text, q)
        while end is None:
            if self.i >= len(self.lines):
                raise YamlError("unterminated quoted scalar")
            text += "\n" + self.lines[self.i]
            self.i += 1
            end = self._quote_end(text, q)
        tail = text[end + 1:].strip()
        if tail and not tail.startswith("#"):
            raise YamlError(f"content after a quoted scalar: {tail!r}")
        body = text[1:end]
        if q == '"':
            return self._double(body)
        return _fold_quoted(body).replace("''", "'")

    @staticmethod
    def _double(body: str) -> str:
        out: list[str] = []
        keep = 0  # length of out that line folding must not trim
        j = 0
        n = len(body)
        while j < n:
            c = body[j]
            if c == "\\":
                nxt = body[j + 1] if j + 1 < n else ""
                if nxt == "\n":
                    j += 2
                    while j < n and body[j] in " \t":
                        j += 1
                    continue
                if nxt in _HEX_ESCAPES:
                    width = _HEX_ESCAPES[nxt]
                    out.append(chr(int(body[j + 2:j + 2 + width], 16)))
                    j += 2 + width
                elif nxt in _ESCAPES:
                    out.append(_ESCAPES[nxt])
                    j += 2
                else:
                    raise YamlError(f"unknown escape \\{nxt}")
                keep = len(out)
                continue
            if c == "\n":
                while len(out) > keep and out[-1] in (" ", "\t"):
                    out.pop()
                j += 1
                breaks = 0
                while True:
                    k = j
                    while k < n and body[k] in " \t":
                        k += 1
                    if k < n and body[k] == "\n":
                        breaks += 1
                        j = k + 1
                        continue
                    j = k
                    break
                out.append("\n" * breaks if breaks else " ")
                keep = len(out)
                continue
            out.append(c)
            j += 1
        return "".join(out)

    def _block_scalar(self, header: str, indent: int) -> str:
        m = re.match(r"^([|>])([+-]?)([1-9]?)([+-]?)\s*(#.*)?$", header)
        if m is None:
            raise YamlError(f"bad block scalar header {header!r}")
        style, chomp = m.group(1), m.group(2) or m.group(4)
        raw = self._continuation(indent)
        # trailing blank lines belong to the chomping, not the next node
        body_lines = list(raw)
        if m.group(3):
            ind = indent + int(m.group(3))
        else:
            firsts = [ln for ln in body_lines if ln.strip()]
            ind = _indent(firsts[0]) if firsts else indent + 1
        lines = [ln[ind:] if ln.strip() else "" for ln in body_lines]
        trailing = 0
        while lines and not lines[-1]:
            lines.pop()
            trailing += 1
        if style == "|":
            text = "\n".join(lines)
        else:
            text = _fold_block(lines)
        if not lines:
            return "" if chomp != "+" else "\n" * trailing
        if chomp == "-":
            return text
        if chomp == "+":
            return text + "\n" + "\n" * trailing
        return text + "\n"

    # -- flow collections ------------------------------------------------
    def _flow_text(self, rest: str) -> Any:
        text = rest
        while True:
            end = _flow_end(text)
            if end is not None:
                break
            if self.i >= len(self.lines):
                raise YamlError("unterminated flow collection")
            text += "\n" + self.lines[self.i]
            self.i += 1
        tail = text[end:].strip()
        if tail and not tail.startswith("#"):
            raise YamlError(f"content after a flow collection: {tail!r}")
        value, _ = _Flow(text[:end], self).node(0)
        return value


def _fold(parts: list[str]) -> str:
    """Multi-line plain scalar: single breaks fold to spaces, each empty
    line is a newline."""
    out, pending = parts[0], 0
    for p in parts[1:]:
        if not p:
            pending += 1
            continue
        out += ("\n" * pending if pending else " ") + p
        pending = 0
    return out


def _fold_quoted(body: str) -> str:
    lines = body.split("\n")
    if len(lines) == 1:
        return body
    parts = [lines[0].rstrip(" \t")]
    parts += [ln.strip(" \t") for ln in lines[1:-1]]
    parts.append(lines[-1].lstrip(" \t"))
    out, pending = parts[0], 0
    for p in parts[1:-1]:
        if not p:
            pending += 1
            continue
        out += ("\n" * pending if pending else " ") + p
        pending = 0
    return out + ("\n" * pending if pending else " ") + parts[-1]


def _fold_block(lines: list[str]) -> str:
    """A folded block scalar's lines (indent removed, no trailing empty
    lines): a break between two text lines folds to a space, or to the
    empty lines between them; breaks next to a more-indented line stay."""
    k = 0
    while k < len(lines) and not lines[k]:
        k += 1
    out = ["\n" * k]
    n = len(lines)
    while k < n:
        ln = lines[k]
        out.append(ln)
        j, empties = k + 1, 0
        while j < n and not lines[j]:
            empties += 1
            j += 1
        if j >= n:
            break
        if ln[0] not in " \t" and lines[j][0] not in " \t":
            out.append("\n" * empties if empties else " ")
        else:
            out.append("\n" * (1 + empties))
        k = j
    return "".join(out)


def _flow_end(text: str) -> Optional[int]:
    """The index after the flow collection that opens ``text``."""
    depth, j, n = 0, 0, len(text)
    while j < n:
        c = text[j]
        if c in "\"'":
            end = _Reader._quote_end(text, c, j + 1)
            if end is None:
                return None
            j = end + 1
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
            if depth == 0:
                return j + 1
        elif c == "#" and (j == 0 or text[j - 1] in " \t\n"):
            nl = text.find("\n", j)
            if nl < 0:
                return None
            j = nl
            continue
        j += 1
    return None


class _Flow:
    def __init__(self, text: str, reader: _Reader):
        self.t = text
        self.r = reader

    def _ws(self, j: int) -> int:
        while j < len(self.t):
            c = self.t[j]
            if c in " \t\n":
                j += 1
            elif c == "#" and (j == 0 or self.t[j - 1] in " \t\n"):
                nl = self.t.find("\n", j)
                j = len(self.t) if nl < 0 else nl
            else:
                break
        return j

    def node(self, j: int) -> tuple:
        j = self._ws(j)
        c = self.t[j]
        if c == "[":
            out, j = [], self._ws(j + 1)
            while self.t[j] != "]":
                value, j = self.node(j)
                out.append(value)
                j = self._ws(j)
                if self.t[j] == ",":
                    j = self._ws(j + 1)
            return out, j + 1
        if c == "{":
            out, j = {}, self._ws(j + 1)
            while self.t[j] != "}":
                key, j = self.node(j)
                j = self._ws(j)
                value = None
                if self.t[j] == ":":
                    value, j = self.node(j + 1)
                    j = self._ws(j)
                out[key] = value
                if self.t[j] == ",":
                    j = self._ws(j + 1)
            return out, j + 1
        if c in "\"'":
            end = _Reader._quote_end(self.t, c, j + 1)
            body = self.t[j + 1:end]
            value = (self.r._double(body) if c == '"'
                     else _fold_quoted(body).replace("''", "'"))
            return value, end + 1
        if c == "*":
            m = re.match(r"\*([^\s,\]\}]+)", self.t[j:])
            return self.r.anchors[m.group(1)], j + m.end()
        m = re.match(r"(?:[^,\[\]{}:#\n]|:(?![\s,\]\}])|(?<!\s)#)+",
                     self.t[j:])
        raw = m.group(0) if m else ""
        return _resolve(" ".join(raw.split())), j + len(raw)


def _documents(text: str) -> Iterator[list[str]]:
    doc: list[str] = []
    for line in text.splitlines():
        if line.rstrip() == "---" or line.startswith("--- "):
            yield doc
            doc = []
            tail = line[4:].strip()
            if tail and not tail.startswith("#"):
                doc.append(tail)
            continue
        if line.rstrip() == "...":
            continue
        if line.startswith("%"):
            raise YamlError(f"directives are not supported: {line!r}")
        doc.append(line)
    yield doc


def safe_load_all(text: str) -> Iterator[Any]:
    """Every document of ``text``, as ``yaml.safe_load_all`` yields them."""
    for k, lines in enumerate(_documents(text)):
        if k == 0 and all(_blank(ln) for ln in lines):
            continue  # no document before the first ``---``
        yield _Reader(lines).document()


def safe_load(text: str) -> Any:
    """The single document of ``text``, as ``yaml.safe_load`` reads it."""
    docs = list(safe_load_all(text))
    if len(docs) > 1:
        raise YamlError("expected a single document")
    return docs[0] if docs else None
