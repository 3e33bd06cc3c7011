"""A reader for the subset of YAML that the configuration files use.

The card's machine has no PyYAML, so the port reads its ``preprocess.yaml``,
``model.yaml`` and ``train.yaml`` with this module, on every machine alike.
It takes what those files and ``yaml.safe_dump`` of them hold:

- block mappings nested by indentation, with bare or quoted keys;
- block sequences (``- item``), also at their key's own indentation, as
  ``yaml.safe_dump`` writes them, and mappings started on a ``- `` line;
- flow sequences and mappings (``[9, 1]``, ``[]``, ``{a: 1}``, ``{}``),
  also over several lines;
- plain scalars, resolved as YAML 1.1 does (PyYAML's ``safe_load``):
  ``true``/``yes``/``on`` and their opposites, decimal ints, floats with a
  dot (``1.0e-09``; ``1e-9`` stays a string, as in PyYAML), ``.inf`` and
  ``.nan``, ``null``/``~``/empty;
- single- and double-quoted strings, and ``#`` comments.

Anything else (anchors, tags, block scalars ``|``/``>``, multi-line plain
or quoted scalars, several documents) raises ``ValueError`` with the line
number.
"""

from __future__ import annotations

import re
from typing import Any

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_UNSUPPORTED = ("&", "*", "!", "|", ">", "%", "@", "`")


def _error(lineno: int, msg: str) -> ValueError:
    return ValueError(f"YAML line {lineno}: {msg}")


def _unquoted(text: str):
    """(index, char) of ``text`` outside quoted scalars.  A quote opens a
    scalar only where one can start (at the start, or after ``[{,:-?`` and
    spaces), so the apostrophe of a plain ``it's`` is text."""
    quote, prev, i = None, "", 0
    while i < len(text):
        ch = text[i]
        if quote:
            if quote == '"' and ch == "\\":
                i += 1
            elif ch == quote:
                quote, prev = None, ch
        elif ch in "'\"" and prev in ("", "[", "{", ",", ":", "-", "?"):
            quote = ch
        else:
            yield i, ch
            if not ch.isspace():
                prev = ch
        i += 1


def _open_brackets(text: str) -> int:
    """Flow brackets opened and not closed in ``text``, outside quotes."""
    depth = 0
    for _, ch in _unquoted(text):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _strip_comment(text: str) -> str:
    """``text`` without a ``#`` comment that starts outside quotes."""
    for i, ch in _unquoted(text):
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _resolve(text: str, lineno: int) -> Any:
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    if text[0] in _UNSUPPORTED or text.startswith(("- ", "? ")):
        raise _error(lineno, f"unsupported YAML: {text!r}")
    return text


def _quoted(text: str, lineno: int) -> tuple[str, int]:
    """The quoted string at the start of ``text`` and the index past it."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            out.append({"n": "\n", "t": "\t", "\\": "\\", '"': '"',
                        "/": "/", "0": "\0"}.get(esc, "\\" + esc))
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise _error(lineno, f"unterminated quote in {text!r}")


def _split_flow(body: str, lineno: int) -> list[str]:
    """Split the inside of a flow collection at its top-level commas."""
    parts, depth, start = [], 0, 0
    for i, ch in _unquoted(body):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
    if depth:
        raise _error(lineno, f"unbalanced flow collection {body!r}")
    parts.append(body[start:])
    parts = [p.strip() for p in parts]
    if parts and parts[-1] == "":
        parts.pop()                      # a trailing comma
    return parts


def _split_key(text: str, lineno: int) -> tuple[str, str] | None:
    """``key: rest`` → (key, rest); None when ``text`` is no mapping
    entry."""
    if text[0] in "'\"":
        key, end = _quoted(text, lineno)
        rest = text[end:].lstrip()
        if not rest.startswith(":"):
            return None
        return key, rest[1:].strip()
    m = re.match(r"([^\s:#'\"\[\]{},][^:#]*?|[^:#]*?)\s*:(?:\s+|$)", text)
    if m is None or text.startswith(("[", "{")):
        return None
    return m.group(1), text[m.end():].strip()


def _flow(text: str, lineno: int) -> Any:
    """A value written on one line: a flow collection or a scalar."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise _error(lineno, f"flow sequence must end its line: {text!r}")
        return [_flow(p, lineno) for p in _split_flow(text[1:-1], lineno)]
    if text.startswith("{"):
        if not text.endswith("}"):
            raise _error(lineno, f"flow mapping must end its line: {text!r}")
        out = {}
        for part in _split_flow(text[1:-1], lineno):
            kv = _split_key(part, lineno)
            if kv is None:
                raise _error(lineno, f"not a key: value pair: {part!r}")
            out[kv[0]] = _flow(kv[1], lineno)
        return out
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, lineno)
        if text[end:].strip():
            raise _error(lineno, f"text after a quoted string: {text!r}")
        return value
    return _resolve(text, lineno)


class _Parser:
    def __init__(self, source: str):
        self.lines = []                  # (lineno, indent, content)
        raw_lines = source.splitlines()
        n = 0
        while n < len(raw_lines):
            raw = raw_lines[n]
            n += 1
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise _error(n, "tab in indentation")
            content = _strip_comment(raw).rstrip()
            if not content.strip():
                continue
            start = n
            while _open_brackets(content) > 0 and n < len(raw_lines):
                # a flow collection continued on the next lines
                content += " " + _strip_comment(raw_lines[n]).strip()
                n += 1
            n_line = start
            if content.strip() in ("---", "..."):
                if self.lines:
                    raise _error(n_line, "more than one document")
                continue
            indent = len(content) - len(content.lstrip(" "))
            self.lines.append((n_line, indent, content.strip()))
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        _, _, content = self.peek()
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        return self.mapping(indent)

    def value_after(self, indent: int, rest: str, lineno: int,
                    seq_at_same_indent: bool) -> Any:
        if rest:
            return _flow(rest, lineno)
        nxt = self.peek()
        if nxt is None:
            return None
        _, nindent, ncontent = nxt
        if nindent > indent:
            return self.block(nindent)
        if (seq_at_same_indent and nindent == indent
                and (ncontent == "-" or ncontent.startswith("- "))):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while (line := self.peek()) is not None and line[1] == indent:
            lineno, _, content = line
            if content == "-" or content.startswith("- "):
                break
            kv = _split_key(content, lineno)
            if kv is None:
                raise _error(lineno, f"expected 'key: value', got "
                                     f"{content!r}")
            key, rest = kv
            if key in out:
                raise _error(lineno, f"duplicate key {key!r}")
            self.i += 1
            out[key] = self.value_after(indent, rest, lineno, True)
        if (line := self.peek()) is not None and line[1] > indent:
            raise _error(line[0], "unexpected indentation")
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while (line := self.peek()) is not None and line[1] == indent:
            lineno, _, content = line
            if not (content == "-" or content.startswith("- ")):
                break
            rest = content[1:].strip()
            self.i += 1
            inner = indent + len(content) - len(rest)
            if rest == "-" or rest.startswith("- "):
                # a sequence that starts on the "- " line
                self.lines.insert(self.i, (lineno, inner, rest))
                out.append(self.sequence(inner))
            elif rest and _split_key(rest, lineno) is not None \
                    and rest[0] not in "[{":
                # a mapping that starts on the "- " line
                self.lines.insert(self.i, (lineno, inner, rest))
                out.append(self.mapping(inner))
            else:
                out.append(self.value_after(indent, rest, lineno, False))
        return out


def loads(source: str) -> Any:
    """Parse one YAML document of the supported subset; an empty document
    is ``None``."""
    parser = _Parser(source)
    if parser.peek() is None:
        return None
    lineno, indent, content = parser.peek()
    if indent:
        raise _error(lineno, "the document must start at column 0")
    if not (content == "-" or content.startswith("- ")) \
            and _split_key(content, lineno) is None:
        value = _flow(content, lineno)
        parser.i += 1
    else:
        value = parser.block(0)
    if parser.peek() is not None:
        raise _error(parser.peek()[0], "unexpected content")
    return value


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
