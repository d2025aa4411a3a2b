"""A YAML reader and writer for the port's configs, with no PyYAML.

The GPU hosts the port runs on are not promised PyYAML, and every entry
point reads ``configs/*.yaml`` (``Config.load``).  So the port reads and
writes, itself, the subset of YAML that those files and
``yaml.safe_dump(data, default_flow_style=False, sort_keys=True)`` use:

* block mappings and block sequences, including a sequence of sequences
  (``- - 0``) and a sequence written at its key's indentation;
* flow collections on one line: ``[]``, ``{}``, ``[0.1, 'a', null]``,
  ``{a: 1}``;
* plain, single-quoted and double-quoted scalars, also over several lines
  (folded as YAML folds them), and comments.

``load`` resolves a plain scalar exactly as PyYAML's ``safe_load`` does
(YAML 1.1): ``1.0e-06`` is a float but ``1e-6`` a string; ``yes``, ``no``,
``on`` and ``off`` are booleans; ``null``, ``~`` and an empty value are
None; ``0x1f``, ``017`` (octal), ``0b101`` and ``1:30`` (base 60) are
integers; ``2001-12-14`` is a date.  Anything outside the subset raises
``YamlSubsetError`` with its line: anchors and aliases, tags, block scalars
(``|``, ``>``), complex keys (``?``, which ``yaml.safe_dump`` writes for an
empty key, a key over 128 characters or one with a line break), directives,
``---`` and a second document, tabs in indentation, and flow collections
that span lines.  A closing ``...`` (``safe_dump`` ends a lone scalar with
it) ends the document.

``dump`` writes block style with two-space indentation and sorted keys, as
``yaml.safe_dump`` does, except that it never folds a long line; both
``load`` and PyYAML read what it writes back to the same data.
"""

from __future__ import annotations

import datetime
import math
import re
from typing import Any, List, Tuple

__all__ = ["YamlSubsetError", "load", "dump"]


class YamlSubsetError(ValueError):
    """YAML outside the subset (or not YAML); ``line`` is 1-based."""

    def __init__(self, line: int, message: str):
        super().__init__(f"line {line}: {message}")
        self.line = line


# --------------------------------------------------------------------------
# scalar resolution: PyYAML's implicit resolvers (yaml/resolver.py) and
# SafeConstructor, for plain scalars only (a quoted scalar is a string)

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
# the first characters each resolver is tried for, in PyYAML's order
_RESOLVERS = (("bool", _BOOL, "yYnNtTfFoO"), ("float", _FLOAT, "-+0123456789."),
              ("int", _INT, "-+0123456789"), ("merge", re.compile(r"^<<$"), "<"),
              ("null", _NULL, "~nN"), ("timestamp", _TIMESTAMP, "0123456789"),
              ("value", re.compile(r"^=$"), "="))


def _sexagesimal(text: str, kind) -> Any:
    value = kind(0)
    for part in text.split(":"):
        value = value * 60 + kind(part)
    return value


def _construct_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _construct_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _construct_timestamp(text: str):
    v = _TIMESTAMP_PARTS.match(text).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
    tz = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tz = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tz)


def _resolve_kind(text: str) -> str:
    first = text[:1]
    for kind, regex, starts in _RESOLVERS:
        if (first in starts or (kind == "null" and text == "")) and regex.match(text):
            return kind
    return "str"


def _resolve_plain(text: str, line: int = 0) -> Any:
    """A plain scalar's value, as PyYAML's ``safe_load`` constructs it."""
    kind = _resolve_kind(text)
    if kind == "bool":
        return text.lower() in ("yes", "true", "on")
    if kind == "float":
        return _construct_float(text)
    if kind == "int":
        return _construct_int(text)
    if kind == "null":
        return None
    if kind == "timestamp":
        return _construct_timestamp(text)
    if kind in ("merge", "value"):
        raise YamlSubsetError(line, f"{text!r} (a merge key or value key) is outside the subset")
    return text


# --------------------------------------------------------------------------
# reader

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_UNSUPPORTED = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                ">": "block scalars", "%": "directives", "@": "reserved indicators",
                "`": "reserved indicators"}
_WS = " \t"


def _unsupported(line: int, ch: str):
    return YamlSubsetError(line, f"{_UNSUPPORTED[ch]} ({ch!r}) are outside the subset")


def _is_marker(line: str, marker: str) -> bool:
    """``line`` is a document marker (``---`` or ``...``)."""
    return line.startswith(marker) and line[3:4] in ("", " ", "\t")


def _has_content(line: str) -> bool:
    stripped = line.lstrip(_WS)
    return bool(stripped) and stripped[0] != "#"


def _is_comment(line: str, pos: int) -> bool:
    return line[pos] == "#" and (pos == 0 or line[pos - 1] in _WS)


def _plain_end(line: str, pos: int, flow: bool) -> int:
    """Where a plain scalar starting at ``pos`` ends on its line: at a
    comment, at ``": "`` or a ``:`` ending the line (a mapping value), and in
    a flow collection at ``,[]{}`` too."""
    end = pos
    while end < len(line):
        ch = line[end]
        if ch == "#" and line[end - 1] in _WS:
            break
        if ch == ":" and (end + 1 == len(line) or line[end + 1] in _WS
                          or (flow and line[end + 1] in ",[]{}")):
            break
        if flow and ch in ",[]{}":
            break
        end += 1
    return end


class _Reader:
    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        self.lines: List[str] = text.split("\n")
        for n, line in enumerate(self.lines, 1):
            bad = [ch for ch in line if (ord(ch) < 32 and ch != "\t") or ch == "\x7f"
                   or ch in "\x85\u2028\u2029"]
            if bad:
                raise YamlSubsetError(n, f"character {bad[0]!r} is outside the subset")
        self.i = 0   # the current line
        self.indent = 0  # the indentation of the current content line

    # -- lines ---------------------------------------------------------
    def error(self, message: str, line: int = None) -> YamlSubsetError:
        return YamlSubsetError(self.i + 1 if line is None else line, message)

    def next_content(self) -> bool:
        """Move to the next line with content (from the current one), set
        ``indent``; False at the end."""
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if _has_content(line):
                lead = line[: len(line) - len(line.lstrip(_WS))]
                if "\t" in lead:
                    raise self.error("tabs in indentation are outside the subset")
                self.indent = len(lead)
                if _is_marker(line, "..."):  # the end of the document: nothing may follow
                    if any(_has_content(rest) for rest in self.lines[self.i + 1:]):
                        raise self.error("several documents are outside the subset")
                    self.i = len(self.lines)
                    return False
                if _is_marker(line, "---"):
                    raise self.error("document markers (several documents) are outside "
                                     "the subset")
                if self.indent == 0 and line[0] == "%":
                    raise _unsupported(self.i + 1, "%")
                return True
            self.i += 1
        return False

    def is_dash(self, col: int) -> bool:
        line = self.lines[self.i]
        return line[col] == "-" and (col + 1 == len(line) or line[col + 1] in _WS)

    def skip_ws(self, line: str, pos: int) -> int:
        while pos < len(line) and line[pos] in _WS:
            pos += 1
        return pos

    def end_of_line(self, pos: int) -> None:
        """Nothing but a comment may follow a node on its line."""
        line = self.lines[self.i]
        pos = self.skip_ws(line, pos)
        if pos < len(line) and not _is_comment(line, pos):
            if line[pos] == ":":
                raise self.error("mapping values are not allowed here")
            raise self.error(f"unexpected {line[pos:]!r} after a node")
        self.i += 1

    # -- document --------------------------------------------------------
    def document(self) -> Any:
        if not self.next_content():
            return None
        value = self.block_node(-1, self.indent)
        if self.next_content():
            raise self.error("bad indentation or a second root node")
        return value

    def block_node(self, parent: int, col: int) -> Any:
        """The node starting at column ``col`` of the current line, inside a
        block whose indentation is ``parent``."""
        line = self.lines[self.i]
        ch = line[col]
        if self.is_dash(col):
            return self.sequence(col)
        if ch == "?" and (col + 1 == len(line) or line[col + 1] in _WS):
            raise self.error("complex keys ('?') are outside the subset")
        if self.key_at(col) is not None:
            return self.mapping(col)
        return self.inline_value(parent, col)

    def sequence(self, col: int) -> list:
        items = []
        while True:
            line = self.lines[self.i]
            pos = self.skip_ws(line, col + 1)
            if pos == len(line) or _is_comment(line, pos):
                self.i += 1
                if self.next_content() and self.indent > col:
                    items.append(self.block_node(col, self.indent))
                else:
                    items.append(None)
            else:
                items.append(self.block_node(col, pos))
            if not self.next_content() or self.indent < col:
                return items
            if self.indent > col:
                raise self.error("bad indentation of a sequence entry")
            if not self.is_dash(col):
                return items  # the key after a sequence written at its key's indentation

    def key_at(self, col: int):
        """(key, the position after its ``:``) when a mapping key starts at
        ``col``, else None."""
        line = self.lines[self.i]
        ch = line[col]
        if ch in "'\"":
            try:
                key, pos = _scan_quoted(line, col, self.i + 1)
            except YamlSubsetError:
                return None  # a quoted scalar over several lines: not a key
            pos = self.skip_ws(line, pos)
            if pos < len(line) and line[pos] == ":" and (pos + 1 == len(line)
                                                         or line[pos + 1] in _WS):
                return key, pos + 1
            return None
        if ch in "[{#" or ch in _UNSUPPORTED:
            return None
        end = _plain_end(line, col, flow=False)
        if col < end < len(line) and line[end] == ":":
            text = line[col:end].rstrip(_WS)
            return _resolve_plain(text, self.i + 1), end + 1
        return None

    def mapping(self, col: int) -> dict:
        out = {}
        while True:
            found = self.key_at(col)
            if found is None:
                raise self.error("expected a mapping key")
            key, pos = found
            line = self.lines[self.i]
            pos = self.skip_ws(line, pos)
            if pos == len(line) or _is_comment(line, pos):
                self.i += 1
                if self.next_content() and self.indent > col:
                    value = self.block_node(col, self.indent)
                elif self.i < len(self.lines) and self.indent == col and self.is_dash(col):
                    value = self.sequence(col)
                else:
                    value = None
            else:
                value = self.inline_value(col, pos)
            try:
                out[key] = value
            except TypeError:
                raise self.error(f"unhashable key {key!r}") from None
            if not self.next_content() or self.indent < col:
                return out
            if self.indent > col:
                raise self.error("bad indentation of a mapping entry")

    def inline_value(self, parent: int, col: int) -> Any:
        """A scalar or flow collection starting at ``col`` (a block
        collection cannot start here)."""
        line = self.lines[self.i]
        ch = line[col]
        if ch in _UNSUPPORTED:
            raise _unsupported(self.i + 1, ch)
        if ch in "[{":
            value, pos = _flow_node(line, col, self.i + 1)
            self.end_of_line(pos)
            return value
        if ch in "'\"":
            return self.quoted(col)
        nxt = line[col + 1: col + 2]
        if ch == "-" and nxt in ("", " ", "\t"):
            raise self.error("sequence entries are not allowed here")
        if ch in "?:" and nxt in ("", " ", "\t"):
            raise self.error(f"{ch!r} is not allowed here")
        if ch in ",]}":
            raise self.error(f"{ch!r} cannot start a plain scalar")
        return self.plain(parent, col)

    def quoted(self, col: int) -> str:
        first = self.i
        rest = "\n".join([self.lines[first][col:]] + self.lines[first + 1:])
        value, pos = _scan_quoted(rest, 0, first + 1)
        consumed = rest[:pos]
        self.i = first + consumed.count("\n")
        end = pos - (consumed.rfind("\n") + 1) if "\n" in consumed else col + pos
        self.end_of_line(end)
        return value

    def plain(self, parent: int, col: int) -> Any:
        line = self.lines[self.i]
        end = _plain_end(line, col, flow=False)
        if end < len(line) and line[end] == ":":
            raise self.error("mapping values are not allowed here")
        first_line = self.i + 1
        chunks = [line[col:end].rstrip(_WS)]
        self.i += 1
        # continuation lines: more indented than the block, folded with spaces
        # (blank lines between them give line breaks)
        while True:
            blank, j = 0, self.i
            while j < len(self.lines) and not self.lines[j].strip(_WS):
                blank, j = blank + 1, j + 1
            if j == len(self.lines):
                break
            text = self.lines[j]
            body = text.lstrip(_WS)
            lead = text[: len(text) - len(body)]
            if len(lead) <= parent or body[0] == "#" or _is_marker(text, "---") \
                    or _is_marker(text, "..."):
                break
            if "\t" in lead:
                raise self.error("tabs in indentation are outside the subset", j + 1)
            end = _plain_end(text, len(lead), flow=False)
            if end < len(text) and text[end] == ":":
                raise self.error("mapping values are not allowed here", j + 1)
            chunks.append("\n" * blank if blank else " ")
            chunks.append(text[len(lead):end].rstrip(_WS))
            self.i = j + 1
            if end < len(text):  # a comment ends the scalar
                break
        return _resolve_plain("".join(chunks), first_line)


def _scan_quoted(s: str, pos: int, line: int) -> Tuple[str, int]:
    """A single- or double-quoted scalar starting at ``s[pos]`` (its quote):
    (value, the position after the closing quote).  Line breaks fold as in
    PyYAML's ``scan_flow_scalar``."""
    quote = s[pos]
    double = quote == '"'
    pos += 1
    chunks: List[str] = []

    def unterminated():
        return YamlSubsetError(line, "unterminated quoted scalar")

    def breaks(p):
        out = []
        while True:
            if s[p: p + 3] in ("---", "...") and (p == 0 or s[p - 1] == "\n") \
                    and s[p + 3: p + 4] in ("", " ", "\t", "\n"):
                raise YamlSubsetError(line, "a document marker inside a quoted scalar")
            while p < len(s) and s[p] in _WS:
                p += 1
            if p < len(s) and s[p] == "\n":
                out.append("\n")
                p += 1
            else:
                return out, p

    while True:
        while True:  # non-space runs
            start = pos
            while pos < len(s) and s[pos] not in "'\"\\ \t\n":
                pos += 1
            chunks.append(s[start:pos])
            if pos == len(s):
                raise unterminated()
            ch = s[pos]
            if not double and ch == "'" and s[pos + 1: pos + 2] == "'":
                chunks.append("'")
                pos += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                pos += 1
            elif double and ch == "\\":
                pos += 1
                if pos == len(s):
                    raise unterminated()
                esc = s[pos]
                if esc in _ESCAPES:
                    chunks.append(_ESCAPES[esc])
                    pos += 1
                elif esc in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[esc]
                    digits = s[pos + 1: pos + 1 + n]
                    if len(digits) != n or any(c not in "0123456789abcdefABCDEF" for c in digits):
                        raise YamlSubsetError(line, f"bad escape \\{esc}{digits}")
                    chunks.append(chr(int(digits, 16)))
                    pos += 1 + n
                elif esc == "\n":
                    got, pos = breaks(pos + 1)
                    chunks.extend(got)
                else:
                    raise YamlSubsetError(line, f"unknown escape \\{esc}")
            else:
                break
        if s[pos] == quote:
            return "".join(chunks), pos + 1
        start = pos  # spaces, and line breaks
        while pos < len(s) and s[pos] in _WS:
            pos += 1
        if pos == len(s):
            raise unterminated()
        if s[pos] == "\n":
            got, pos = breaks(pos + 1)
            chunks.extend(got if got else [" "])
        else:
            chunks.append(s[start:pos])


def _flow_node(line: str, pos: int, n: int) -> Tuple[Any, int]:
    """A flow node on one line starting at ``pos``: (value, end)."""
    def skip(p):
        while p < len(line) and line[p] in _WS:
            p += 1
        if p == len(line) or line[p] == "#" and line[p - 1] in _WS:
            raise YamlSubsetError(n, "flow collections that span lines are outside the subset")
        return p

    pos = skip(pos)
    ch = line[pos]
    if ch == "[":
        items, pos = [], skip(pos + 1)
        while line[pos] != "]":
            value, pos = _flow_node(line, pos, n)
            pos = skip(pos)
            if line[pos] == ":":
                raise YamlSubsetError(n, "single-pair mappings in a flow sequence are outside "
                                         "the subset")
            items.append(value)
            if line[pos] == ",":
                pos = skip(pos + 1)
            elif line[pos] != "]":
                raise YamlSubsetError(n, f"expected ',' or ']' at {line[pos:]!r}")
        return items, pos + 1
    if ch == "{":
        out, pos = {}, skip(pos + 1)
        while line[pos] != "}":
            if line[pos] in "[{":
                raise YamlSubsetError(n, "collection keys are outside the subset")
            key, pos = _flow_node(line, pos, n)
            pos = skip(pos)
            value = None
            if line[pos] == ":":
                value, pos = _flow_node(line, pos + 1, n)
                pos = skip(pos)
            out[key] = value
            if line[pos] == ",":
                pos = skip(pos + 1)
            elif line[pos] != "}":
                raise YamlSubsetError(n, f"expected ',' or '}}' at {line[pos:]!r}")
        return out, pos + 1
    if ch in "'\"":
        return _scan_quoted(line, pos, n)
    if ch in _UNSUPPORTED:
        raise _unsupported(n, ch)
    if ch in ",]}" or (ch in "-?:" and line[pos + 1: pos + 2] in ("", " ", "\t")):
        raise YamlSubsetError(n, f"{ch!r} cannot start a flow node here")
    end = _plain_end(line, pos, flow=True)
    return _resolve_plain(line[pos:end].rstrip(_WS), n), end


def load(text: str) -> Any:
    """The data of one YAML document in the subset (None when it is empty)."""
    return _Reader(text).document()


# --------------------------------------------------------------------------
# writer

_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _float_text(x: float) -> str:
    if x != x:
        return ".nan"
    if x in (math.inf, -math.inf):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _str_text(s: str) -> str:
    printable = all(" " <= c <= "~" for c in s)
    if (printable and s and s[0] not in _INDICATORS and s == s.strip(" ")
            and ": " not in s and " #" not in s and not s.endswith(":")
            and not s.startswith(("---", "...")) and _resolve_kind(s) == "str"):
        return s
    if printable:
        return "'" + s.replace("'", "''") + "'"
    out = []
    for c in s:
        if c == '"' or c == "\\":
            out.append("\\" + c)
        elif " " <= c <= "~":
            out.append(c)
        elif c in "\n\t\0\r":
            out.append({"\n": "\\n", "\t": "\\t", "\0": "\\0", "\r": "\\r"}[c])
        elif ord(c) <= 0xFF:
            out.append(f"\\x{ord(c):02X}")
        elif ord(c) <= 0xFFFF:
            out.append(f"\\u{ord(c):04X}")
        else:
            out.append(f"\\U{ord(c):08X}")
    return '"' + "".join(out) + '"'


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, str):
        return _str_text(v)
    raise TypeError(f"cannot write {type(v).__name__} {v!r} in the YAML subset")


def _block(value: Any, indent: int, out: List[str]) -> None:
    """Lines of a non-empty mapping or sequence at ``indent``."""
    pad = " " * indent
    if isinstance(value, dict):
        for key in sorted(value):
            v = value[key]
            head = f"{pad}{_scalar_text(key)}:"
            if isinstance(v, dict) and v:
                out.append(head)
                _block(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and v:
                out.append(head)
                _block(v, indent, out)  # a sequence at its key's indentation
            else:
                out.append(f"{head} {_inline(v)}")
        return
    for v in value:
        if isinstance(v, (dict, list, tuple)) and v:
            sub: List[str] = []
            _block(v, indent + 2, sub)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out.extend(sub[1:])
        else:
            out.append(f"{pad}- {_inline(v)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar_text(v)


def dump(data: Any) -> str:
    """``data`` (dicts, lists, tuples, str, int, float, bool, None) as YAML
    text in the subset."""
    if isinstance(data, (dict, list, tuple)) and data:
        out: List[str] = []
        _block(data, 0, out)
        return "\n".join(out) + "\n"
    return _inline(data) + "\n"
