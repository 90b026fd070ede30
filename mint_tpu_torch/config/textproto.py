"""Minimal proto2 text-format parser.

The port's own copy of ``mint_tpu/config/textproto.py`` (the port imports
nothing of the JAX package); keep the two in step.

The reference framework configures everything through proto2 text configs
(see reference ``mint/utils/config_util.py:22-50`` and the shipped
``configs/fact_v5_deeper_t10_cm12.config``).  mint_tpu keeps drop-in
compatibility with those config files without depending on protobuf: this
module parses the text-format grammar subset those configs use into plain
nested Python structures, which :mod:`mint_tpu_torch.config.schema` then
maps onto typed dataclasses.

Supported grammar:

- ``key: value`` scalar fields (int, float, bool, string, enum identifier)
- ``key { ... }`` and ``key: { ... }`` message fields
- repeated fields (same key appearing multiple times -> list)
- ``#`` comments, arbitrary whitespace/newlines

Parsed messages are represented as :class:`Msg`, a dict-like container that
keeps every occurrence of a field in order.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, List, Tuple


class Msg:
    """An ordered multi-map representing one text-proto message."""

    def __init__(self) -> None:
        self._fields: List[Tuple[str, Any]] = []

    def add(self, key: str, value: Any) -> None:
        self._fields.append((key, value))

    def get(self, key: str, default: Any = None) -> Any:
        """First occurrence of `key`, or `default`."""
        for k, v in self._fields:
            if k == key:
                return v
        return default

    def get_all(self, key: str) -> List[Any]:
        """Every occurrence of `key`, in file order."""
        return [v for k, v in self._fields if k == key]

    def keys(self) -> List[str]:
        return [k for k, _ in self._fields]

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._fields)

    def __contains__(self, key: str) -> bool:
        return any(k == key for k, _ in self._fields)

    def __repr__(self) -> str:
        return f"Msg({self._fields!r})"

    def replace(self, key: str, value: Any) -> None:
        """Overwrite the first occurrence of `key` (or append)."""
        for i, (k, _) in enumerate(self._fields):
            if k == key:
                self._fields[i] = (key, value)
                return
        self._fields.append((key, value))

    def remove(self, key: str) -> None:
        """Remove every occurrence of `key` (oneof-sibling clearing)."""
        self._fields = [(k, v) for k, v in self._fields if k != key]

    def to_dict(self) -> Any:
        out: dict = {}
        for k, v in self._fields:
            v = v.to_dict() if isinstance(v, Msg) else v
            if k in out:
                if not isinstance(out[k], list):
                    out[k] = [out[k]]
                out[k].append(v)
            else:
                out[k] = v
        return out


_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<punct>[{}:])
  | (?P<atom>[^\s{}:"']+)
  | (?P<ws>\s+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[str]:
    tokens: List[str] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"textproto: cannot tokenize at offset {pos}: "
                             f"{text[pos:pos + 40]!r}")
        pos = m.end()
        if m.lastgroup in ("comment", "ws"):
            continue
        tokens.append(m.group())
    return tokens


_BOOL = {"true": True, "false": False, "True": True, "False": False}
_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(
    r"^[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?[fF]?$")


def _parse_scalar(tok: str) -> Any:
    if tok and tok[0] in "\"'":
        return tok[1:-1].encode("raw_unicode_escape").decode("unicode_escape")
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT_RE.match(tok):
        return int(tok)
    if _FLOAT_RE.match(tok):
        return float(tok.rstrip("fF"))
    # Enum identifier (e.g. SEQUENCE_WISE) — keep as string.
    return tok


class _Parser:
    def __init__(self, tokens: List[str]) -> None:
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> str | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise ValueError("textproto: unexpected end of input")
        self.pos += 1
        return tok

    def parse_message(self, top_level: bool = False) -> Msg:
        msg = Msg()
        while True:
            tok = self.peek()
            if tok is None:
                if not top_level:
                    raise ValueError("textproto: missing closing '}'")
                return msg
            if tok == "}":
                if top_level:
                    raise ValueError("textproto: unbalanced '}'")
                self.next()
                return msg
            key = self.next()
            sep = self.peek()
            if sep == ":":
                self.next()
                nxt = self.peek()
                if nxt == "{":
                    self.next()
                    msg.add(key, self.parse_message())
                else:
                    msg.add(key, _parse_scalar(self.next()))
            elif sep == "{":
                self.next()
                msg.add(key, self.parse_message())
            else:
                raise ValueError(
                    f"textproto: expected ':' or '{{' after {key!r}, "
                    f"got {sep!r}")


def parse(text: str) -> Msg:
    """Parse proto2 text format into a :class:`Msg` tree."""
    return _Parser(_tokenize(text)).parse_message(top_level=True)


def parse_file(path: str) -> Msg:
    with open(path, "r") as f:
        return parse(f.read())


def _format_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        # HEURISTIC: a Msg tree carries no field types, so ALL_CAPS
        # strings are assumed to be enum identifiers and left unquoted.
        # A genuine string VALUE matching ^[A-Z][A-Z0-9_]*$ would also
        # be emitted bare — schema-aware serialization (the JAX package's
        # mint_tpu/config/serialize.py, not copied into the port) uses its
        # _ENUM_FIELDS registry instead and is the product path for config
        # snapshots; dumps()
        # here is for Msg-level debugging/round-trips only.
        if re.match(r"^[A-Z][A-Z0-9_]*$", v):
            return v
        return '"%s"' % v.replace("\\", "\\\\").replace('"', '\\"')
    if isinstance(v, float):
        return repr(v)
    return str(v)


def dumps(msg: Msg, indent: int = 0) -> str:
    """Serialize a Msg tree back to text-proto (for pipeline.config saving)."""
    pad = "  " * indent
    lines = []
    for k, v in msg.items():
        if isinstance(v, Msg):
            lines.append(f"{pad}{k} {{")
            lines.append(dumps(v, indent + 1))
            lines.append(f"{pad}}}")
        else:
            lines.append(f"{pad}{k}: {_format_scalar(v)}")
    return "\n".join(line for line in lines if line != "")
