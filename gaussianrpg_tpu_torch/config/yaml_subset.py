"""A reader for the subset of YAML that the configuration files use, so the
port needs no PyYAML.

`safe_load(text)` accepts what `configs/*.yaml` and the `KEY VALUE` command
line overrides use: block mappings nested by indentation, `#` comments on
their own lines and after a value, plain, single- and double-quoted
scalars, and flow lists (`[10, 160]`, `[]`, nested). Plain scalars resolve
as PyYAML's `safe_load` resolves them (YAML 1.1): `yes`/`no`/`on`/`off`
and `true`/`false` in three casings are bools, `~`/`null`/empty are None,
`0x..`/`0..`/`0b..`/`1:30` are ints in base 16, 8, 2 and 60, a float needs
a dot and a signed exponent (`1.0e-3` is a float, `1e-3` stays a string).
Anything else (block sequences, flow mappings, anchors, aliases, tags,
block scalars, document markers, dates, multi-line values, tabs) raises
`YamlSubsetError`.
"""
from __future__ import annotations

import math
import re

__all__ = ["YamlSubsetError", "safe_load", "resolve_scalar"]


class YamlSubsetError(ValueError):
    pass


_BOOL = {v: v.lower() in ("yes", "true", "on") for w in
         ("yes", "no", "true", "false", "on", "off")
         for v in (w, w.capitalize(), w.upper())}
_NULL = {"~", "null", "Null", "NULL", ""}
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
_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_scalar(text: str):
    """The value of a plain (unquoted) scalar, by PyYAML's implicit
    resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _DATE.match(text):
        raise YamlSubsetError(f"dates are not supported: {text!r}")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def _quoted(s: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at s[i]; returns (value, index after the
    closing quote)."""
    q = s[i]
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == q:
            if q == "'" and s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if c == "\\" and q == '"':
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX:
                n = _HEX[e]
                out.append(chr(int(s[i + 2:i + 2 + n], 16)))
                i += 2 + n
            else:
                raise YamlSubsetError(f"unsupported escape in {s!r}")
            continue
        out.append(c)
        i += 1
    raise YamlSubsetError(f"unterminated quoted scalar (multi-line values "
                          f"are not supported): {s!r}")


def _strip_comment(line: str) -> str:
    """The line without its comment: a `#` at the start or after
    whitespace, outside quotes."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            _, i = _quoted(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _check_plain(text: str, ctx: str) -> None:
    if not text:
        return
    if text[0] in _INDICATORS and not (
            text[0] in "-?:" and len(text) > 1 and text[1] not in " \t"):
        raise YamlSubsetError(f"unsupported YAML syntax in {ctx}: {text!r}")
    if ": " in text or text.endswith(":") or " #" in text:
        raise YamlSubsetError(f"unsupported YAML syntax in {ctx}: {text!r}")


def _flow_list(s: str, i: int, ctx: str) -> tuple[list, int]:
    """The flow sequence starting at s[i] == '['."""
    out = []
    i += 1
    while True:
        while i < len(s) and s[i] in " \t":
            i += 1
        if i >= len(s):
            raise YamlSubsetError(f"unterminated flow list (multi-line "
                                  f"values are not supported) in {ctx}")
        if s[i] == "]":
            return out, i + 1
        if s[i] == "[":
            item, i = _flow_list(s, i, ctx)
        elif s[i] in "'\"":
            item, i = _quoted(s, i)
        else:
            j = i
            while j < len(s) and s[j] not in ",]":
                if s[j] in "[{":
                    raise YamlSubsetError(f"unsupported flow syntax in {ctx}")
                j += 1
            text = s[i:j].strip()
            if not text:
                raise YamlSubsetError(f"empty flow list entry in {ctx}")
            _check_plain(text, ctx)
            item, i = resolve_scalar(text), j
        out.append(item)
        while i < len(s) and s[i] in " \t":
            i += 1
        if i < len(s) and s[i] == ",":
            i += 1
        elif i < len(s) and s[i] != "]":
            raise YamlSubsetError(f"bad flow list in {ctx}")


def _value(text: str, ctx: str):
    """A scalar or flow list written on one line."""
    if not text:
        return None
    if text[0] == "[":
        val, end = _flow_list(text, 0, ctx)
    elif text[0] in "'\"":
        val, end = _quoted(text, 0)
    else:
        _check_plain(text, ctx)
        return resolve_scalar(text)
    if text[end:].strip():
        raise YamlSubsetError(f"trailing text after a value in {ctx}: "
                              f"{text!r}")
    return val


def _split_key(content: str):
    """(key, rest) when the line is a mapping entry, else None."""
    if content[0] in "'\"":
        key, i = _quoted(content, 0)
        rest = content[i:].lstrip(" \t")
        if not rest.startswith(":"):
            return None
        return key, rest[1:]
    for i, c in enumerate(content):
        if c == ":" and (i + 1 == len(content) or content[i + 1] in " \t"):
            key = content[:i].rstrip()
            _check_plain(key, "a key")
            return resolve_scalar(key), content[i + 1:]
        if c in "[{" and i == 0:
            return None
    return None


def safe_load(text: str):
    """The document in `text`: a block mapping, a scalar or a flow list."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YamlSubsetError(f"line {n}: tabs are not supported")
        content = _strip_comment(body)
        if not content:
            continue
        if content.startswith(("---", "...", "%")) or content in ("-",) \
                or content.startswith("- "):
            raise YamlSubsetError(
                f"line {n}: unsupported YAML syntax {content!r}")
        lines.append((len(raw) - len(body), content, n))
    if not lines:
        return None
    if _split_key(lines[0][1]) is None:
        if len(lines) > 1:
            raise YamlSubsetError("multi-line scalars are not supported")
        return _value(lines[0][1], f"line {lines[0][2]}")
    out, pos = _mapping(lines, 0, lines[0][0])
    if pos != len(lines):
        raise YamlSubsetError(f"line {lines[pos][2]}: bad indentation")
    return out


def _mapping(lines, pos, indent) -> tuple[dict, int]:
    out = {}
    while pos < len(lines):
        ind, content, n = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise YamlSubsetError(f"line {n}: bad indentation")
        kv = _split_key(content)
        if kv is None:
            raise YamlSubsetError(f"line {n}: expected 'key: value', got "
                                  f"{content!r}")
        key, rest = kv
        rest = rest.strip()
        pos += 1
        if rest:
            out[key] = _value(rest, f"line {n}")
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _mapping(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos
