"""Minimal libconfig-syntax parser.

The reference uses libconfig++ for its configuration files (reference:
config.cpp, rtl_airband.cpp:780-827).  This is an independent parser for the
same surface syntax so existing RTLSDR-Airband config files load unchanged:

 - settings: ``name = value`` or ``name : value``; ``;``/``,`` terminators optional
 - groups ``{ ... }``, lists ``( ... )``, arrays ``[ ... ]``
 - scalars: int (optional trailing L), float, bool true/false, "strings"
   (adjacent strings concatenate)
 - comments: ``# ...``, ``// ...``, ``/* ... */``
 - ``@include "file"`` directives
"""

from __future__ import annotations

import os
import re

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<float>[-+]?(?:\d+\.\d*|\.\d+)(?:[eE][-+]?\d+)?|[-+]?\d+[eE][-+]?\d+)
  | (?P<hex>0[xX][0-9a-fA-F]+L?)
  | (?P<int>[-+]?\d+L?)
  | (?P<bool>\b(?:true|false|TRUE|FALSE|True|False)\b)
  | (?P<name>[A-Za-z*][A-Za-z0-9_*.-]*)
  | (?P<punct>[{}()\[\]=:;,@])
    """,
    re.VERBOSE | re.DOTALL,
)

_ESCAPES = {"\\n": "\n", "\\t": "\t", "\\r": "\r", '\\"': '"', "\\\\": "\\"}


class ConfigError(ValueError):
    pass


def _tokenize(text: str):
    pos = 0
    line = 1
    out = []
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ConfigError(f"config syntax error at line {line}: {text[pos:pos+40]!r}")
        line += text[pos : m.end()].count("\n")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append((kind, m.group(), line))
    out.append(("eof", "", line))
    return out


class _Parser:
    def __init__(self, tokens, basedir="."):
        self.toks = tokens
        self.i = 0
        self.basedir = basedir

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value):
        kind, val, line = self.next()
        if val != value:
            raise ConfigError(f"line {line}: expected {value!r}, got {val!r}")

    def parse_document(self) -> dict:
        out = {}
        while self.peek()[0] != "eof":
            if self.peek()[1] == "@":
                self._include(out)
                continue
            name, value = self.parse_setting()
            out[name] = value
        return out

    def _include(self, out: dict):
        self.expect("@")
        kind, val, line = self.next()
        if val != "include":
            raise ConfigError(f"line {line}: expected include after @")
        kind, val, line = self.next()
        if kind != "string":
            raise ConfigError(f"line {line}: expected string after @include")
        path = _string_value(val)
        if not os.path.isabs(path):
            path = os.path.join(self.basedir, path)
        out.update(load(path))

    def parse_setting(self):
        kind, name, line = self.next()
        if kind != "name":
            raise ConfigError(f"line {line}: expected setting name, got {name!r}")
        kind, sep, line = self.next()
        if sep not in ("=", ":"):
            raise ConfigError(f"line {line}: expected '=' or ':' after {name!r}")
        value = self.parse_value()
        while self.peek()[1] in (";", ","):
            self.next()
        return name, value

    def parse_value(self):
        kind, val, line = self.peek()
        if val == "{":
            return self.parse_group()
        if val == "(":
            return self.parse_list()
        if val == "[":
            return self.parse_array()
        self.next()
        if kind == "string":
            s = _string_value(val)
            while self.peek()[0] == "string":  # adjacent string concat
                s += _string_value(self.next()[1])
            return s
        if kind == "float":
            return float(val)
        if kind in ("int", "hex"):
            return int(val.rstrip("Ll"), 0)
        if kind == "bool":
            return val.lower() == "true"
        raise ConfigError(f"line {line}: unexpected token {val!r}")

    def parse_group(self) -> dict:
        self.expect("{")
        out = {}
        while self.peek()[1] != "}":
            name, value = self.parse_setting()
            out[name] = value
        self.expect("}")
        return out

    def parse_list(self) -> list:
        self.expect("(")
        out = []
        while self.peek()[1] != ")":
            out.append(self.parse_value())
            while self.peek()[1] in (";", ","):
                self.next()
        self.expect(")")
        return out

    def parse_array(self) -> list:
        self.expect("[")
        out = []
        while self.peek()[1] != "]":
            out.append(self.parse_value())
            while self.peek()[1] in (";", ","):
                self.next()
        self.expect("]")
        return out


def _string_value(tok: str) -> str:
    s = tok[1:-1]
    for k, v in _ESCAPES.items():
        s = s.replace(k, v)
    return s


def loads(text: str, basedir: str = ".") -> dict:
    return _Parser(_tokenize(text), basedir).parse_document()


def load(path: str) -> dict:
    with open(path) as f:
        return loads(f.read(), basedir=os.path.dirname(os.path.abspath(path)))
