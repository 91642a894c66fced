"""A small self-contained JSON5 parser.

The reference parses project files with the Rust `json5` crate
(settings/src/songs.rs:84-89). Project files in the corpus are mostly plain
JSON, plus a few .json5 files using comments and unquoted keys
(projects/default.json5, projects/dev-loop.json5). This parser implements
the JSON5 features those files (and the spec) need: comments, unquoted
identifier keys, single-quoted strings, trailing commas, hex numbers,
leading '+', Infinity/NaN, and leading/trailing decimal points.

Error messages for empty/garbage input mirror the reference's test
expectations (settings/src/songs.rs:313-335): they contain
"expected array, boolean, null, number, object, or string".
"""

from __future__ import annotations

import math


class Json5Error(ValueError):
    pass


_WS = " \t\n\r ﻿"
_IDENT_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_$")
_IDENT_CONT = _IDENT_START | set("0123456789")
_ESCAPES = {
    '"': '"', "'": "'", "\\": "\\", "/": "/", "b": "\b", "f": "\f",
    "n": "\n", "r": "\r", "t": "\t", "v": "\v", "0": "\0",
}


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    def error(self, msg: str) -> Json5Error:
        line = self.text.count("\n", 0, self.pos) + 1
        col = self.pos - self.text.rfind("\n", 0, self.pos)
        return Json5Error(f"{msg} at line {line} column {col}")

    def skip_ws(self) -> None:
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in _WS:
                self.pos += 1
            elif c == "/" and self.pos + 1 < self.n:
                nxt = self.text[self.pos + 1]
                if nxt == "/":
                    end = self.text.find("\n", self.pos)
                    self.pos = self.n if end < 0 else end + 1
                elif nxt == "*":
                    end = self.text.find("*/", self.pos + 2)
                    if end < 0:
                        raise self.error("unterminated block comment")
                    self.pos = end + 2
                else:
                    return
            else:
                return

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < self.n else ""

    def parse_value(self):
        self.skip_ws()
        c = self.peek()
        if c == "{":
            return self.parse_object()
        if c == "[":
            return self.parse_array()
        if c and c in "\"'":
            # the `c and` guard matters: peek() returns "" at EOF and
            # `"" in "\"'"` is True — parse_string then IndexErrors
            return self.parse_string()
        if c and (c in "+-0123456789." or c in _IDENT_START):
            return self.parse_number_or_word()
        raise self.error("expected array, boolean, null, number, object, or string")

    def parse_object(self) -> dict:
        self.pos += 1  # {
        obj: dict = {}
        while True:
            self.skip_ws()
            if self.peek() == "}":
                self.pos += 1
                return obj
            if not self.peek():
                raise self.error("unterminated object")
            key = self.parse_key()
            self.skip_ws()
            if self.peek() != ":":
                raise self.error(f"expected ':' after key {key!r}")
            self.pos += 1
            obj[key] = self.parse_value()
            self.skip_ws()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() == "}":
                self.pos += 1
                return obj
            else:
                raise self.error("expected ',' or '}' in object")

    def parse_key(self) -> str:
        c = self.peek()
        if c and c in "\"'":  # "" at EOF would match the pair string
            return self.parse_string()
        if c and c in _IDENT_START:
            start = self.pos
            while self.pos < self.n and self.text[self.pos] in _IDENT_CONT:
                self.pos += 1
            return self.text[start:self.pos]
        raise self.error("expected object key")

    def parse_array(self) -> list:
        self.pos += 1  # [
        arr: list = []
        while True:
            self.skip_ws()
            if self.peek() == "]":
                self.pos += 1
                return arr
            if not self.peek():
                raise self.error("unterminated array")
            arr.append(self.parse_value())
            self.skip_ws()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() == "]":
                self.pos += 1
                return arr
            else:
                raise self.error("expected ',' or ']' in array")

    def parse_string(self) -> str:
        quote = self.text[self.pos]
        self.pos += 1
        out: list[str] = []
        while True:
            if self.pos >= self.n:
                raise self.error("unterminated string")
            c = self.text[self.pos]
            if c == quote:
                self.pos += 1
                return "".join(out)
            if c == "\\":
                self.pos += 1
                if self.pos >= self.n:
                    raise self.error("unterminated escape")
                e = self.text[self.pos]
                if e == "u":
                    hexs = self.text[self.pos + 1:self.pos + 5]
                    try:
                        out.append(chr(int(hexs, 16)))
                    except ValueError:
                        raise self.error(f"bad \\u escape {hexs!r}") from None
                    self.pos += 5
                elif e == "x":
                    hexs = self.text[self.pos + 1:self.pos + 3]
                    try:
                        out.append(chr(int(hexs, 16)))
                    except ValueError:
                        raise self.error(f"bad \\x escape {hexs!r}") from None
                    self.pos += 3
                elif e == "\n":
                    self.pos += 1  # line continuation
                elif e == "\r":
                    # JSON5 line continuation: \<CR> and \<CR><LF>
                    self.pos += 1
                    if self.pos < self.n and self.text[self.pos] == "\n":
                        self.pos += 1
                elif e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.pos += 1
                else:
                    out.append(e)
                    self.pos += 1
            elif c == "\n":
                raise self.error("unescaped newline in string")
            else:
                out.append(c)
                self.pos += 1

    def parse_number_or_word(self):
        start = self.pos
        # words: true/false/null/Infinity/NaN (with optional sign)
        for word, val in (
            ("true", True), ("false", False), ("null", None),
            ("Infinity", math.inf), ("NaN", math.nan),
            ("+Infinity", math.inf), ("-Infinity", -math.inf),
            ("+NaN", math.nan), ("-NaN", math.nan),
        ):
            if self.text.startswith(word, self.pos):
                end = self.pos + len(word)
                if end >= self.n or self.text[end] not in _IDENT_CONT:
                    self.pos = end
                    return val
        # number
        i = self.pos
        if self.peek() in "+-":
            i += 1
        if self.text.startswith(("0x", "0X"), i):
            j = i + 2
            while j < self.n and self.text[j] in "0123456789abcdefABCDEF":
                j += 1
            if j == i + 2:
                raise self.error("bad hex literal")
            self.pos = j
            sign = -1 if self.text[start] == "-" else 1
            return sign * int(self.text[i + 2:j], 16)
        j = i
        seen_digit = seen_dot = seen_exp = False
        while j < self.n:
            c = self.text[j]
            if c.isdigit():
                seen_digit = True
            elif c == "." and not seen_dot and not seen_exp:
                seen_dot = True
            elif c in "eE" and seen_digit and not seen_exp:
                seen_exp = True
                if j + 1 < self.n and self.text[j + 1] in "+-":
                    j += 1
            else:
                break
            j += 1
        if not seen_digit:
            raise self.error("expected array, boolean, null, number, object, or string")
        self.pos = j
        raw = self.text[start:j]
        try:
            if seen_dot or seen_exp:
                return float(raw)
            try:
                return int(raw)
            except ValueError:
                return float(raw)
        except ValueError:
            # e.g. '1e+' — report line/column like every other parse error
            self.pos = start
            raise self.error(f"bad number literal {raw!r}") from None


def loads(text: str):
    p = _Parser(text)
    p.skip_ws()
    if p.pos >= p.n:
        raise Json5Error(
            "expected array, boolean, null, number, object, or string at end of input"
        )
    value = p.parse_value()
    p.skip_ws()
    if p.pos < p.n:
        raise p.error("trailing characters after value")
    return value


def load(path) -> object:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read())
