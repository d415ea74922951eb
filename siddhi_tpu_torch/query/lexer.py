"""Tokenizer for the SiddhiQL-compatible language.

Replaces the reference's ANTLR-generated lexer
(reference: modules/siddhi-query-compiler/src/main/antlr4/.../SiddhiQL.g4,
lexer rules near the bottom of the 918-line grammar).  Hand-rolled so the
framework has zero parser-generator dependencies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional


class TokenType:
    IDENT = "IDENT"
    INT = "INT"          # 123
    LONG = "LONG"        # 123L / 123l
    FLOAT = "FLOAT"      # 1.2f
    DOUBLE = "DOUBLE"    # 1.2
    STRING = "STRING"
    OP = "OP"            # punctuation / operators
    EOF = "EOF"


@dataclass
class Token:
    type: str
    value: str
    pos: int
    line: int
    col: int

    def lower(self) -> str:
        return self.value.lower()


class LexError(Exception):
    pass


_TWO_CHAR_OPS = {"==", "!=", "<=", ">=", "->"}
_ONE_CHAR_OPS = set("()[]{}<>,.;:*/+-%=!@#?")


def tokenize(text: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(text)
    line, line_start = 1, 0

    def make(tt: str, val: str, start: int) -> Token:
        return Token(tt, val, start, line, start - line_start + 1)

    while i < n:
        c = text[i]
        # whitespace
        if c in " \t\r\n":
            if c == "\n":
                line += 1
                line_start = i + 1
            i += 1
            continue
        # comments: -- line, /* block */
        if c == "-" and i + 1 < n and text[i + 1] == "-":
            j = text.find("\n", i)
            i = n if j < 0 else j
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated block comment at line {line}")
            line += text.count("\n", i, j)
            i = j + 2
            continue
        # strings: '...' , "..." , """...""" (no escapes in SiddhiQL; '' not special)
        if c in "'\"":
            if c == '"' and text.startswith('"""', i):
                j = text.find('"""', i + 3)
                if j < 0:
                    raise LexError(f"unterminated triple-quoted string at line {line}")
                val = text[i + 3:j]
                toks.append(make(TokenType.STRING, val, i))
                line += text.count("\n", i, j)
                i = j + 3
                continue
            j = text.find(c, i + 1)
            if j < 0:
                raise LexError(f"unterminated string at line {line}")
            toks.append(make(TokenType.STRING, text[i + 1:j], i))
            line += text.count("\n", i, j)
            i = j + 1
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            is_float = False
            while j < n and (text[j].isdigit() or text[j] == "."):
                if text[j] == ".":
                    # ".." or ".ident" -> stop (attribute access like e1[0].p can't
                    # start with digit, but `1.0` is fine)
                    if j + 1 < n and not text[j + 1].isdigit():
                        break
                    is_float = True
                j += 1
            raw = text[i:j]
            if j < n and text[j] in "eE" and (j + 1 < n and (text[j + 1].isdigit() or text[j + 1] in "+-")):
                k = j + 2 if text[j + 1] in "+-" else j + 1
                while k < n and text[k].isdigit():
                    k += 1
                raw = text[i:k]
                j = k
                is_float = True
            if j < n and text[j] in "fF":
                toks.append(make(TokenType.FLOAT, raw, i))
                j += 1
            elif j < n and text[j] in "dD":
                toks.append(make(TokenType.DOUBLE, raw, i))
                j += 1
            elif j < n and text[j] in "lL":
                toks.append(make(TokenType.LONG, raw, i))
                j += 1
            elif is_float:
                toks.append(make(TokenType.DOUBLE, raw, i))
            else:
                toks.append(make(TokenType.INT, raw, i))
            i = j
            continue
        # identifiers / keywords (incl. `back-quoted`? SiddhiQL uses plain)
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            toks.append(make(TokenType.IDENT, text[i:j], i))
            i = j
            continue
        # operators
        if text[i:i + 2] in _TWO_CHAR_OPS:
            toks.append(make(TokenType.OP, text[i:i + 2], i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            toks.append(make(TokenType.OP, c, i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at line {line}")

    toks.append(Token(TokenType.EOF, "", n, line, 1))
    return toks
