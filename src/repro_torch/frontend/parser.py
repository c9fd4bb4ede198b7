"""Compact text parser for rule programs (grammar in rules.py docstring).

Tokenizer + recursive-descent expression parser (precedence climbing, all
operators left-associative).  Statements terminate with ``.``; ``#`` starts
a line comment.  ``parse_program`` assembles through :class:`ProgramBuilder`
so text and builder programs normalize (and compare) identically.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

from repro_torch.frontend import expr as E
from repro_torch.frontend.rules import FrontendError, Program, ProgramBuilder

_TOKEN_RE = re.compile(r"""
      (?P<skip>\s+|\#[^\n]*)
    | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
    | (?P<name>[A-Za-z_]\w*)
    | (?P<sym>:-|:=|[().,=+\-*/])
""", re.VERBOSE)


class ParseError(FrontendError):
    pass


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            snippet = text[pos:pos + 20]
            raise ParseError(f"cannot tokenize at: {snippet!r}")
        pos = m.end()
        if m.lastgroup != "skip":
            tokens.append((m.lastgroup, m.group()))
    return tokens


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.tokens = tokens
        self.pos = 0

    # -- token plumbing ---------------------------------------------------
    def peek(self, offset: int = 0) -> Tuple[str, str]:
        i = self.pos + offset
        return self.tokens[i] if i < len(self.tokens) else ("eof", "")

    def next(self) -> Tuple[str, str]:
        tok = self.peek()
        self.pos += 1
        return tok

    def expect(self, kind: str, text: Optional[str] = None) -> str:
        k, t = self.next()
        if k != kind or (text is not None and t != text):
            want = text or kind
            raise ParseError(f"expected {want!r}, got {t!r}")
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> bool:
        k, t = self.peek()
        if k == kind and (text is None or t == text):
            self.pos += 1
            return True
        return False

    # -- expressions ------------------------------------------------------
    def expr(self) -> E.Expr:
        node = self.term()
        while self.peek() in (("sym", "+"), ("sym", "-")):
            op = self.next()[1]
            node = E.BinOp(op, node, self.term())
        return node

    def term(self) -> E.Expr:
        node = self.factor()
        while self.peek() in (("sym", "*"), ("sym", "/")):
            op = self.next()[1]
            node = E.BinOp(op, node, self.factor())
        return node

    def factor(self) -> E.Expr:
        if self.accept("sym", "-"):
            inner = self.factor()
            if isinstance(inner, E.Const):
                return E.Const(-inner.value)
            return E.BinOp("-", E.Const(0.0), inner)
        return self.primary()

    def primary(self) -> E.Expr:
        kind, text = self.peek()
        if kind == "num":
            self.next()
            return E.Const(float(text))
        if kind == "name":
            self.next()
            self.expect("sym", "(")
            var = self.expect("name")
            self.expect("sym", ")")
            return E.Ref(text, var)
        if self.accept("sym", "("):
            node = self.expr()
            self.expect("sym", ")")
            return node
        raise ParseError(f"expected an expression, got {text!r}")

    # -- statements -------------------------------------------------------
    def program(self) -> Program:
        builder = ProgramBuilder()
        while self.peek()[0] != "eof":
            self.statement(builder)
        return builder.build()

    def statement(self, b: ProgramBuilder) -> None:
        kind, text = self.peek()
        if kind != "name":
            raise ParseError(f"expected a statement, got {text!r}")
        if text == "program":
            self.next()
            b._name = self.expect("name")
            self.expect("sym", ".")
            return
        if text == "threshold":
            self.next()
            neg = self.accept("sym", "-")
            val = float(self.expect("num"))
            b.threshold(-val if neg else val)
            self.expect("sym", ".")
            return
        if text == "input":
            self.next()
            name = self.expect("name")
            self.expect("sym", "(")
            fields = [self.expect("name")]
            while self.accept("sym", ","):
                fields.append(self.expect("name"))
            self.expect("sym", ")")
            self.expect("sym", ".")
            b.input(name, *fields)
            return
        self.head_statement(b)

    def head_statement(self, b: ProgramBuilder) -> None:
        rel = self.expect("name")
        self.expect("sym", "(")
        arg_kind, arg = self.next()
        if arg_kind not in ("name", "num"):
            raise ParseError(f"expected a variable or key, got {arg!r}")
        self.expect("sym", ")")

        if self.accept("sym", ":="):
            body = self.expr()
            self.expect("sym", ".")
            if arg_kind == "num":            # ground fact at an integer key
                if not isinstance(body, E.Const):
                    raise ParseError(
                        f"fact {rel}({arg}) needs a constant value")
                if "." in arg or "e" in arg or "E" in arg:
                    raise ParseError(f"fact key must be an integer: {arg!r}")
                b.fact(rel, int(arg), body.value)
            else:                            # all-vertex initializer
                b.init(rel, body, var=arg)
            return

        kind, text = self.peek()
        if kind == "name" and text in ("add", "min", "max") \
                and self.peek(1) == ("sym", "="):
            self.next()                      # aggregator
            self.next()                      # '='
            term = self.expr()
            self.expect("sym", ":-")
            edge = self.expect("name")
            self.expect("sym", "(")
            src = self.expect("name")
            self.expect("sym", ",")
            dst = self.expect("name")
            self.expect("sym", ")")
            self.expect("sym", ".")
            if arg_kind != "name":
                raise ParseError("rule head takes a variable, not a key")
            if dst != arg:
                raise ParseError(
                    f"rule head variable {arg!r} must be the edge "
                    f"destination (got {dst!r})")
            b.rule(rel, text, term, edge=(edge, src, dst), var=dst, src=src)
            return

        if self.accept("sym", "="):          # view
            if arg_kind != "name":
                raise ParseError("view head takes a variable, not a key")
            body = self.expr()
            self.expect("sym", ".")
            b.view(rel, body, var=arg)
            return

        raise ParseError(f"malformed statement for {rel!r}")


def parse_program(text: str) -> Program:
    return _Parser(_tokenize(text)).program()
