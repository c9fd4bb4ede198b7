"""Scalar expression DSL for rule terms (frontend layer).

An :class:`Expr` is a tiny arithmetic AST over relation references
(``rank(u)``), builtin vertex attributes (``deg(u)``, ``id(u)``) and float
constants, with ``+ - * /``.  The same AST serves three masters:

  * the **builder API** (operator overloading: ``0.15 + 0.85 * ref("acc")``),
  * the **text grammar** (rendering via :func:`to_text` round-trips exactly
    through ``frontend.parser``),
  * the **lowering** (:func:`evaluate` maps it over torch tensors per
    shard — python-float constants take the tensor's float32, so the
    emitted arithmetic is token-identical to the hand-written algorithms).

For ``add``-combiner rules the emission rewrite substitutes the recursive
reference with the *retained delta* (cur − sent); that rewrite is only sound
when the term is homogeneous-linear in the recursive relation —
:func:`degree_in` checks this structurally (degree 0, 1, or None=nonlinear).
"""
from __future__ import annotations

import dataclasses
import operator as _operator
from typing import Callable, Mapping, Optional, Set

import torch

#: builtin per-vertex attributes usable in terms: out-degree (clamped ≥1,
#: as the handwritten algorithms do) and the global vertex id.
BUILTINS = ("deg", "id")


def _truediv(a, b):
    """``a / b``, a true division also for a number over a tensor (which
    ``Tensor.__rtruediv__`` computes as a product with a reciprocal)."""
    if torch.is_tensor(b) and not torch.is_tensor(a):
        a = torch.full_like(b, a)
    return a / b


_OPS: Mapping[str, Callable] = {"+": _operator.add, "-": _operator.sub,
                                "*": _operator.mul, "/": _truediv}
_PREC = {"+": 1, "-": 1, "*": 2, "/": 2}


class Expr:
    """Base expression; subclasses are frozen dataclasses (structural ==)."""

    def __add__(self, o): return BinOp("+", self, wrap(o))

    def __radd__(self, o): return BinOp("+", wrap(o), self)

    def __sub__(self, o): return BinOp("-", self, wrap(o))

    def __rsub__(self, o): return BinOp("-", wrap(o), self)

    def __mul__(self, o): return BinOp("*", self, wrap(o))

    def __rmul__(self, o): return BinOp("*", wrap(o), self)

    def __truediv__(self, o): return BinOp("/", self, wrap(o))

    def __rtruediv__(self, o): return BinOp("/", wrap(o), self)

    def __neg__(self):
        if isinstance(self, Const):
            return Const(-self.value)
        return BinOp("-", Const(0.0), self)


def wrap(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, float)):
        return Const(float(x))
    raise TypeError(f"cannot use {type(x).__name__} in a rule expression")


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float


@dataclasses.dataclass(frozen=True)
class Ref(Expr):
    """Reference to relation ``rel`` at variable ``var`` (``rank(u)``).

    ``var=None`` means "the context variable" — the builder normalizes it
    to the enclosing rule's source / view's head variable at build()."""

    rel: str
    var: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str     # + - * /
    lhs: Expr
    rhs: Expr


def ref(rel: str, var: Optional[str] = None) -> Ref:
    return Ref(rel, var)


def deg(var: Optional[str] = None) -> Ref:
    return Ref("deg", var)


def vid(var: Optional[str] = None) -> Ref:
    """The global vertex id builtin (text form ``id(v)``)."""
    return Ref("id", var)


# ---------------------------------------------------------------------------
# Structural tools.
# ---------------------------------------------------------------------------

def refs(expr: Expr) -> Set[Ref]:
    if isinstance(expr, Ref):
        return {expr}
    if isinstance(expr, BinOp):
        return refs(expr.lhs) | refs(expr.rhs)
    return set()


def transform(expr: Expr, fn: Callable[[Ref], Expr]) -> Expr:
    """Rebuild ``expr`` with every Ref replaced by ``fn(ref)``."""
    if isinstance(expr, Ref):
        return fn(expr)
    if isinstance(expr, BinOp):
        return BinOp(expr.op, transform(expr.lhs, fn),
                     transform(expr.rhs, fn))
    return expr


def degree_in(expr: Expr, rels: Set[str]) -> Optional[int]:
    """Polynomial degree of ``expr`` in references to ``rels``: 0 (does not
    depend), 1 (homogeneous linear), or None (nonlinear / non-homogeneous
    affine — ``T(a) − T(b) ≠ T(a − b)``, so the delta rewrite is unsound)."""
    if isinstance(expr, Const):
        return 0
    if isinstance(expr, Ref):
        return 1 if expr.rel in rels else 0
    if isinstance(expr, BinOp):
        dl = degree_in(expr.lhs, rels)
        dr = degree_in(expr.rhs, rels)
        if dl is None or dr is None:
            return None
        if expr.op in ("+", "-"):
            return dl if dl == dr else None
        if expr.op == "*":
            d = dl + dr
            return d if d <= 1 else None
        if expr.op == "/":
            return dl if dr == 0 else None
    return None


def is_linear_in(expr: Expr, rels: Set[str]) -> bool:
    return degree_in(expr, rels) == 1


# ---------------------------------------------------------------------------
# Evaluation (tensors or floats — plain python arithmetic).
# ---------------------------------------------------------------------------

def evaluate(expr: Expr, env: Mapping[str, object]):
    """Evaluate with relation/builtin names bound to arrays (or floats).

    Constants stay python floats, which a float32 tensor takes in its own
    dtype, so the arithmetic matches the handwritten algorithms
    bit-for-bit."""
    if isinstance(expr, Const):
        return expr.value
    if isinstance(expr, Ref):
        try:
            return env[expr.rel]
        except KeyError:
            raise KeyError(f"no binding for relation {expr.rel!r} "
                           f"(have: {sorted(env)})") from None
    if isinstance(expr, BinOp):
        return _OPS[expr.op](evaluate(expr.lhs, env), evaluate(expr.rhs, env))
    raise TypeError(f"not an expression: {expr!r}")


# ---------------------------------------------------------------------------
# Rendering (exact round-trip through frontend.parser).
# ---------------------------------------------------------------------------

def to_text(expr: Expr) -> str:
    if isinstance(expr, Const):
        return repr(expr.value)
    if isinstance(expr, Ref):
        return f"{expr.rel}({expr.var or '_'})"
    if isinstance(expr, BinOp):
        p = _PREC[expr.op]
        lhs = to_text(expr.lhs)
        rhs = to_text(expr.rhs)
        if isinstance(expr.lhs, BinOp) and _PREC[expr.lhs.op] < p:
            lhs = f"({lhs})"
        # All operators parse left-associative: parenthesize a right child of
        # equal precedence so the tree (not just the value) round-trips.
        if isinstance(expr.rhs, BinOp) and _PREC[expr.rhs.op] <= p:
            rhs = f"({rhs})"
        return f"{lhs} {expr.op} {rhs}"
    raise TypeError(f"not an expression: {expr!r}")
