"""Symbolic constraint analysis: degrees + affine lookup lowering.

Replaces two reference mechanisms with one explicit pass:
- p3 `get_max_constraint_degree` / `SymbolicAirBuilder` (used in chip.rs:81-88
  to size the quotient domain), and
- the `LookupBuilder` lookup-extraction trick (lookup/builder.rs:10-107) that
  records send/receive messages as affine `VirtualPairCol`s.

Running a chip's `eval` once over this backend yields: max constraint degree,
and the chip's sends/receives as `Lookup` records with `Affine` value columns.
Non-affine or next-row expressions inside lookup values raise, exactly like
the reference's panic (lookup/builder.rs:109-172).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..stark.field import P
from .lookup import Affine


@dataclass(frozen=True)
class SymExpr:
    degree: int
    # affine form over LOCAL (prep|main) columns: (const, {(is_prep, idx): coeff})
    affine: Optional[Tuple[int, Tuple[Tuple[Tuple[bool, int], int], ...]]]

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def const(c: int) -> "SymExpr":
        return SymExpr(0, (c % P, ()))

    @staticmethod
    def var(is_prep: bool, idx: int, is_next: bool) -> "SymExpr":
        if is_next:
            return SymExpr(1, None)
        return SymExpr(1, (0, (((is_prep, idx), 1),)))

    @staticmethod
    def selector(degree: int = 1) -> "SymExpr":
        """Lagrange selectors: is_first/last_row count as one trace-degree
        multiple; is_transition (x - g^{n-1}) counts as zero (p3
        symbolic_expression.rs degree_multiple semantics)."""
        return SymExpr(degree, None)

    def _lift(self, other):
        if isinstance(other, SymExpr):
            return other
        return SymExpr.const(int(other))

    def __add__(self, other):
        o = self._lift(other)
        return SymExpr(max(self.degree, o.degree), _aff_add(self.affine, o.affine, 1))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._lift(other)
        return SymExpr(max(self.degree, o.degree), _aff_add(self.affine, o.affine, -1))

    def __rsub__(self, other):
        return self._lift(other).__sub__(self)

    def __neg__(self):
        return SymExpr(self.degree, _aff_scale(self.affine, -1))

    def __mul__(self, other):
        o = self._lift(other)
        if self.degree == 0 and self.affine is not None and not self.affine[1]:
            return SymExpr(o.degree, _aff_scale(o.affine, self.affine[0]))
        if o.degree == 0 and o.affine is not None and not o.affine[1]:
            return SymExpr(self.degree, _aff_scale(self.affine, o.affine[0]))
        return SymExpr(self.degree + o.degree, None)

    __rmul__ = __mul__

    def to_affine(self) -> Affine:
        if self.affine is None:
            raise ValueError("expression used in a lookup is not affine over the local row")
        const, terms = self.affine
        return Affine(
            const=const % P,
            terms=tuple((is_prep, idx, w % P) for (is_prep, idx), w in terms if w % P),
        )


def _aff_add(a, b, sign_b: int):
    if a is None or b is None:
        return None
    ca, ta = a
    cb, tb = b
    terms: Dict[Tuple[bool, int], int] = dict(ta)
    for k, w in tb:
        terms[k] = (terms.get(k, 0) + sign_b * w) % P
    return ((ca + sign_b * cb) % P, tuple(sorted(terms.items())))


def _aff_scale(a, s: int):
    if a is None:
        return None
    c, t = a
    s %= P
    return (c * s % P, tuple((k, w * s % P) for k, w in t))
