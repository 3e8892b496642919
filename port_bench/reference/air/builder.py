"""AIR builders (reference crates/stark/src/air/builder.rs, folder.rs), a
frozen copy of the port's host ones: a chip's constraint code runs
unchanged over `SymbolicBuilder` (degree analysis and lookup extraction,
chip.rs:81-88) and `NumericBuilder` over `HostEFBackend` (exact EF4
evaluation at the out-of-domain point, folder.rs:125-358).
"""

from __future__ import annotations

from typing import Callable, List

from ..stark import ef_host as efh
from ..stark.field import P
from .lookup import Lookup, LookupKind
from .symbolic import SymExpr


# ---------------------------------------------------------------------------
# Value wrapper
# ---------------------------------------------------------------------------


class V:
    """Field value in some backend; `ext` marks EF4 payloads."""

    __slots__ = ("b", "p", "ext")

    def __init__(self, b, p, ext=False):
        self.b = b
        self.p = p
        self.ext = ext

    def _lift(self, other) -> "V":
        if isinstance(other, V):
            return other
        return V(self.b, self.b.const(int(other) % P), False)

    def _bin(self, other, base_op, ext_op, ext_base_op, reflected=False):
        o = self._lift(other)
        a, c = (o, self) if reflected else (self, o)
        if not a.ext and not c.ext:
            return V(self.b, base_op(a.p, c.p), False)
        if a.ext and c.ext:
            return V(self.b, ext_op(a.p, c.p), True)
        if a.ext:
            return V(self.b, ext_base_op(a.p, c.p), True)
        return V(self.b, ext_base_op(c.p, a.p), True)  # commutative ops only

    def __add__(self, other):
        return self._bin(other, self.b.add, self.b.eadd, self.b.eadd_base)

    __radd__ = __add__

    def __mul__(self, other):
        return self._bin(other, self.b.mul, self.b.emul, self.b.emul_base)

    __rmul__ = __mul__

    def __sub__(self, other):
        o = self._lift(other)
        return self.__add__(o.__neg__())

    def __rsub__(self, other):
        return self._lift(other).__sub__(self)

    def __neg__(self):
        if self.ext:
            return V(self.b, self.b.eneg(self.p), True)
        return V(self.b, self.b.neg(self.p), False)

    def as_ext(self) -> "V":
        if self.ext:
            return self
        return V(self.b, self.b.lift(self.p), True)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class HostEFBackend:
    """Exact host scalars; every payload is an EF4 tuple (verifier folder)."""

    @staticmethod
    def const(c):
        return efh.from_base(c)

    add = staticmethod(efh.add)
    sub = staticmethod(efh.sub)
    mul = staticmethod(efh.mul)
    neg = staticmethod(efh.neg)
    eadd = staticmethod(efh.add)
    emul = staticmethod(efh.mul)
    eneg = staticmethod(efh.neg)
    eadd_base = staticmethod(efh.add)
    emul_base = staticmethod(efh.mul)

    @staticmethod
    def lift(b):
        return b


class SymBackend:
    @staticmethod
    def const(c):
        return SymExpr.const(c)

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def mul(a, b):
        return a * b

    @staticmethod
    def neg(a):
        return -a

    eadd = add
    emul = mul
    eneg = neg
    eadd_base = add
    emul_base = mul

    @staticmethod
    def lift(b):
        return b


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


class _BuilderBase:
    """Shared sugar: when-filters, assert helpers, send/receive plumbing."""

    backend = None

    # subclasses set: is_first_row / is_last_row / is_transition (V)

    def assert_zero(self, x):
        raise NotImplementedError

    def assert_eq(self, a, b):
        a = a if isinstance(a, V) else self._const(a)
        self.assert_zero(a - b)

    def assert_one(self, a):
        self.assert_zero(a - 1)

    def assert_bool(self, a):
        self.assert_zero(a * (a - 1))

    def assert_zero_ext(self, x):
        self.assert_zero(x)

    def assert_eq_ext(self, a, b):
        self.assert_zero(a - b)

    def _const(self, c):
        return V(self.backend, self.backend.const(int(c) % P), False)

    def if_else(self, cond, a, b):
        return cond * a + (self._const(1) - cond) * b

    def when(self, condition) -> "FilteredBuilder":
        return FilteredBuilder(self, condition)

    def when_not(self, condition) -> "FilteredBuilder":
        return FilteredBuilder(self, self._const(1) - condition)

    def when_first_row(self):
        return FilteredBuilder(self, self.is_first_row)

    def when_last_row(self):
        return FilteredBuilder(self, self.is_last_row)

    def when_transition(self):
        return FilteredBuilder(self, self.is_transition)

    # message plumbing (overridden by SymbolicBuilder; no-op in numeric folds,
    # mirroring EmptyMessageBuilder in the reference)
    def send(self, kind: LookupKind, values, multiplicity):
        pass

    def receive(self, kind: LookupKind, values, multiplicity):
        pass


class FilteredBuilder(_BuilderBase):
    """Constraints multiplied by a condition; messages pass through unfiltered
    (matching FilteredAirBuilder's MessageBuilder impl, air/builder.rs:266)."""

    def __init__(self, parent, condition):
        self.parent = parent
        self.condition = condition
        self.backend = parent.backend

    @property
    def is_first_row(self):
        return self.parent.is_first_row

    @property
    def is_last_row(self):
        return self.parent.is_last_row

    @property
    def is_transition(self):
        return self.parent.is_transition

    def assert_zero(self, x):
        self.parent.assert_zero(self.condition * x)

    def when(self, condition):
        return FilteredBuilder(self.parent, self.condition * condition)

    def when_not(self, condition):
        return FilteredBuilder(self.parent, self.condition * (self._const(1) - condition))

    def send(self, kind, values, multiplicity):
        self.parent.send(kind, values, multiplicity)

    def receive(self, kind, values, multiplicity):
        self.parent.receive(kind, values, multiplicity)


class SymbolicBuilder(_BuilderBase):
    """Collects constraint degrees and affine send/receive messages."""

    backend = SymBackend

    def __init__(self, prep_width: int, main_width: int):
        def mk(is_prep, is_next):
            def get(i):
                return V(SymBackend, SymExpr.var(is_prep, i, is_next))

            return get

        self.get_prep_local = mk(True, False)
        self.get_prep_next = mk(True, True)
        self.get_main_local = mk(False, False)
        self.get_main_next = mk(False, True)
        self.is_first_row = V(SymBackend, SymExpr.selector(1))
        self.is_last_row = V(SymBackend, SymExpr.selector(1))
        self.is_transition = V(SymBackend, SymExpr.selector(0))
        self.max_degree = 0
        self.sends: List[Lookup] = []
        self.receives: List[Lookup] = []
        self.uses_next_row = False

    def assert_zero(self, x):
        if isinstance(x, V):
            self.max_degree = max(self.max_degree, x.p.degree)

    def _lower(self, kind, values, multiplicity) -> Lookup:
        vals = tuple(
            (v if isinstance(v, V) else self._const(v)).p.to_affine() for v in values
        )
        mult = (
            multiplicity if isinstance(multiplicity, V) else self._const(multiplicity)
        ).p.to_affine()
        return Lookup(values=vals, multiplicity=mult, kind=kind)

    def send(self, kind, values, multiplicity):
        self.sends.append(self._lower(kind, values, multiplicity))

    def receive(self, kind, values, multiplicity):
        self.receives.append(self._lower(kind, values, multiplicity))


class NumericBuilder(_BuilderBase):
    """Evaluates constraints with a numeric backend.

    on_constraint(payload, ext) is invoked per constraint in emission order -
    the folding discipline (Horner by alpha) or the all-rows zero check hang
    off this hook.
    """

    def __init__(
        self,
        backend,
        main_local,
        main_next,
        prep_local,
        prep_next,
        is_first_row,
        is_last_row,
        is_transition,
        on_constraint: Callable,
        perm_local=None,
        perm_next=None,
        perm_challenges=None,
        cumulative_sum=None,
    ):
        self.backend = backend
        self.get_main_local = main_local
        self.get_main_next = main_next
        self.get_prep_local = prep_local
        self.get_prep_next = prep_next
        self.is_first_row = is_first_row
        self.is_last_row = is_last_row
        self.is_transition = is_transition
        self.on_constraint = on_constraint
        self.perm_local = perm_local
        self.perm_next = perm_next
        self.perm_challenges = perm_challenges
        self.cumulative_sum = cumulative_sum

    def assert_zero(self, x):
        if not isinstance(x, V):
            x = self._const(x)
        self.on_constraint(x)
