"""Each chip's shape for `proof_work`, from the benchmark's own copy of the
machine's AIR (reference/air): widths, LogUp columns, quotient chunks, and
a row's work in the LogUp trace and in the quotient, counted by running the
chip's constraints over a backend that counts products and additions."""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List

from ..reference.air.builder import NumericBuilder, V
from ..reference.air.chip import Chip
from ..reference.air.machine_def import brainfuck_chips
from ..reference.stark.permutation import _interactions, eval_permutation_constraints
from . import EF4_INV_MULS, EF4_MUL


class _Count:
    """Counts a row's products and additions over expression keys, so a
    subexpression computed again is not counted again.  An operation on
    constants alone folds away; a product by a constant counts as an
    addition (a small multiple is a few additions), and a negation folds
    into the operation that uses it."""

    muls = adds = 0
    seen: set = set()

    @staticmethod
    def const(c):
        return ("k", c)

    @classmethod
    def _op(cls, name, a, b, muls, adds):
        key = (name,) + tuple(sorted((a, b), key=repr))
        if a[0] == "k" and b[0] == "k" or key in cls.seen:
            return key
        cls.seen.add(key)
        if a[0] == "k" or b[0] == "k":
            cls.adds += adds or muls
        else:
            cls.muls += muls
            cls.adds += adds
        return key

    @classmethod
    def add(cls, a, b):
        return cls._op("+", a, b, 0, 1)

    @classmethod
    def sub(cls, a, b):
        return cls._op("+", a, cls.neg(b), 0, 1)

    @classmethod
    def mul(cls, a, b):
        return cls._op("*", a, b, 1, 0)

    @staticmethod
    def neg(a):
        return ("neg", a) if a[0] != "k" else a

    eneg = neg

    @classmethod
    def eadd(cls, a, b):
        return cls._op("e+", a, b, 0, 4)

    @classmethod
    def eadd_base(cls, e, b):
        return cls._op("e+b", e, b, 0, 1)

    @classmethod
    def emul(cls, a, b):
        return cls._op("e*", a, b, *EF4_MUL)

    @classmethod
    def emul_base(cls, e, b):
        return cls._op("e*b", e, b, 4, 0)

    @staticmethod
    def lift(b):
        return b


def _fold(v):
    """The fold sum_j alpha^(K-1-j) c_j by per-proof weights: a base
    constraint takes 4 products, an EF4 one an EF4 product, and 4 additions."""
    _Count.muls += EF4_MUL[0] if v.ext else 4
    _Count.adds += (EF4_MUL[1] if v.ext else 0) + 4


def _quotient_row(chip: Chip):
    """(distinct columns read, local and next row alike, products,
    additions) of one quotient row:
    the constraints, their fold by alpha and the product by the inverse
    zeroifier; the per-proof parameters (challenges, beta powers) are
    inputs, not work."""
    reads = set()

    def col(kind, nxt, ext=False):
        def get(i):
            reads.add((kind, i))
            return V(_Count, ("v", kind, nxt, i), ext)
        return get

    _Count.muls = _Count.adds = 0
    _Count.seen = set()

    def var(*key, ext=True):
        return V(_Count, ("v",) + key, ext)

    b = NumericBuilder(
        backend=_Count, main_local=col("m", 0), main_next=col("m", 1),
        prep_local=col("p", 0), prep_next=col("p", 1),
        is_first_row=var("first", ext=False), is_last_row=var("last", ext=False),
        is_transition=var("transition", ext=False), on_constraint=_fold,
        perm_local=[var("perm", 0, i) for i in range(chip.permutation_width)],
        perm_next=[var("perm", 1, i) for i in range(chip.permutation_width)],
        perm_challenges=[var("alpha"), var("beta")], cumulative_sum=var("sum"),
    )
    chip.eval(b)
    if chip.num_interactions:
        inter = _interactions(chip)
        b.perm_beta_pows = [var("beta_pow", j)
                            for j in range(max(len(lk.values) for lk, _ in inter) + 1)]
        eval_permutation_constraints(chip, b)
    return len(reads) + 4 * chip.permutation_width, _Count.muls + 4, _Count.adds


def _logup_products(chip: Chip) -> int:
    """A row's products of the LogUp trace: the affine terms and beta
    products of every fingerprint, the prefix products, one EF4 inverse,
    the unwind and the 4 products of each term (chip_smoke's count)."""
    n = chip.num_interactions
    per = 0
    for lk, _send in _interactions(chip):
        per += sum(len(a.terms) + 4 for a in lk.values) + len(lk.multiplicity.terms)
    return per + 16 * (n - 1) + EF4_INV_MULS + 2 * 16 * (n - 1) + 4 * n


@lru_cache(maxsize=None)
def _chips() -> Dict[str, dict]:
    out = {}
    for air in brainfuck_chips():
        chip = Chip(air)
        reads, muls, adds = _quotient_row(chip)
        out[chip.name] = {
            "width": chip.width, "prep_width": chip.preprocessed_width,
            "perm_width": chip.permutation_width, "quotient_chunks": chip.quotient_width,
            "local_only": chip.local_only,
            "logup_products": _logup_products(chip) if chip.num_interactions else 0,
            "quotient_reads": reads, "quotient_products": muls, "quotient_additions": adds,
        }
    return out


def chip_shapes(log_degrees: Dict[str, int]) -> List[dict]:
    """The shapes of a proof's chips, given each chip's log2 height."""
    table = _chips()
    return [dict(table[name], n=1 << ld) for name, ld in log_degrees.items()]
