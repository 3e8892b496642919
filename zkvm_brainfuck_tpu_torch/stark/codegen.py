"""Each chip's quotient kernel, generated from the chip's own constraints.

`program(chip)` runs `chip.eval` and `eval_permutation_constraints` once
over a `NumericBuilder` whose backend records instead of computing
(`Recorder`, the ten methods of `TorchBackend`), exactly as the plain
quotient (stark/quotient.py `quotient_rows_plain`) runs them over torch
columns.  What it records is a straight-line program over KoalaBear a row:

- inputs: a column at the local or the next row, the three selectors, and
  parameter words that change with every transcript (the LogUp alpha and
  beta, the beta powers, the cumulative sum, the fold weights
  alpha^(K-1-j)), so a chip's kernel is compiled once, whatever the proof;
- the base operations add, neg and mul.  EF4 operations are written out
  into them as they are recorded (x^4 = 3), so the zero coefficients of a
  lifted base value fold away;
- constants folded on the host (const op const, x + 0, x * 0, x * 1,
  x * -1, -(-x)); an operation already recorded on the same operands is
  not recorded again;
- each constraint folded into the accumulator as it is emitted: a base
  constraint by its EF4 weight's 4 products, an extension one by an EF4
  product.

`Program.source()` renders the live operations as the body of
csrc/quotient.cuh's kernel, every value in Montgomery form: a column is
read from the shared-memory tile at each use, at a compile-time offset
from the row's (`lp`) or the next row's (`np`) base, so it holds no
register between uses; constants are emitted converted, an addition of a
negation becomes a subtraction, a product by 2 or 3 additions.  build.py
compiles the text into a library named by its hash; ops/quotient.py
launches it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..ops.field import P
from . import ef_host as efh
from .builder import NumericBuilder, V
from .permutation import _interactions, eval_permutation_constraints, host_beta_pows

_R = (1 << 32) % P  # Montgomery radix mod p


def _mont(c: int) -> int:
    return c * _R % P


class Recorder:
    """A backend that records: a base payload is a node id, an EF4 payload
    a tuple of 4.  Node i is ops[i] = (op, a, b); op is one of const, ld,
    sel, prm, wt (inputs) or add, neg, mul."""

    def __init__(self):
        self.ops: List[Tuple] = []
        self._index: Dict[Tuple, int] = {}

    def node(self, op, a=None, b=None) -> int:
        key = (op, a, b)
        i = self._index.get(key)
        if i is None:
            i = self._index[key] = len(self.ops)
            self.ops.append(key)
        return i

    def cval(self, i: int):
        op, a, _b = self.ops[i]
        return a if op == "const" else None

    # -- the base operations ------------------------------------------------

    def const(self, c):
        return self.node("const", int(c) % P)

    def add(self, x, y):
        cx, cy = self.cval(x), self.cval(y)
        if cx is not None and cy is not None:
            return self.const(cx + cy)
        if cx == 0:
            return y
        if cy == 0:
            return x
        return self.node("add", min(x, y), max(x, y))

    def neg(self, x):
        c = self.cval(x)
        if c is not None:
            return self.const(-c)
        op, a, _b = self.ops[x]
        return a if op == "neg" else self.node("neg", x)

    def mul(self, x, y):
        cx, cy = self.cval(x), self.cval(y)
        if cx is not None and cy is not None:
            return self.const(cx * cy)
        if cx is not None:
            x, y, cx, cy = y, x, cy, cx
        if cy == 0:
            return self.const(0)
        if cy == 1:
            return x
        if cy == P - 1:
            return self.neg(x)
        return self.node("mul", min(x, y), max(x, y))

    # -- EF4, written out ---------------------------------------------------

    def eadd(self, a, b):
        return tuple(self.add(x, y) for x, y in zip(a, b))

    def emul(self, a, b):
        c = [self.const(0)] * 7
        for i in range(4):
            for j in range(4):
                c[i + j] = self.add(c[i + j], self.mul(a[i], b[j]))
        three = self.const(efh.W)
        for k in range(6, 3, -1):
            c[k - 4] = self.add(c[k - 4], self.mul(three, c[k]))
        return tuple(c[:4])

    def eneg(self, a):
        return tuple(self.neg(x) for x in a)

    def eadd_base(self, e, b):
        return (self.add(e[0], b),) + tuple(e[1:])

    def emul_base(self, e, b):
        return tuple(self.mul(x, b) for x in e)

    def lift(self, b):
        z = self.const(0)
        return (b, z, z, z)


class Program:
    """A chip's recorded quotient program and its rendering.

    Columns are numbered main (0..n_main), preprocessed, then the
    permutation planes (EF4 column i is planes 4i..4i+3).  Parameter words:
    with the LogUp constraints (`perm`), alpha' (4), beta (4), the beta
    powers ((max_vals + 1) x 4) and the cumulative sum (4), then the K fold
    weights (K x 4) in either case."""

    def __init__(self, chip, perm: bool):
        self.chip = chip
        self.perm = perm
        self.name = chip.name if perm else f"{chip.name}_air"
        self.n_main = chip.width
        self.n_prep = chip.preprocessed_width or 0
        self.n_perm = 4 * chip.permutation_width if perm else 0
        self.max_vals = max(len(lk.values) for lk, _ in _interactions(chip)) if perm else -1
        self.n_fixed = 4 * (3 + self.max_vals + 1) if perm else 0
        rec = self.rec = Recorder()
        flags: List[bool] = []
        acc = [rec.const(0)] * 4

        def fold(v):
            j = len(flags)
            flags.append(v.ext)
            w = tuple(rec.node("wt", 4 * j + t) for t in range(4))
            term = rec.emul(v.p, w) if v.ext else rec.emul_base(w, v.p)
            acc[:] = rec.eadd(acc, term)

        def col(c, nxt):
            return V(rec, rec.node("ld", c, nxt))

        def plane_cols(nxt):
            off = self.n_main + self.n_prep
            return [V(rec, tuple(rec.node("ld", off + 4 * i + k, nxt) for k in range(4)), True)
                    for i in range(self.n_perm // 4)]

        def prm(i):
            return V(rec, tuple(rec.node("prm", 4 * i + t) for t in range(4)), True)

        perm_kw = {}
        if perm:
            perm_kw = dict(perm_local=plane_cols(False), perm_next=plane_cols(True),
                           perm_challenges=[prm(0), prm(1)],
                           cumulative_sum=prm(3 + self.max_vals))
        has_prep = bool(self.n_prep)
        b = NumericBuilder(
            backend=rec,
            main_local=lambda i: col(i, False),
            main_next=lambda i: col(i, True),
            prep_local=(lambda i: col(self.n_main + i, False)) if has_prep else None,
            prep_next=(lambda i: col(self.n_main + i, True)) if has_prep else None,
            is_first_row=V(rec, rec.node("sel", 0)),
            is_last_row=V(rec, rec.node("sel", 1)),
            is_transition=V(rec, rec.node("sel", 2)),
            on_constraint=fold,
            **perm_kw,
        )
        chip.eval(b)
        if perm:
            b.perm_beta_pows = [prm(2 + j) for j in range(self.max_vals + 1)]
            eval_permutation_constraints(chip, b)
        from .quotient import constraint_ext_flags

        want = constraint_ext_flags(chip)
        assert flags == (want if perm else want[:len(flags)]), chip.name
        self.flags = flags
        self.k = len(flags)
        self.n_params = self.n_fixed + 4 * self.k
        self.out = tuple(acc)
        lines, self.counts = self._render()
        self.text = self._source(lines)

    def params(self, perm_challenges, alpha, cumulative_sum) -> np.ndarray:
        """The launch's canonical parameter words, (n_params,) uint32 (the
        launcher converts them to Montgomery form); the beta powers and
        the fold weights alpha^(K-1-j) by `ef_host.powers`."""
        parts = []
        if self.perm:
            beta = tuple(int(x) for x in perm_challenges[1])
            parts += [np.array([int(x) for x in perm_challenges[0]] + list(beta), np.uint64),
                      host_beta_pows(self.chip, beta).reshape(-1).astype(np.uint64),
                      np.array([int(x) for x in cumulative_sum], np.uint64)]
        parts.append(efh.powers(alpha, self.k)[::-1].reshape(-1))
        words = np.concatenate(parts) % P
        assert words.shape == (self.n_params,)
        return words.astype(np.uint32)

    # -- rendering ----------------------------------------------------------

    def _render(self):
        """C++ statements of the live operations, in recording order (which
        is topological), and the counts of a row: `loads` the distinct
        (column, row) values it reads, `reads` the tile reads emitted (one
        at each use), `products` and `additions` those of the constraints,
        their fold and the product by the inverse zeroifier (the staging's
        and the selectors' conversions into Montgomery form not counted)."""
        ops = self.rec.ops
        form = {}
        for i, (op, a, b) in enumerate(ops):
            if op == "add":
                if ops[b][0] == "neg":
                    form[i] = ("sub", a, ops[b][1])
                elif ops[a][0] == "neg":
                    form[i] = ("sub", b, ops[a][1])
                else:
                    form[i] = ("add", a, b)
            elif op == "mul" and ops[a][0] == "const":
                form[i] = ("mulc", b, ops[a][1])
            elif op == "mul" and ops[b][0] == "const":
                form[i] = ("mulc", a, ops[b][1])
            else:
                form[i] = (op, a, b)
        live = set()
        stack = [i for i in self.out if ops[i][0] != "const"]
        while stack:
            i = stack.pop()
            if i in live:
                continue
            live.add(i)
            op, a, b = form[i]
            deps = (a, b) if op in ("add", "sub", "mul") else (a,) if op in ("neg", "mulc") else ()
            stack.extend(x for x in deps if ops[x][0] != "const")

        counts = {"loads": 0, "reads": 0, "selectors": 0, "products": 4, "additions": 0}

        def ref(x):
            c = self.rec.cval(x)
            if c is not None:
                return f"{_mont(c)}u"
            op, a, b = ops[x]
            if op == "ld":  # a shared-memory read at each use
                counts["reads"] += 1
                return f"{'np' if b else 'lp'}[{a}]"
            return f"v{x}"

        counts["columns"] = len({ops[i][1] for i in live if ops[i][0] == "ld"})
        lines = []
        for i in sorted(live):
            op, a, b = form[i]
            if op == "ld":
                counts["loads"] += 1
                continue
            if op == "sel":
                expr = f"sel(a, r, {a})"
                counts["selectors"] += 1
            elif op == "prm":
                expr = f"a.prm[{a}]"
            elif op == "wt":
                expr = f"a.prm[{self.n_fixed + a}]"
            elif op == "add":
                expr = f"kb::add({ref(a)}, {ref(b)})"
                counts["additions"] += 1
            elif op == "sub":
                expr = f"kb::sub({ref(a)}, {ref(b)})"
                counts["additions"] += 1
            elif op == "neg":
                expr = f"ef4::neg({ref(a)})"
                counts["additions"] += 1
            elif op == "mulc" and b == 2:
                expr = f"kb::add({ref(a)}, {ref(a)})"
                counts["additions"] += 1
            elif op == "mulc" and b == 3:
                expr = f"ef4::x3({ref(a)})"
                counts["additions"] += 2
            elif op == "mulc":
                expr = f"kb::mont_mul({ref(a)}, {_mont(b)}u)"
                counts["products"] += 1
            elif op == "mul":
                expr = f"kb::mont_mul({ref(a)}, {ref(b)})"
                counts["products"] += 1
            else:
                raise AssertionError(op)
            lines.append(f"  const uint32_t v{i} = {expr};")
        for t, x in enumerate(self.out):
            lines.append(f"  acc[{t}] = {ref(x)};")
        return lines, counts

    def _source(self, lines: List[str]) -> str:
        n_ext = sum(self.flags)
        c = self.counts
        head = [
            f"// The quotient kernel of the {self.chip.name} chip"
            f"{'' if self.perm else ' without its LogUp constraints'}, generated by",
            "// zkvm_brainfuck_tpu_torch/stark/codegen.py from the chip's eval"
            f"{' and eval_permutation_constraints' if self.perm else ''}.",
            f"// {self.k} constraints ({n_ext} extension), {self.n_main} main, {self.n_prep} "
            f"preprocessed and {self.n_perm} permutation-plane columns,",
            f"// {self.n_params} parameter words; a row: {c['loads']} column values "
            f"({c['reads']} tile reads), {c['selectors']} selectors, {c['products']} products, "
            f"{c['additions']} additions.",
            f"#define ZKBF_Q_NCOL {self.n_cols}",
            f"#define ZKBF_Q_NPRM {self.n_params}",
            '#include "quotient.cuh"',
            "",
            "namespace zkbfq {",
            "__device__ __forceinline__ void body(const Args& a, long long r, TileRow lp, TileRow np,",
            "                                     uint32_t acc[4]) {",
        ]
        return "\n".join(head + lines + ["}", "}  // namespace zkbfq", ""])

    @property
    def n_cols(self) -> int:
        return self.n_main + self.n_prep + self.n_perm


def program(chip, perm: bool = True) -> Program:
    """The chip's quotient program, with (`perm`) or without its LogUp
    constraints (the uni-STARK), recorded once and kept on the chip."""
    key = f"_quotient_program_{int(perm)}"
    prog = chip.__dict__.get(key)
    if prog is None:
        prog = chip.__dict__[key] = Program(chip, perm)
    return prog
