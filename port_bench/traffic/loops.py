"""The `loops` generator: clear-loop guests of an exact cycle count.

A mix file naming `"generator": "loops"` gives `cycles`, `units`, `inner`
and `walk`; with a seed this module turns them into one guest program
(the same for every seed, so set-up does the same work in every run) and
the `stdin` of each job, which alone makes jobs differ.  Every job runs
exactly `cycles` instructions.

The program, in order:

- with `walk` (stride s, group g, passes): ',' reads the pass count P into
  cell 0; from cell 1 + s on, a loop paints every s-th cell, g cells a
  turn (g - 1 '+' and one ',' that reads the next byte; a 0 byte ends it),
  so a job whose `stdin` carries N group bytes paints C = N * g cells; it
  walks back over them ('<' * s while the cell is not zero) to cell 1,
  then makes P passes out to the end of the painted cells and back.  '>'
  and '<' touch no memory; the ']' after each step reads the cell it lands
  on, so every painted cell is an address of the Memory chip.
- `units` clear-loop units ',[>,[-]<-]' on cells 0 and 1: a unit reads A,
  then A times reads B and clears it (B '-' and B ']').
- ',.' : reads one byte and prints it.

`walk.cells` gives the range of C, split into `walk.sizes` values; each
block of `sizes` consecutive jobs takes every value once, in an order drawn
from the seed, so every seed proves the same set of sizes.  The filler
units take whatever cycles the walk leaves, spread over the units with
their inner counts drawn from `inner`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

UNIT = ",[>,[-]<-]"
UNIT_MAX_ITER = 6 + 2 * 255  # one outer iteration of a unit with B = 255
UNIT_MAX = 2 + 255 * UNIT_MAX_ITER


@dataclass(frozen=True)
class Walk:
    stride: int
    group: int
    cells: tuple
    sizes: int
    passes: int


@dataclass(frozen=True)
class Mix:
    name: str
    cycles: int
    units: int
    inner: tuple
    walk: Optional[Walk]

    @property
    def source(self) -> str:
        src = ""
        if self.walk is not None:
            s, g = ">" * self.walk.stride, self.walk.group
            back = "<" * self.walk.stride
            src += ",>" + s + ",[" + (s + "+") * (g - 1) + s + ",]" + back + "[" + back + "]<"
            src += "[->" + s + "[" + s + "]" + back + "[" + back + "]<]"
        return src + UNIT * self.units + ",."

    def cell_sizes(self) -> List[int]:
        w = self.walk
        vals = np.linspace(w.cells[0], w.cells[1], w.sizes)
        return [int(v) // w.group * w.group for v in vals]

    def walk_cycles(self, cells: int) -> int:
        """Cycles of the walk part for C painted cells (C a multiple of g)."""
        w = self.walk
        s, g, n = w.stride, w.group, cells // w.group
        paint = 3 + s + 1 + n * (g * (s + 1) + 1)
        back = s + 1 + cells * (s + 1) + 1
        passes = 2 if w.passes == 0 else 1 + w.passes * (6 + 2 * s + 2 * cells * (s + 1))
        return paint + back + passes

    def job(self, seed: int, j: int) -> bytes:
        return job(self, seed, j)


def make(name: str, p: dict) -> Mix:
    """The mix from its file's parameters."""
    w = p.get("walk")
    walk = None if w is None else Walk(int(w["stride"]), int(w["group"]), tuple(w["cells"]),
                                       int(w["sizes"]), int(w["passes"]))
    return Mix(name, int(p["cycles"]), int(p["units"]), tuple(p["inner"]), walk)


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), *key]))


def _unit_bytes(total: int, rng, inner) -> List[int]:
    """The bytes of one unit that runs exactly `total` cycles (3 for A = 0,
    else 2 plus its iterations: 7 for B = 0, 6 + 2B otherwise)."""
    if total == 3:
        return [0]
    s = total - 2
    k = s & 1  # an odd sum takes one B = 0 iteration
    e = s - 7 * k
    lo_n, hi_n = -(-e // UNIT_MAX_ITER), min(255 - k, e // 8)
    if s < 7 or (e and lo_n > hi_n) or (e == 0 and not k):
        raise ValueError(f"no unit runs {total} cycles")
    mean = 6 + (inner[0] + inner[1])
    n = min(max(round(e / mean), lo_n), hi_n) if e else 0
    b = rng.integers(inner[0], inner[1] + 1, n)
    diff = (e // 2 - 3 * n) - int(b.sum())
    while diff:
        for i in rng.permutation(n):
            step = int(np.clip(diff, 1 - b[i], 255 - b[i]))
            b[i] += step
            diff -= step
            if not diff:
                break
    iters = [int(x) for x in b] + [0] * k
    order = rng.permutation(len(iters))
    return [len(iters)] + [iters[i] for i in order]


def _split(total: int, units: int, rng) -> List[int]:
    """`total` cycles over `units` units, each within 5 % of an equal share."""
    w = 1 + rng.uniform(-0.05, 0.05, units)
    parts = [int(x) for x in total * w / w.sum()]
    parts[-1] += total - sum(parts)
    for t in parts:
        if t < 15:
            raise ValueError(f"{total} cycles do not fill {units} units")
        if t > UNIT_MAX:
            raise ValueError(f"a unit cannot run {t} cycles")
    return parts


def job(mix: Mix, seed: int, j: int) -> bytes:
    """The stdin of job j (j = -1: the warm-up job)."""
    rng = _rng(seed, j + 1)
    head: List[int] = []
    rest = mix.cycles - 2
    if mix.walk is not None:
        sizes = mix.cell_sizes()
        block = _rng(seed, 0, max(j, 0) // len(sizes)).permutation(len(sizes))
        cells = sizes[block[max(j, 0) % len(sizes)]]
        n = cells // mix.walk.group
        head = [mix.walk.passes] + [int(x) for x in rng.integers(1, 256, n)] + [0]
        rest -= mix.walk_cycles(cells)
    body: List[int] = []
    for t in _split(rest, mix.units, rng):
        body += _unit_bytes(t, rng, mix.inner)
    return bytes(head + body + [int(rng.integers(1, 256))])
