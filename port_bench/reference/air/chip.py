"""Chip wrapper: symbolic analysis at construction.

Counterpart of crates/stark/src/chip.rs: runs the AIR once over the symbolic
builder to extract send/receive lookups and the max constraint degree, then
derives log_quotient_degree = ceil(log2(deg-1)) (min degree 3 when any
lookups exist) and the LogUp batch size 2^log_quotient_degree.
"""

from __future__ import annotations

import math
from typing import List

from .base import ChipAir
from .builder import SymbolicBuilder
from .lookup import Lookup


def permutation_trace_width(num_interactions: int, batch_size: int) -> int:
    if num_interactions == 0:
        return 0
    return (num_interactions + batch_size - 1) // batch_size + 1


class Chip:
    def __init__(self, air: ChipAir):
        self.air = air
        b = SymbolicBuilder(air.preprocessed_width, air.width)
        air.eval(_wire_views(air, b))
        self.sends: List[Lookup] = b.sends
        self.receives: List[Lookup] = b.receives

        max_degree = max(b.max_degree, 1)
        if self.sends or self.receives:
            max_degree = max(max_degree, 3)
        self.max_constraint_degree = max_degree
        self.log_quotient_degree = (
            0 if max_degree <= 1 else math.ceil(math.log2(max_degree - 1))
        )

    # -- passthroughs -----------------------------------------------------

    @property
    def name(self):
        return self.air.name

    @property
    def width(self):
        return self.air.width

    @property
    def preprocessed_width(self):
        return self.air.preprocessed_width

    @property
    def local_only(self):
        return self.air.local_only

    def included(self, record):
        return self.air.included(record)

    @property
    def logup_batch_size(self) -> int:
        return 1 << self.log_quotient_degree

    @property
    def quotient_width(self) -> int:
        return 1 << self.log_quotient_degree

    @property
    def num_interactions(self) -> int:
        return len(self.sends) + len(self.receives)

    @property
    def permutation_width(self) -> int:
        return permutation_trace_width(self.num_interactions, self.logup_batch_size)

    def num_sent_byte_lookups(self) -> int:
        from .lookup import LookupKind

        return sum(1 for s in self.sends if s.kind == LookupKind.BYTE)

    def eval(self, builder):
        """Run AIR constraints with layout views wired onto the builder."""
        self.air.eval(_wire_views(self.air, builder))


def _wire_views(air: ChipAir, b):
    """Attach local/next/prep views from the chip layouts to a builder."""
    b.local = air.cols.view(b.get_main_local)
    b.next = air.cols.view(b.get_main_next)
    if air.prep_cols is not None:
        b.prep_local = air.prep_cols.view(b.get_prep_local)
        b.prep_next = air.prep_cols.view(b.get_prep_next)
    else:
        b.prep_local = None
        b.prep_next = None
    return b
