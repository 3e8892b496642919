"""Chip (AIR) base interface.

Frozen from the port's models/base.py without trace generation: each chip
declares its column layout and evaluates its constraints through a builder
(builder.py).
"""

from __future__ import annotations

from typing import Optional

from .layout import Layout


def next_power_of_two(n: int, minimum: int = 16) -> int:
    """Reference utils/mod.rs:47-53 (min height 16)."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


class ChipAir:
    """Base chip. Subclasses define layouts and eval."""

    name: str = ""
    cols: Layout = None
    prep_cols: Optional[Layout] = None
    local_only: bool = False

    @property
    def width(self) -> int:
        return self.cols.width

    @property
    def preprocessed_width(self) -> int:
        return self.prep_cols.width if self.prep_cols else 0

    def eval(self, b) -> None:
        """Constraints + lookup messages over a builder."""
        raise NotImplementedError
