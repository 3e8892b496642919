"""Chip (AIR) base interface.

Counterpart of the JAX package's models/base.py: each chip declares its
column layout, generates its trace from the columnar execution record with
whole-column torch expressions on a device, contributes byte-table
dependencies, and evaluates its constraints through the polymorphic builder
(stark/builder.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.record import ExecutionRecord
from ..stark.layout import Layout


def next_power_of_two(n: int, minimum: int = 16) -> int:
    """Reference utils/mod.rs:47-53 (min height 16)."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def column(a: np.ndarray, device) -> torch.Tensor:
    """A host record column as an int64 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(device)


def pad_rows(cols: Dict[str, torch.Tensor], n: int, padded: int) -> Dict[str, torch.Tensor]:
    """Zero-pad every column tensor from n to `padded` rows."""
    if padded == n:
        return cols
    return {k: torch.nn.functional.pad(v, (0, padded - n)) for k, v in cols.items()}


@dataclass
class ByteDeps:
    """Byte-table dependency streams: (values, weights) pairs to histogram."""

    u8: List[Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=list)
    u16: List[Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=list)

    def add_u8(self, values, weights=None):
        w = torch.ones_like(values) if weights is None else weights
        self.u8.append((values, w))

    def add_u16(self, values, weights=None):
        w = torch.ones_like(values) if weights is None else weights
        self.u16.append((values, w))


class ChipAir:
    """Base chip. Subclasses define layouts, trace gen, and eval."""

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

    def included(self, record: ExecutionRecord) -> bool:
        return True

    def num_rows(self, record: ExecutionRecord) -> int:
        raise NotImplementedError

    def generate_trace(self, record: ExecutionRecord, deps, device=None) -> torch.Tensor:
        """(padded_rows, width) canonical int32 tensor on `device`."""
        raise NotImplementedError

    def byte_dependencies(self, record: ExecutionRecord, out: ByteDeps, device=None) -> None:
        """Contribute u8/u16 range-check streams (generate_dependencies)."""

    def generate_preprocessed(self, program, device=None) -> Optional[torch.Tensor]:
        """(rows, preprocessed width) canonical int32 tensor, or None."""
        return None

    def eval(self, b) -> None:
        """Constraints + lookup messages over a builder."""
        raise NotImplementedError
