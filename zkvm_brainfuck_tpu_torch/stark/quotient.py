"""Quotient helpers shared with the JAX package's stark/quotient.py.

Only the constraint-axis sum is needed by the uni-STARK quotient; the
machine quotient (permutation constraints, per-chip chunking) comes with
the multi-table prover.
"""

from __future__ import annotations

from ..ops import field as xf


def _fsum_axis0(x):
    """Exact mod-p sum over the (small) constraint axis."""
    return xf.fsum_small(x, axis=0)
