"""Per-phase wall-time collection for the prover pipeline.

Counterpart of the JAX package's utils/phases.py.  The reference logs
per-phase times through tracing spans (crates/stark/src/prover.rs:298-316,
machine.rs:161-168); here each phase that the prover writes into
`BfCoreProof.timings` also calls `add(name, seconds)` with the same name
and the same seconds (synchronized with the card), and a collector
installed around a prove receives the accumulated breakdown.

Thread-safe enough for the prover's use (phases are recorded from the
main thread; warm-up threads record nothing).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

_active: Optional[Dict[str, float]] = None


def add(name: str, seconds: float) -> None:
    """Accumulate `seconds` into phase `name` of the active collector."""
    global _active
    if _active is not None:
        _active[name] = _active.get(name, 0.0) + seconds


@contextlib.contextmanager
def collect(out: Optional[Dict[str, float]] = None):
    """Collect phase times for the duration of the context; yields the dict."""
    global _active
    prev = _active
    d: Dict[str, float] = out if out is not None else {}
    _active = d
    try:
        yield d
    finally:
        _active = prev
