"""Logger setup (reference: crates/core/machine/src/utils/logger.rs).

Honors RUST_LOG-style levels via `ZKBF_LOG` (or `RUST_LOG` for habit):
error/warn/info/debug/trace.  `setup_logger()` is idempotent.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from contextlib import contextmanager

_LEVELS = {
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG,
}

_configured = False


def setup_logger():
    global _configured
    if _configured:
        return
    level_name = os.environ.get("ZKBF_LOG", os.environ.get("RUST_LOG", "info")).lower()
    level = _LEVELS.get(level_name.split(",")[0], logging.INFO)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s", "%H:%M:%S")
    )
    root = logging.getLogger("zkbf")
    root.setLevel(level)
    root.addHandler(handler)
    root.propagate = False
    _configured = True


@contextmanager
def span(name: str, logger: logging.Logger | None = None, level=logging.DEBUG):
    """Timed span, the tracing::debug_span! equivalent."""
    logger = logger or logging.getLogger("zkbf")
    t0 = time.time()
    try:
        yield
    finally:
        logger.log(level, "%s: %.3fs", name, time.time() - t0)
