"""Turn-based synchronization (reference: utils/concurrency.rs TurnBasedSync).

Lets a pool of workers commit results in a deterministic turn order - kept for
parity with the reference's utility (unused on its core path too); useful when
host-side pipeline stages must serialize into the Fiat-Shamir transcript.
"""

from __future__ import annotations

import threading


class TurnBasedSync:
    def __init__(self):
        self._turn = 0
        self._cv = threading.Condition()

    @property
    def current_turn(self) -> int:
        with self._cv:
            return self._turn

    def wait_for_turn(self, my_turn: int):
        with self._cv:
            while self._turn != my_turn:
                self._cv.wait()

    def advance_turn(self):
        with self._cv:
            self._turn += 1
            self._cv.notify_all()
