"""Duplex-sponge Fiat-Shamir challenger (KoalaBear, Poseidon2 width 16, rate 8).

Host semantics copied from the JAX package's stark/challenger.py, which
mirrors the reference's `DuplexChallenger<Val, Perm, 16, 8>`:

- `observe` clears the output buffer, pushes into the input buffer, and
  duplexes when the input buffer reaches RATE.
- duplexing overwrites the state prefix with buffered inputs, permutes, and
  refills the output buffer with state[..RATE].
- `sample` duplexes first if inputs are pending or outputs exhausted, then
  pops from the END of the output buffer (so the first sample is state[7]).
- `sample_ext` draws 4 base samples as EF4 coefficients 0..3.
- `sample_bits` masks the canonical value to the low bits.
- `check_witness(bits, w)` absorbs a proof-of-work witness and checks
  that the next `sample_bits(bits)` is 0.

A frozen copy of the port's host transcript (exact Python ints), without
the prover's grind: the verifier only checks the witness.
"""

from __future__ import annotations

from typing import List, Sequence

from . import field as f
from . import poseidon2 as p2

WIDTH = p2.WIDTH
RATE = p2.RATE


class DuplexChallenger:
    def __init__(self):
        self.state: List[int] = [0] * WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    def _duplexing(self):
        assert len(self.input_buffer) <= RATE
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        self.state = p2.permute_host(self.state)
        self.output_buffer = list(self.state[:RATE])

    def observe(self, value: int):
        value = int(value) % f.P
        self.output_buffer.clear()
        self.input_buffer.append(value)
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_slice(self, values: Sequence[int]):
        for v in values:
            self.observe(v)

    def observe_commitment(self, digest: Sequence[int]):
        assert len(digest) == p2.DIGEST_SIZE
        self.observe_slice(digest)

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def sample_ext(self) -> tuple:
        """EF4 element, coefficients (c0, c1, c2, c3), canonical ints."""
        return tuple(self.sample() for _ in range(4))

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0
