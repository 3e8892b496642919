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
- `grind(bits)` finds the LOWEST witness w with `observe(w);
  sample_bits(bits) == 0` (proof-of-work).

The transcript runs on the host with exact Python ints; only `grind` fans
out to a device, testing batches of candidates with `poseidon2.permute`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops import field as f
from ..ops import poseidon2 as p2
from ..ops.field import I64

WIDTH = p2.WIDTH
RATE = p2.RATE


class DuplexChallenger:
    def __init__(self):
        self.state: List[int] = [0] * WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []
        # Optional transcript log: a list of ["observe"|"sample", value].
        self.record = None

    def start_recording(self):
        self.record = []

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger()
        c.state = list(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplexing(self):
        assert len(self.input_buffer) <= RATE
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        self.state = p2.permute_host(self.state)
        self.output_buffer = list(self.state[:RATE])

    def observe(self, value: int):
        value = int(value) % f.P
        if self.record is not None:
            self.record.append(["observe", value])
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
        v = self.output_buffer.pop()
        if self.record is not None:
            self.record.append(["sample", v])
        return v

    def sample_ext(self) -> tuple:
        """EF4 element, coefficients (c0, c1, c2, c3), canonical ints."""
        return tuple(self.sample() for _ in range(4))

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0

    # -- proof-of-work ----------------------------------------------------

    def grind(self, bits: int, device) -> int:
        """Find and absorb the lowest PoW witness; returns it.

        Candidates start, start+1, ... go into lane k = len(input_buffer) of
        the duplex state (pending inputs applied), one `poseidon2.permute`
        batch per chunk; the first candidate whose canonical state[7] has
        `bits` low zero bits wins (the JAX program's argmax returns the
        first maximal index).  The chunk size does not change the
        answer: 2^17 candidates per launch on the card, 2^12 on the CPU."""
        device = torch.device(device)
        chunk = 1 << 17 if device.type == "cuda" else 1 << 12
        template = np.array(self.state, dtype=np.int64)
        k = len(self.input_buffer)
        assert k < RATE
        template[:k] = self.input_buffer
        tmpl = torch.as_tensor(template, device=device)
        mask_bits = (1 << bits) - 1
        start = 0
        while True:
            cand = torch.arange(start, start + chunk, dtype=I64, device=device)
            states = tmpl.expand(chunk, WIDTH).clone()
            states[:, k] = cand
            out = p2.permute(states.to(f.I32), out_cols=RATE)
            hit = ((out[:, RATE - 1] & mask_bits) == 0) & (cand < f.P)
            first = int(torch.where(hit, cand, start + chunk).min())
            if first < start + chunk:
                witness = first
                ok = self.check_witness(bits, witness)  # absorbs into transcript
                assert ok
                return witness
            start += chunk
