"""Write the golden uni-STARK proof of the Cpu chip that the PyTorch/CUDA
port is held to.

Runs the JAX package's `uni_stark_prove` on the CPU for the guest
`zkvm_brainfuck_tpu_torch.guests.GOLDEN_SOURCE` (1020 cycles, a 1024 x 31
trace) at 84 FRI queries, and writes the proof in the port's stable JSON
encoding (`zkvm_brainfuck_tpu_torch.convert.uni_proof_to_json`) to
tests/golden/uni_cpu_<name>_q84.json.  The JAX verifier checks the proof
first.

    JAX_PLATFORMS=cpu python tools/make_uni_golden.py
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from zkvm_brainfuck_tpu.core.executor import execute_python
    from zkvm_brainfuck_tpu.core.program import Program
    from zkvm_brainfuck_tpu.models.base import ByteDeps
    from zkvm_brainfuck_tpu.models.cpu import CpuChip
    from zkvm_brainfuck_tpu.stark.challenger import DuplexChallenger
    from zkvm_brainfuck_tpu.stark.chip import Chip
    from zkvm_brainfuck_tpu.stark.uni import uni_stark_prove, uni_stark_verify
    from zkvm_brainfuck_tpu_torch import guests
    from zkvm_brainfuck_tpu_torch.convert import uni_proof_to_json

    record = execute_python(Program.from_source(guests.GOLDEN_SOURCE), guests.GOLDEN_INPUT)
    chip = Chip(CpuChip())
    trace = np.asarray(chip.air.generate_trace(record, ByteDeps()))
    q = guests.GOLDEN_QUERIES
    t0 = time.time()
    proof = uni_stark_prove(chip, trace, DuplexChallenger(), num_queries=q)
    uni_stark_verify(chip, proof, DuplexChallenger(), num_queries=q)
    path = os.path.join(ROOT, "tests", "golden", f"uni_cpu_{guests.GOLDEN_NAME}_q{q}.json")
    with open(path, "w") as fh:
        fh.write(uni_proof_to_json(proof))
    print(f"{record.num_cycles} cycles, trace {trace.shape}, proved and verified in "
          f"{time.time() - t0:.1f} s -> {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
