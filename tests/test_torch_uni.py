"""The port's slice as a whole: executor, Cpu-chip trace and uni-STARK proof
against the JAX package, cross-verification through convert.py, and the
JAX-made golden proof at 84 queries."""

import os

import numpy as np
import pytest

from zkvm_brainfuck_tpu.core.executor import execute_python as jax_execute
from zkvm_brainfuck_tpu.core.program import Program as JaxProgram
from zkvm_brainfuck_tpu.models.base import ByteDeps as JaxByteDeps
from zkvm_brainfuck_tpu.models.cpu import CpuChip as JaxCpuChip
from zkvm_brainfuck_tpu.stark import fri as jfri
from zkvm_brainfuck_tpu.stark import pcs as jpcs
from zkvm_brainfuck_tpu.stark import uni as juni
from zkvm_brainfuck_tpu.stark.challenger import DuplexChallenger as JaxChallenger
from zkvm_brainfuck_tpu.stark.chip import Chip as JaxChip
from zkvm_brainfuck_tpu.stark.fri import VerificationFailure as JaxVerificationFailure
from zkvm_brainfuck_tpu_torch import convert, guests
from zkvm_brainfuck_tpu_torch.core.executor import execute
from zkvm_brainfuck_tpu_torch.core.program import Program
from zkvm_brainfuck_tpu_torch.models.base import ByteDeps
from zkvm_brainfuck_tpu_torch.models.cpu import CpuChip
from zkvm_brainfuck_tpu_torch.stark.challenger import DuplexChallenger
from zkvm_brainfuck_tpu_torch.stark.chip import Chip
from zkvm_brainfuck_tpu_torch.stark.errors import VerificationFailure
from zkvm_brainfuck_tpu_torch.stark.uni import uni_stark_prove, uni_stark_verify
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

# A loop, an input and an output: 104 cycles -> a 128 x 31 Cpu trace.
SRC = ",[->+<]>."
INPUT = bytes([20])
QUERIES = 8
P = 0x7F000001
GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden",
    f"uni_cpu_{guests.GOLDEN_NAME}_q{guests.GOLDEN_QUERIES}.json",
)


@pytest.fixture(scope="module")
def records():
    return jax_execute(JaxProgram.from_source(SRC), INPUT), execute(Program.from_source(SRC), INPUT)


@pytest.fixture(scope="module")
def traces(records):
    jrec, rec = records
    jtrace = np.asarray(JaxCpuChip().generate_trace(jrec, JaxByteDeps()))
    return jtrace, CpuChip().generate_trace(rec, ByteDeps(), device="cpu")


@pytest.fixture(scope="module")
def jax_proof(traces):
    """The JAX package's proof, computed once per module."""
    return juni.uni_stark_prove(JaxChip(JaxCpuChip()), traces[0], JaxChallenger(), num_queries=QUERIES)


@pytest.fixture(scope="module")
def port_proof(traces):
    return uni_stark_prove(Chip(CpuChip()), traces[1], DuplexChallenger(), num_queries=QUERIES,
                           device="cpu")


def test_executor_record_matches_jax(records):
    jrec, rec = records
    assert 64 < rec.num_cycles <= 128 and rec.output_stream == jrec.output_stream == bytes([20])
    for name in ("pc", "next_pc", "mp", "next_mp", "mv", "next_mv", "opcode", "op_a",
                 "mv_accessed", "mv_prev_ts", "mv_prev_value", "next_mv_accessed",
                 "next_mv_prev_ts"):
        assert np.array_equal(getattr(rec.cpu, name), getattr(jrec.cpu, name)), name
    for name in ("addr", "initial_ts", "initial_value", "final_ts", "final_value"):
        assert np.array_equal(getattr(rec.memory, name), getattr(jrec.memory, name)), name
    assert rec.global_clk == jrec.global_clk


def test_cpu_trace_matches_jax(traces):
    jtrace, trace = traces
    assert trace.shape == (128, 31)
    assert np.array_equal(convert.matrix_to_numpy(trace), jtrace)


def test_chip_analysis_matches_jax():
    chip, jchip = Chip(CpuChip()), JaxChip(JaxCpuChip())
    assert chip.width == jchip.width == 31
    assert chip.max_constraint_degree == jchip.max_constraint_degree
    assert chip.log_quotient_degree == jchip.log_quotient_degree == 1

    def plain(lookups):
        aff = lambda a: (a.const, a.terms)
        return [(tuple(map(aff, lk.values)), aff(lk.multiplicity), int(lk.kind)) for lk in lookups]

    assert plain(chip.sends) == plain(jchip.sends) and len(chip.sends) == 14
    assert plain(chip.receives) == plain(jchip.receives)


def test_operation_gadgets_match_jax():
    """The populate half of models/operations.py (torch) against the JAX
    package's (jnp), on the same random words and bytes."""
    import jax.numpy as jnp
    import torch

    from zkvm_brainfuck_tpu.models import operations as jop
    from zkvm_brainfuck_tpu_torch.models import operations as top

    rng = np.random.default_rng(9)
    words = rng.integers(0, P, size=64, dtype=np.uint32)
    words[:3] = [0, 1, 0x7F000000]
    a, b = rng.integers(0, 256, size=(2, 64), dtype=np.uint32)
    t = lambda x: torch.from_numpy(x.astype(np.int64))
    cases = [
        (jop.populate_add_operation(jnp.asarray(a), jnp.asarray(b)), top.populate_add_operation(t(a), t(b))),
        (jop.populate_is_zero(jnp.asarray(words)), top.populate_is_zero(t(words))),
        (jop.populate_kb_word_range_check(jnp.asarray(words)), top.populate_kb_word_range_check(t(words))),
        (jop.populate_kb_bit_decomposition(jnp.asarray(words)), top.populate_kb_bit_decomposition(t(words))),
        (dict(enumerate(jop.word_bytes(jnp.asarray(words)))), dict(enumerate(top.word_bytes(t(words))))),
    ]
    for want, got in cases:
        assert want.keys() == got.keys()
        for k in want:
            assert np.array_equal(np.asarray(want[k]).astype(np.int64), got[k].numpy()), k


def test_uni_proof_matches_jax_field_by_field(port_proof, jax_proof):
    mine = convert.uni_proof_to_dict(port_proof)
    theirs = convert.uni_proof_to_dict(jax_proof)
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert mine[key] == theirs[key], key


def test_port_verifier_accepts_both_proofs(port_proof, jax_proof):
    chip = Chip(CpuChip())
    uni_stark_verify(chip, port_proof, DuplexChallenger(), num_queries=QUERIES)
    uni_stark_verify(chip, convert.uni_proof_from_jax(jax_proof), DuplexChallenger(),
                     num_queries=QUERIES)


def test_jax_verifier_accepts_port_proof(port_proof):
    jp = convert.uni_proof_to_jax(
        port_proof, juni.UniProof, jpcs.PcsProof, jpcs.BatchOpening, jfri.FriProof
    )
    juni.uni_stark_verify(JaxChip(JaxCpuChip()), jp, JaxChallenger(), num_queries=QUERIES)


def test_tampered_opened_value_rejected(port_proof):
    chip = Chip(CpuChip())
    bad = convert.uni_proof_from_json(convert.uni_proof_to_json(port_proof))
    bad.main_local[3] = ((bad.main_local[3][0] + 1) % P,) + tuple(bad.main_local[3][1:])
    with pytest.raises(VerificationFailure):
        uni_stark_verify(chip, bad, DuplexChallenger(), num_queries=QUERIES)
    jp = convert.uni_proof_to_jax(bad, juni.UniProof, jpcs.PcsProof, jpcs.BatchOpening, jfri.FriProof)
    with pytest.raises(JaxVerificationFailure):
        juni.uni_stark_verify(JaxChip(JaxCpuChip()), jp, JaxChallenger(), num_queries=QUERIES)


def test_json_roundtrip(port_proof):
    text = convert.uni_proof_to_json(port_proof)
    assert convert.uni_proof_to_json(convert.uni_proof_from_json(text)) == text


def test_port_proof_equals_golden_fixture():
    """The JAX-made fixture (tools/make_uni_golden.py), reproduced by the
    port's plain versions byte for byte, and accepted by the port's verifier."""
    rec = execute(Program.from_source(guests.GOLDEN_SOURCE), guests.GOLDEN_INPUT)
    chip = Chip(CpuChip())
    trace = chip.air.generate_trace(rec, ByteDeps(), device="cpu")
    assert trace.shape == (1024, 31)
    proof = uni_stark_prove(chip, trace, DuplexChallenger(), num_queries=guests.GOLDEN_QUERIES,
                            device="cpu")
    with open(GOLDEN) as fh:
        golden = fh.read()
    assert convert.uni_proof_to_json(proof) == golden
    uni_stark_verify(chip, convert.uni_proof_from_json(golden), DuplexChallenger(),
                     num_queries=guests.GOLDEN_QUERIES)
