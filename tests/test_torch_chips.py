"""The port's 7 new chips against the JAX package's: main and preprocessed
traces on the `fibo` and `printa` guests, the byte-table histogram, and the
symbolic analysis (lookups, degrees) of all 8 chips."""

import numpy as np
import pytest
import torch

from zkvm_brainfuck_tpu.core.executor import execute_python as jax_execute
from zkvm_brainfuck_tpu.core.program import Program as JaxProgram
from zkvm_brainfuck_tpu.models.bytes import histogram as jax_histogram
from zkvm_brainfuck_tpu.models.machine_def import brainfuck_chips as jax_chips
from zkvm_brainfuck_tpu.stark.chip import Chip as JaxChip
from zkvm_brainfuck_tpu.stark.config import KoalaBearPoseidon2 as JaxConfig
from zkvm_brainfuck_tpu.stark.machine import StarkMachine as JaxMachine
from zkvm_brainfuck_tpu_torch import guests
from zkvm_brainfuck_tpu_torch.core.executor import execute
from zkvm_brainfuck_tpu_torch.core.program import Program
from zkvm_brainfuck_tpu_torch.models.bytes import histogram
from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
from zkvm_brainfuck_tpu_torch.stark.chip import Chip
from zkvm_brainfuck_tpu_torch.stark.config import KoalaBearPoseidon2
from zkvm_brainfuck_tpu_torch.stark.machine import StarkMachine
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

NEW_CHIPS = ("Program", "AddSub", "Jump", "Memory", "Byte", "MemoryInstrs", "IO")
INPUTS = {"fibo": bytes([5]), "printa": b""}


@pytest.fixture(scope="module")
def runs():
    """Per guest: (JAX record, JAX deps, JAX machine, port record, port deps, port machine)."""
    out = {}
    jm = JaxMachine(JaxConfig(), jax_chips())
    m = StarkMachine(KoalaBearPoseidon2(), brainfuck_chips())
    for name, stdin in INPUTS.items():
        src = guests.ALL[name]
        jrec = jax_execute(JaxProgram.from_source(src), stdin)
        rec = execute(Program.from_source(src), stdin)
        out[name] = (jrec, jm.generate_dependencies(jrec), jm, rec,
                     m.generate_dependencies(rec, device="cpu"), m)
    return out


def _chip(machine, name):
    return next(c for c in machine.chips if c.name == name)


@pytest.mark.parametrize("guest", sorted(INPUTS))
@pytest.mark.parametrize("chip_name", NEW_CHIPS)
def test_chip_traces_match_jax(runs, guest, chip_name):
    jrec, jdeps, jm, rec, deps, m = runs[guest]
    jchip, chip = _chip(jm, chip_name), _chip(m, chip_name)
    assert chip.included(rec) == jchip.included(jrec)
    if chip.included(rec):
        want = np.asarray(jchip.air.generate_trace(jrec, jdeps)).astype(np.int64)
        got = chip.air.generate_trace(rec, deps, device="cpu")
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(got.numpy().astype(np.int64), want)
    src = guests.ALL[guest]
    jprep = jchip.air.generate_preprocessed(JaxProgram.from_source(src))
    prep = chip.air.generate_preprocessed(Program.from_source(src), device="cpu")
    assert (prep is None) == (jprep is None) == (chip.preprocessed_width == 0)
    if prep is not None:
        assert np.array_equal(prep.numpy().astype(np.int64), np.asarray(jprep).astype(np.int64))


def test_guests_cover_the_chips(runs):
    """fibo runs every chip; printa (no jumps, no pointer moves) leaves out
    Jump and MemoryInstrs, so the machine's inclusion logic is exercised."""
    included = {g: {c.name for c in r[5].shard_chips(r[3])} for g, r in runs.items()}
    assert included["fibo"] == {c.name for c in brainfuck_chips()}
    assert included["printa"] == included["fibo"] - {"Jump", "MemoryInstrs"}


@pytest.mark.parametrize("guest", sorted(INPUTS))
def test_byte_histogram_matches_jax(runs, guest):
    _jrec, jdeps, _jm, _rec, deps, _m = runs[guest]
    for want, got in zip(jax_histogram(jdeps), histogram(deps, torch.device("cpu"))):
        assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    assert sum(len(v) for v, _w in deps.u8) == sum(len(v) for v, _w in jdeps.u8)


@pytest.mark.parametrize("chip_name", ["Cpu", *NEW_CHIPS])
def test_chip_analysis_matches_jax(chip_name):
    jair = next(a for a in jax_chips() if a.name == chip_name)
    air = next(a for a in brainfuck_chips() if a.name == chip_name)
    jchip, chip = JaxChip(jair), Chip(air)
    assert (chip.width, chip.preprocessed_width, chip.local_only) == (
        jchip.width, jchip.preprocessed_width, jchip.local_only)
    assert chip.max_constraint_degree == jchip.max_constraint_degree
    assert chip.log_quotient_degree == jchip.log_quotient_degree
    assert chip.permutation_width == jchip.permutation_width

    def plain(lookups):
        aff = lambda a: (a.const, a.terms)  # noqa: E731
        return [(tuple(map(aff, lk.values)), aff(lk.multiplicity), int(lk.kind)) for lk in lookups]

    assert plain(chip.sends) == plain(jchip.sends)
    assert plain(chip.receives) == plain(jchip.receives)


def test_machine_chip_order_matches_jax():
    assert [a.name for a in brainfuck_chips()] == [a.name for a in jax_chips()]
