"""The port's BF_DEBUG replay (stark/debug.py, StarkMachine.debug_constraints)
against the JAX package's stark/debug.py.  Both checkers run on the same
numpy traces of the `printa` guest (made by the port on the CPU) and on the
same corruptions, picked with a numpy seed, and must give identical results,
with exact equality: the failure strings of check_constraints and the
imbalance dict of debug_lookup_balance.  The JAX checker is host numpy; the
JAX package's whole debug_constraints is not run (its LogUp compiles are
slow)."""

import copy

import numpy as np
import pytest

from zkvm_brainfuck_tpu.models.machine_def import brainfuck_chips as jax_airs
from zkvm_brainfuck_tpu.stark import debug as jax_debug
from zkvm_brainfuck_tpu.stark.chip import Chip as JaxChip
from zkvm_brainfuck_tpu_torch import guests
from zkvm_brainfuck_tpu_torch.core.executor import execute
from zkvm_brainfuck_tpu_torch.core.program import Program
from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
from zkvm_brainfuck_tpu_torch.stark import debug as port_debug
from zkvm_brainfuck_tpu_torch.stark.config import KoalaBearPoseidon2
from zkvm_brainfuck_tpu_torch.stark.machine import StarkMachine
from zkvm_brainfuck_tpu_torch.stark.permutation import generate_permutation_trace
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

P = 0x7F000001
# printa's shard: no loop and no pointer move, so no Jump or MemoryInstrs.
CHIPS = ["AddSub", "Byte", "Cpu", "IO", "Memory", "Program"]


@pytest.fixture(scope="module")
def printa():
    """{chip name: (port chip, JAX chip, prep, main)} of printa's traces as
    canonical uint32 numpy arrays, and the machine, program and record."""
    program = Program.from_source(guests.PRINTA_BF)
    record = execute(program, b"")
    machine = StarkMachine(KoalaBearPoseidon2(), brainfuck_chips())
    deps = machine.generate_dependencies(record, device="cpu")
    jax_chips = {c.name: c for c in (JaxChip(a) for a in jax_airs())}
    traces = {}
    for chip in machine.shard_chips(record):
        prep = chip.air.generate_preprocessed(program, device="cpu")
        main = chip.air.generate_trace(record, deps, device="cpu")
        traces[chip.name] = (chip, jax_chips[chip.name],
                             None if prep is None else prep.numpy().astype(np.uint32),
                             main.numpy().astype(np.uint32))
    return machine, program, record, traces


def _bump(x, rng):
    """x plus a nonzero amount, mod p."""
    return (int(x) + 1 + int(rng.integers(0, P - 1))) % P


def _perm(chip, prep, main, rng):
    """The port's permutation trace (plain versions) for challenges from `rng`."""
    import torch

    challenges = [tuple(int(v) for v in rng.integers(0, P, 4)) for _ in range(2)]
    t = lambda a: None if a is None else torch.from_numpy(a.astype(np.int32))  # noqa: E731
    perm, csum = generate_permutation_trace(chip, t(prep), t(main), challenges[0], challenges[1])
    return perm.numpy().astype(np.uint32), challenges, tuple(int(v) for v in csum)


def _balance(traces, jax):
    if jax:
        return jax_debug.debug_lookup_balance([(j, p, m) for _c, j, p, m in traces.values()])
    return port_debug.debug_lookup_balance([(c, p, m) for c, _j, p, m in traces.values()])


def test_printa_shard_chips(printa):
    assert sorted(printa[3]) == sorted(CHIPS)


@pytest.mark.parametrize("chip_name", CHIPS)
def test_clean_traces_pass_both_checkers(printa, chip_name):
    chip, jchip, prep, main = printa[3][chip_name]
    assert port_debug.check_constraints(chip, main, prep) == []
    assert jax_debug.check_constraints(jchip, main, prep) == []
    perm, challenges, csum = _perm(chip, prep, main, np.random.default_rng(1))
    assert port_debug.check_constraints(chip, main, prep, perm, challenges, csum) == []
    assert jax_debug.check_constraints(jchip, main, prep, perm, challenges, csum) == []


def test_clean_traces_balance(printa):
    assert _balance(printa[3], jax=False) == {} == _balance(printa[3], jax=True)


@pytest.mark.parametrize("chip_name", CHIPS)
def test_corrupted_main_cell_gives_the_same_failures(printa, chip_name):
    """One cell of the main trace, picked by a numpy seed among those a
    lookup reads in a row where its multiplicity is nonzero (padding may
    hold anything): the same failure strings from both checkers, and the
    same imbalance; one of the two catches it."""
    chip, jchip, prep, main = printa[3][chip_name]
    rng = np.random.default_rng(sum(map(ord, chip_name)))
    cells = sorted({(int(r), i) for lk in (*chip.sends, *chip.receives)
                    for r in np.nonzero(port_debug._affine_values(lk.multiplicity, prep, main))[0]
                    for aff in (*lk.values, lk.multiplicity) for is_prep, i, _w in aff.terms
                    if not is_prep})
    row, col = cells[int(rng.integers(0, len(cells)))]
    bad = main.copy()
    bad[row, col] = _bump(bad[row, col], rng)
    fails = port_debug.check_constraints(chip, bad, prep)
    assert fails == jax_debug.check_constraints(jchip, bad, prep)
    traces = dict(printa[3])
    traces[chip_name] = (chip, jchip, prep, bad)
    imbalance = _balance(traces, jax=False)
    assert imbalance == _balance(traces, jax=True)
    assert fails or imbalance, (row, col)


@pytest.mark.parametrize("chip_name", ["Cpu", "Memory", "Byte"])
def test_corrupted_running_sum_row_gives_the_same_failures(printa, chip_name):
    chip, jchip, prep, main = printa[3][chip_name]
    rng = np.random.default_rng(3)
    perm, challenges, csum = _perm(chip, prep, main, rng)
    nb = perm.shape[1] - 1
    row, k = int(rng.integers(0, perm.shape[0])), int(rng.integers(0, 4))
    perm[row, nb, k] = _bump(perm[row, nb, k], rng)
    fails = port_debug.check_constraints(chip, main, prep, perm, challenges, csum)
    assert fails and fails == jax_debug.check_constraints(jchip, main, prep, perm, challenges, csum)


def test_bumped_multiplicity_gives_the_same_imbalance(printa):
    """The first receive whose multiplicity reads a main column: that column
    one higher in row 0."""
    traces = dict(printa[3])
    name, col = next((n, t[1]) for n, (c, _j, _p, _m) in traces.items() for lk in c.receives
                     for t in lk.multiplicity.terms if not t[0])
    chip, jchip, prep, main = traces[name]
    bad = main.copy()
    bad[0, col] = (int(bad[0, col]) + 1) % P
    traces[name] = (chip, jchip, prep, bad)
    imbalance = _balance(traces, jax=False)
    assert imbalance and imbalance == _balance(traces, jax=True)


def test_debug_constraints_passes_on_printa_and_catches_a_corrupted_record(printa):
    machine, program, record, _traces = printa
    machine.debug_constraints(program, record, device="cpu")  # must not raise
    bad = copy.deepcopy(record)
    alu = np.nonzero(bad.alu_mask)[0]
    bad.cpu.next_mv[alu[0]] = (int(bad.cpu.next_mv[alu[0]]) + 1) % 256
    with pytest.raises(AssertionError):
        machine.debug_constraints(program, bad, device="cpu")
