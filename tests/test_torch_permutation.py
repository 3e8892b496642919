"""The port's LogUp path (ops/logup.py through stark/permutation.py) against
the JAX package's generate_permutation_trace, the kernel wrapper's contract
on the CPU, and the permutation-constraint schedule.  The fused CUDA kernel
(entries and running sum in one launch) is held against the plain
composition, logup_entries_plain then logup_scan_plain, on the card
(`test_logup_kernels_match_plain_on_the_card`, and chip_smoke.py)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_brainfuck_tpu.core.executor import execute_python as jax_execute
from zkvm_brainfuck_tpu.core.program import Program as JaxProgram
from zkvm_brainfuck_tpu.models.machine_def import brainfuck_chips as jax_chips
from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.stark.config import KoalaBearPoseidon2 as JaxConfig
from zkvm_brainfuck_tpu.stark.machine import StarkMachine as JaxMachine
from zkvm_brainfuck_tpu.stark.permutation import generate_permutation_trace as jax_perm_trace
from zkvm_brainfuck_tpu.stark.quotient import constraint_ext_flags as jax_ext_flags
from zkvm_brainfuck_tpu_torch import guests
from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
from zkvm_brainfuck_tpu_torch.ops import kernels as kn
from zkvm_brainfuck_tpu_torch.ops import logup as lu
from zkvm_brainfuck_tpu_torch.ops.field import np_from_monty
from zkvm_brainfuck_tpu_torch.stark.chip import Chip
from zkvm_brainfuck_tpu_torch.stark.permutation import (
    generate_permutation_trace,
    host_beta_pows,
    logup_table,
)
from zkvm_brainfuck_tpu_torch.stark.quotient import constraint_ext_flags
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

P = 0x7F000001


def _port_chip(name):
    return Chip(next(a for a in brainfuck_chips() if a.name == name))


def _rand_ef(rng):
    return tuple(int(x) for x in rng.integers(0, P, 4))


@pytest.fixture(scope="module")
def fibo_traces():
    """JAX machine, and per chip its (main, prep) numpy traces of `fibo`."""
    jm = JaxMachine(JaxConfig(), jax_chips())
    src = guests.FIBO_BF
    rec = jax_execute(JaxProgram.from_source(src), bytes([4]))
    deps = jm.generate_dependencies(rec)
    out = {}
    for c in jm.chips:
        prep = c.air.generate_preprocessed(JaxProgram.from_source(src))
        out[c.name] = (c, np.asarray(c.air.generate_trace(rec, deps)),
                       None if prep is None else np.asarray(prep))
    return out


@pytest.mark.parametrize("chip_name", ["Cpu", "Byte"])
def test_plain_logup_matches_jax(fibo_traces, chip_name):
    """Entries, running sum and cumulative sum, as canonical values."""
    jchip, main, prep = fibo_traces[chip_name]
    rng = np.random.default_rng(11)
    alpha, beta = _rand_ef(rng), _rand_ef(rng)
    jperm, jcsum = jax_perm_trace(
        jchip,
        None if prep is None else jf.to_monty(jnp.asarray(prep)),
        jf.to_monty(jnp.asarray(main)),
        jf.to_monty(jnp.asarray(np.array(alpha, np.uint32))),
        beta,
    )
    chip = _port_chip(chip_name)
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    perm, csum = generate_permutation_trace(
        chip, None if prep is None else t(prep), t(main), alpha, beta
    )
    want = np_from_monty(np.asarray(jperm))
    assert perm.shape == want.shape == (main.shape[0], chip.permutation_width, 4)
    assert np.array_equal(perm.numpy().astype(np.uint32), want)
    assert np.array_equal(csum.numpy().astype(np.uint32), np_from_monty(np.asarray(jcsum)))


@pytest.fixture(scope="module")
def jax_machine():
    # One machine for the module: the JAX package caches the flags by id(chip),
    # so its chips must stay alive while they are compared.
    return JaxMachine(JaxConfig(), jax_chips())


@pytest.mark.parametrize("chip_name", [a.name for a in brainfuck_chips()])
def test_constraint_schedule_matches_jax(jax_machine, chip_name):
    jchip = next(c for c in jax_machine.chips if c.name == chip_name)
    flags = constraint_ext_flags(_port_chip(chip_name))
    assert flags == jax_ext_flags(jchip)
    assert flags.count(True) == _port_chip(chip_name).permutation_width - 1 + 3


def _decode(desc):
    """The kernel's descriptor table read back as interactions."""
    words = [int(x) for x in desc]
    pos = 0
    out = []

    def affine():
        nonlocal pos
        const, nt = words[pos], words[pos + 1]
        pos += 2
        terms = []
        for _ in range(nt):
            is_prep, col, wm = words[pos : pos + 3]
            terms.append((bool(is_prep), col, wm * pow(1 << 32, -1, P) % P))
            pos += 3
        return const, tuple(terms)

    while pos < len(words):
        sign, arg, nv = words[pos : pos + 3]
        pos += 3
        vals = tuple(affine() for _ in range(nv))
        out.append((bool(sign), arg, vals, affine()))
    return out


@pytest.mark.parametrize("chip_name", ["Cpu", "Byte", "Memory"])
def test_descriptor_table_encodes_the_interactions(chip_name):
    chip = _port_chip(chip_name)
    table = logup_table(chip)
    assert table is logup_table(chip)  # built once per chip
    assert (table.n_inter, table.batch) == (chip.num_interactions, chip.logup_batch_size)
    assert table.nb + 1 == chip.permutation_width
    want = [
        (is_send, lk.argument_index,
         tuple((a.const % P, tuple((p, i, w % P) for p, i, w in a.terms)) for a in lk.values),
         (lk.multiplicity.const % P,
          tuple((p, i, w % P) for p, i, w in lk.multiplicity.terms)))
        for lk, is_send in table.interactions
    ]
    assert _decode(table.descriptor("cpu")) == want
    assert [s for _lk, s in table.interactions] == [True] * len(chip.sends) + [False] * len(chip.receives)


def test_cpu_chip_fits_the_kernel():
    chip = _port_chip("Cpu")
    table = logup_table(chip)
    assert table.n_inter == lu.MAX_INTERACTIONS == 16
    assert (table.batch, table.nb, table.max_vals) == (2, 8, 7)


@pytest.mark.parametrize(
    "chip_name", ["Cpu", "Program", "AddSub", "Jump", "Memory", "Byte", "MemoryInstrs", "IO"])
def test_every_chip_fits_the_lane_split(chip_name):
    """ENTRY_LANES threads share a row, each taking ceil(NB / ENTRY_LANES)
    whole batches: at most 16 / ENTRY_LANES interactions a lane, for every
    chip."""
    table = logup_table(_port_chip(chip_name))
    per_lane = -(-table.nb // lu.ENTRY_LANES) * table.batch
    assert min(table.n_inter, per_lane) <= lu.MAX_INTERACTIONS // lu.ENTRY_LANES


def test_kernel_constants_match_the_source():
    """The wrapper's MAX_INTERACTIONS and ENTRY_LANES are the kernel's."""
    with open(os.path.join(os.path.dirname(lu.__file__), "..", "csrc", "logup.cu")) as fh:
        src = fh.read()
    assert int(re.search(r"constexpr int MAX_I = (\d+);", src).group(1)) == lu.MAX_INTERACTIONS
    assert int(re.search(r"constexpr int ENTRY_LANES = (\d+);", src).group(1)) == lu.ENTRY_LANES


def test_plain_scan_is_the_running_sum():
    rng = np.random.default_rng(2)
    perm = torch.from_numpy(rng.integers(0, P, (3000, 3, 4)).astype(np.int32))
    rows = perm[:, 2, :].numpy().astype(object)
    want = np.cumsum(rows, axis=0) % P
    entries = perm[:, :2, :].clone()
    csum = lu.logup_scan_plain(perm)
    assert np.array_equal(perm[:, 2, :].numpy().astype(object), want)
    assert torch.equal(perm[:, :2, :], entries)
    assert [int(x) for x in csum] == [int(x) for x in want[-1]]


def test_wrappers_take_plain_versions_on_cpu_and_check_inputs():
    chip = _port_chip("Byte")
    table = logup_table(chip)
    rng = np.random.default_rng(4)
    n = 64
    main = torch.from_numpy(rng.integers(0, P, (n, chip.width)).astype(np.int32))
    prep = torch.from_numpy(rng.integers(0, P, (n, chip.preprocessed_width)).astype(np.int32))
    chal = lu.challenge_matrix(_rand_ef(rng), host_beta_pows(chip, _rand_ef(rng)), "cpu")
    before = dict(kn.COUNTS)
    perm, csum = lu.logup_trace(table, main, prep, chal)
    assert kn.COUNTS == before  # plain versions are not launches
    want = lu.logup_entries_plain(table, main, prep, chal)
    assert torch.equal(csum, lu.logup_scan_plain(want)) and torch.equal(perm, want)
    with pytest.raises(ValueError):
        lu.logup_trace(table, main, None, chal)  # Byte reads its preprocessed columns
    with pytest.raises(ValueError):
        lu.logup_trace(table, main, prep, chal[:-1])
    with pytest.raises(ValueError):
        lu.logup_trace(table, main, prep[:-1], chal)  # prep's rows are not main's


@pytest.mark.cuda
def test_logup_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the LogUp kernels are CUDA only")
    rng = np.random.default_rng(7)
    for name, n in (("Cpu", 5000), ("Cpu", 64 * 3000 + 7), ("Byte", 1 << 16), ("Memory", 100)):
        chip = _port_chip(name)
        table = logup_table(chip)
        main = torch.from_numpy(rng.integers(0, P, (n, chip.width)).astype(np.int32)).cuda()
        prep = None
        if chip.preprocessed_width:
            prep = torch.from_numpy(
                rng.integers(0, P, (n, chip.preprocessed_width)).astype(np.int32)).cuda()
        chal = lu.challenge_matrix(_rand_ef(rng), host_beta_pows(chip, _rand_ef(rng)), "cuda")
        got, csum = lu.logup_trace(table, main, prep, chal)
        want = lu.logup_entries_plain(table, main, prep, chal)
        assert torch.equal(csum, lu.logup_scan_plain(want)), name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("chip_name,n", [("Cpu", 100), ("Cpu", 129), ("Memory", 16), ("Byte", 256),
                                         ("Jump", 64)])
def test_logup_trace_is_the_plain_composition(chip_name, n):
    """On the CPU, logup_trace is logup_entries_plain then logup_scan_plain:
    the entries, phi = the running sum of the row sums, and phi[N-1]."""
    chip = _port_chip(chip_name)
    table = logup_table(chip)
    rng = np.random.default_rng(n)
    main = torch.from_numpy(rng.integers(0, P, (n, chip.width)).astype(np.int32))
    prep = None
    if chip.preprocessed_width:
        prep = torch.from_numpy(rng.integers(0, P, (n, chip.preprocessed_width)).astype(np.int32))
    chal = lu.challenge_matrix(_rand_ef(rng), host_beta_pows(chip, _rand_ef(rng)), "cpu")
    perm, csum = lu.logup_trace(table, main, prep, chal)
    entries = lu.logup_entries_plain(table, main, prep, chal)
    assert torch.equal(perm[:, :-1], entries[:, :-1])
    rows = entries[:, -1, :].numpy().astype(object)
    phi = np.cumsum(rows, axis=0) % P
    assert np.array_equal(perm[:, -1, :].numpy().astype(object), phi)
    assert [int(x) for x in csum] == [int(x) for x in phi[-1]]
