"""The frozen work counts against the port smoke script's figures and the
port's own quotient program counts, at known shapes."""

import chip_smoke
import pytest

from port_bench import work
from port_bench.work.shapes import _chips, chip_shapes


def test_constants_are_the_smoke_scripts():
    assert work.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert work.INT_OPS_PER_S == chip_smoke.INT_OPS_PER_S
    assert work.IMMA_OPS_PER_S == chip_smoke.IMMA_OPS_PER_S
    assert work.EF4_INV_MULS == chip_smoke.EF4_INV_MULS
    assert (work.MUL_INSTR, work.ADD_INSTR) == (chip_smoke.MUL_INSTR, chip_smoke.ADD_INSTR)
    # Poseidon2: the external linear layers' additions move to the tensor cores
    assert work.P2_INSTR == chip_smoke.P2_INSTR_PER_PERM - 9 * 72 * chip_smoke.ADD_INSTR


def test_logup_products_match_the_smoke_script():
    from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.permutation import logup_table

    table = _chips()
    for air in brainfuck_chips():
        chip = Chip(air)
        if chip.num_interactions:
            assert table[chip.name]["logup_products"] == chip_smoke.logup_mults_per_row(logup_table(chip))


def test_quotient_counts_near_the_ports_program():
    from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu_torch.stark import codegen
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip

    table = _chips()
    for air in brainfuck_chips():
        chip = Chip(air)
        c = codegen.program(chip, chip.num_interactions > 0).counts
        mine = table[chip.name]
        assert mine["quotient_reads"] == c["columns"]
        assert mine["quotient_products"] == pytest.approx(c["products"], rel=0.10)
        assert mine["quotient_additions"] == pytest.approx(c["additions"], rel=0.10)


def test_cpu_quotient_bound_at_the_smoke_scripts_shape():
    """The Cpu chip's quotient at 2^21 coset rows: chip_smoke gave 0.7018 ms
    (operations) from the port's program counts."""
    cpu = [c for c in chip_shapes({"Cpu": 20})]
    got = work.seconds(work.proof_work(cpu, 1, 0)["quotient"]) * 1e3
    assert got == pytest.approx(0.7018, rel=0.05)


def test_a_proof_at_2p20_and_2p22():
    small = {"Cpu": 20, "Program": 17, "AddSub": 20, "Jump": 19, "Memory": 4, "Byte": 16,
             "MemoryInstrs": 12, "IO": 4}
    w = work.proof_work(chip_shapes(small), 1, 16)
    assert set(w) == {"lde", "row_hash", "tree", "logup", "quotient", "open_eval", "reduced_open",
                      "fri_fold", "grind"}
    total = sum(work.seconds(v) for v in w.values())
    assert 0.012 < total < 0.020  # the smoke script's bounds summed to about 20 ms
    big = dict(small, Cpu=22, AddSub=21, Jump=21)
    assert sum(work.seconds(v) for v in work.proof_work(chip_shapes(big), 1, 16).values()) > 3 * total
