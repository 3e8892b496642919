"""The port's utils/ against the JAX package's, on the same inputs, with
exact equality: spans, turn-based sync, report lines and the logger's
levels.  Then one small prove on the CPU through `run_test`, shared by the
module, with BF_DEBUG=1: `phases.collect()` around it receives exactly the
keys of `BfCoreProof.timings`, the summary and report lines are logged, and
the replay runs.  The ZKBF_PROFILE hook writes a trace of what it wraps.
The examples and the new entry points need a card unless asked for the
CPU."""

import json
import logging
import os
import threading

import numpy as np
import pytest
import torch

from zkvm_brainfuck_tpu.utils import logging as jax_logging
from zkvm_brainfuck_tpu.utils.concurrency import TurnBasedSync as JaxTurnBasedSync
from zkvm_brainfuck_tpu.utils.report import generate_execution_report as jax_report
from zkvm_brainfuck_tpu.utils.report import sorted_table_lines as jax_sorted_lines
from zkvm_brainfuck_tpu.utils.span import SpanBuilder as JaxSpanBuilder
from zkvm_brainfuck_tpu_torch import NoCudaDevice, guests, setup_logger
from zkvm_brainfuck_tpu_torch.utils import logging as port_logging
from zkvm_brainfuck_tpu_torch.utils import phases
from zkvm_brainfuck_tpu_torch.utils.concurrency import TurnBasedSync
from zkvm_brainfuck_tpu_torch.utils.prove import prove_program, run_test
from zkvm_brainfuck_tpu_torch.utils.report import generate_execution_report, sorted_table_lines
from zkvm_brainfuck_tpu_torch.utils.span import SpanBuilder
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

OPS = "+-<>[],."


def _span_lines(builder_cls, rng):
    """A span tree built from the same numpy-seeded script of enters, items
    and exits."""
    b = builder_cls("program")
    depth = 0
    for step in rng.integers(0, 10, 60):
        if step == 0:
            b.enter(f"loop{depth}")
            depth += 1
        elif step == 1 and depth > 0:
            b.exit()
            depth -= 1
        else:
            b.item(OPS[step % len(OPS)], int(step))
    while depth:
        b.exit()
        depth -= 1
    root = b.finish()
    return root.lines(), root.total()


def test_span_lines_equal_jax():
    assert _span_lines(SpanBuilder, np.random.default_rng(5)) == \
        _span_lines(JaxSpanBuilder, np.random.default_rng(5))


def _turn_order(sync_cls, turns):
    sync, order = sync_cls(), []

    def worker(turn):
        sync.wait_for_turn(turn)
        order.append(turn)
        sync.advance_turn()

    threads = [threading.Thread(target=worker, args=(t,)) for t in turns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return order, sync.current_turn


def test_turn_sync_equals_jax():
    turns = [int(t) for t in np.random.default_rng(6).permutation(8)]
    assert _turn_order(TurnBasedSync, turns) == _turn_order(JaxTurnBasedSync, turns) \
        == (list(range(8)), 8)


def test_report_lines_equal_jax():
    rng = np.random.default_rng(7)
    table = {op: int(c) for op, c in zip(OPS, rng.integers(0, 1000, len(OPS)))}
    table["+"] = 0  # a zero row is hidden
    assert sorted_table_lines(table) == jax_sorted_lines(table)
    assert list(generate_execution_report(table)) == list(jax_report(table))


def test_logger_levels_and_span_equal_jax():
    assert port_logging._LEVELS == jax_logging._LEVELS
    assert setup_logger is port_logging.setup_logger
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    log = logging.getLogger("zkbf.test_torch_utils")
    log.addHandler(Keep())
    log.setLevel(logging.DEBUG)
    with port_logging.span("phase", log):
        pass
    with jax_logging.span("phase", log):
        pass
    want = [("%s: %.3fs", "phase", logging.DEBUG)] * 2
    assert [(r.msg, r.args[0], r.levelno) for r in records] == want


@pytest.fixture(scope="module")
def proved():
    """One CPU prove of `printa` through run_test, under phases.collect(),
    with BF_DEBUG=1: the proof, the collected phases and the prover's log
    messages."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    log = logging.getLogger("zkbf.prover")
    handler, level = Keep(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    saved = os.environ.get("BF_DEBUG")
    os.environ["BF_DEBUG"] = "1"
    try:
        with phases.collect() as collected:
            proof = run_test(guests.PRINTA_BF, b"", device="cpu")
    finally:
        if saved is None:
            os.environ.pop("BF_DEBUG")
        else:
            os.environ["BF_DEBUG"] = saved
        log.removeHandler(handler)
        log.setLevel(level)
    return proof, collected, [r.getMessage() for r in records]


def test_run_test_proves_and_verifies(proved):
    proof, _collected, _msgs = proved
    assert proof.public_values == b"A" and proof.cycles > 0


def test_phases_collect_the_timings_keys(proved):
    proof, collected, _msgs = proved
    assert set(collected) == set(proof.timings)
    assert {"execute", "trace_gen", "perm_trace", "pcs_open_total", "prove_total"} <= set(collected)
    assert collected == proof.timings  # one prove: the same seconds


def test_summary_and_report_are_logged(proved):
    proof, _collected, msgs = proved
    summary = [m for m in msgs if m.startswith("summary: ")]
    assert len(summary) == 1 and f"cycles={proof.cycles}," in summary[0]
    assert any(m.strip().endswith(" +") for m in msgs)  # the execution report


def test_profile_hook_writes_a_trace(tmp_path):
    """ZKBF_PROFILE's context (prover.py): a Chrome trace of the block in
    the directory, naming what ran; nothing without a directory."""
    from zkvm_brainfuck_tpu_torch.prover import _profiled

    with _profiled(None, torch.device("cpu")):
        pass
    with _profiled(str(tmp_path / "prof"), torch.device("cpu")):
        torch.arange(64).reshape(8, 8).sum(0)
    files = sorted(os.listdir(tmp_path / "prof"))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "prof" / files[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::sum" in names


def test_new_entry_points_need_a_card_unless_asked_for_cpu():
    from zkvm_brainfuck_tpu_torch.core.executor import execute
    from zkvm_brainfuck_tpu_torch.core.program import Program
    from zkvm_brainfuck_tpu_torch.examples import fibonacci, hello
    from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu_torch.stark.config import KoalaBearPoseidon2
    from zkvm_brainfuck_tpu_torch.stark.machine import StarkMachine

    if torch.cuda.is_available():
        pytest.skip("the card is there: the entry points take it")
    program = Program.from_source(guests.PRINTA_BF)
    machine = StarkMachine(KoalaBearPoseidon2(), brainfuck_chips())
    for call in (lambda: run_test(guests.PRINTA_BF), lambda: prove_program(guests.PRINTA_BF),
                 lambda: hello.main([]), lambda: fibonacci.main([]),
                 lambda: machine.debug_constraints(program, execute(program, b""))):
        with pytest.raises(NoCudaDevice):
            call()
