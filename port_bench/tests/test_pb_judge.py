"""The judgement on tiny proofs made on the CPU: accepted as made, refused
when a byte changes; and whole runs (the harness with the card's look
skipped) that come out not correct when the timed path is broken
underneath, or when the control breaks a guarantee."""

import dataclasses

import pytest

from port_bench import control, manifest, run
from port_bench.reference.judge import checks, judge, passed
from port_bench.traffic import loops

MIX = loops.Mix("tiny", 2**9 - 1, 1, (3, 20), loops.Walk(1, 4, (24, 48), 2, 0))
CONFIG = manifest.config("default")
CELL = manifest.cell("default.memstress_2p22")


@pytest.fixture(scope="module")
def made():
    from zkvm_brainfuck_tpu_torch import ProverClient
    from zkvm_brainfuck_tpu_torch.sdk import CpuProver
    from zkvm_brainfuck_tpu_torch.stark.config import FriConfig, KoalaBearPoseidon2

    client = ProverClient(CpuProver(config=KoalaBearPoseidon2(FriConfig(1, 84, 16)), device="cpu"))
    pk, vk = client.setup(MIX.source)
    stdin = MIX.job(4, 0)
    p = client.prove(pk, stdin).run()
    job = dict(stdin=stdin, proof=p.proof.proof.to_bytes(), public_values=p.public_values,
               cycles=p.proof.cycles)
    return vk.to_bytes(), job


def _verdict(vk_bytes, job):
    return passed(checks(judge(MIX.source, CONFIG["guarantees"], vk_bytes, [job]), CONFIG["guarantees"], 1))


def test_accepted_as_made(made):
    assert _verdict(*made)


@pytest.mark.parametrize("where", [0.1, 0.5, 0.9])
def test_refused_when_a_byte_changes(made, where):
    vk_bytes, job = made
    b = bytearray(job["proof"])
    b[int(len(b) * where)] ^= 0x01
    assert not _verdict(vk_bytes, dict(job, proof=bytes(b)))


def test_refused_for_another_programs_key(made):
    vk_bytes, job = made
    b = bytearray(vk_bytes)
    b[12] ^= 0x01  # a byte of the preprocessed commitment
    assert not _verdict(bytes(b), job)


@pytest.mark.parametrize("fault", ["stale", "unchanged", "opened_value", "output", "cycles"])
def test_a_broken_timed_path_is_not_correct(fault):
    r = run.run_cell(CELL, CONFIG, MIX, 2**31 + 3, 0.1, False, device="cpu",
                     client=control.FaultyClient(fault, device="cpu"))
    assert r["correct"] is False


def test_a_stale_proof_is_caught_by_its_binding_alone():
    """The previous job's proof beside this job's own output and cycles: it
    verifies and has this job's chip heights, so only the binding of its IO
    and Memory openings to this job's run tells."""
    r = run.run_cell(CELL, CONFIG, MIX, 2**31 + 3, 0.1, False, device="cpu",
                     client=control.FaultyClient("stale", device="cpu"))
    failing = {k for k, c in r["checks"].items() if not passed({k: c})}
    assert failing == {"binding_mismatch"}


def test_another_jobs_proof_is_refused(made):
    """Another job of the guest, with the same chip heights (its stdin
    differs in one byte), judged against this job's stdin."""
    vk_bytes, job = made
    other = bytearray(job["stdin"])
    other[1] = other[1] % 255 + 1  # a painted cell's value: no height moves
    from port_bench.reference import interp

    a, b = interp.run(MIX.source, job["stdin"]), interp.run(MIX.source, bytes(other))
    assert (a.cycles, a.counts, a.touched) == (b.cycles, b.counts, b.touched)
    res = judge(MIX.source, CONFIG["guarantees"], vk_bytes, [dict(job, stdin=bytes(other))])
    assert res["binding_mismatch"] == 1 and res["rejected"] == 0 and res["shape_mismatch"] == 0


def test_judged_in_worker_processes(made):
    vk_bytes, job = made
    b = bytearray(job["proof"])
    b[len(b) // 2] ^= 0x01
    res = judge(MIX.source, CONFIG["guarantees"], vk_bytes, [job, dict(job, proof=bytes(b))], workers=2)
    assert res["judged"] == 2 and res["rejected"] == 1 and res["vk_mismatch"] == 0
    assert res["why"][0].startswith("job 1:")


def test_a_sound_run_is_correct():
    r = run.run_cell(CELL, CONFIG, MIX, 2**31 + 3, 0.1, False, device="cpu")
    assert r["correct"] is True and r["failed"] == 0


def test_the_control_is_not_correct(monkeypatch):
    """The program's own switch below the stated guarantee: 83 queries."""
    monkeypatch.setenv("FRI_QUERIES", str(CONFIG["guarantees"]["num_queries"] - 1))
    r = run.run_cell(CELL, CONFIG, MIX, 2**31 + 3, 0.1, False, device="cpu")
    assert r["correct"] is False
    assert r["checks"]["queries"]["value"] == CONFIG["guarantees"]["num_queries"] - 1


def test_window_holds_whole_jobs():
    r = run.run_cell(CELL, CONFIG, dataclasses.replace(MIX, units=2), 5, 0.1, True, device="cpu")
    assert r["correct"] and r["attempted"] == 1 and r["device"]["window_s"] > 0


@pytest.mark.parametrize("log_n", [4, 9])
def test_evaluation_at_a_point(log_n):
    """A constant column reads its constant, and the column of the domain's
    own points reads the point: at z, and at g z for the next row."""
    import numpy as np

    from port_bench.reference import bind
    from port_bench.reference.stark import ef_host as efh
    from port_bench.reference.stark.field import powers_host, two_adic_root

    n, g = 1 << log_n, two_adic_root(log_n)
    trace = np.stack([np.full(n, 7), powers_host(g, n)], axis=1).astype(np.uint64)
    z = (12345, 678, 9, 1011)
    local, nxt = bind.evaluate(trace, z, True)
    assert local == [(7, 0, 0, 0), z]
    assert nxt == [(7, 0, 0, 0), efh.mul_base(z, g)]
