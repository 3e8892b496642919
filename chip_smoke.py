#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkvm_brainfuck_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. device: the card's name and power limit (nvidia-smi).
2. build: the CUDA kernels (csrc/*.cu, one nvcc each, in parallel) and the
   native guest executor.
3. kernels: each of the six kernels against its plain PyTorch version on the
   card, on the same random inputs at the shapes of the main path (bit-exact:
   integer field arithmetic, tolerance 0), with CUDA-event times (median of
   5 after a warm-up) and the bound of each launch.
4. golden: the card-path uni-STARK proof of the golden guest at 84 queries
   must equal tests/golden/uni_cpu_<guest>_q84.json (made by the JAX
   package) byte for byte.
5. golden main path: ProverClient setup and prove of the `printa` guest at
   84 queries and 16 PoW bits on the card must reproduce the JAX-made
   tests/golden/{vk,proof}_printa_q84.bin and the 1741-entry transcript
   tests/golden/transcript_printa_q84.json byte for byte.
6. uni slice: execute the 2^20 - 1 cycle bench guest, generate its 2^20 x 31
   Cpu trace, uni-STARK prove at 84 queries, verify, and reject a tampered
   proof; the four kernels of that path must have launched.
7. main path: ProverClient setup -> prove -> verify of the same guest over
   all 8 chips at 84 queries and 16 PoW bits; a tampered proof must be
   rejected with a typed error.  The launch counts are set to 0 just before
   setup and read just after verify: every kernel must have launched.  Prints
   each chip's rows and widths, the phase seconds and the peak device memory.
8. profile: a warm main-path prove with the same key, timed alone, then one
   more under torch.profiler: the device busy share (device self time of all
   kernels and copies over the wall time), device time by kernel, and the
   per-prove device ms and launches of each hand-written kernel.

The last two lines of standard output are the `kernels` JSON object (its
launch counts are those of the main path, phase 7) and the `ok` JSON object.
A longer record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Integer multiply rate: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost
# (Hopper white paper).  One modular multiply is counted as ONE such
# operation, so the bound below is a lower bound on its time.
INT_OPS_PER_S = 64 * 132 * 1.98e9
P2_MULS_PER_PERM = 8 * 16 * 2 + 13 * (2 + 16)  # cubes of 8 full rounds; 13 partial rounds
SLICE_LOG = 20
QUERIES = 84

REPLACES = {
    "ntt_block_stages": "zkvm_brainfuck_tpu/ops/ntt_pallas.py:50",
    "ntt_stage": "zkvm_brainfuck_tpu/ops/ntt.py:114",
    "poseidon2_hash_rows": "zkvm_brainfuck_tpu/ops/merkle.py:96",
    "poseidon2_permute": "zkvm_brainfuck_tpu/ops/poseidon2.py:279",
    "logup_entries": "zkvm_brainfuck_tpu/stark/permutation.py:77",
    "logup_scan": "zkvm_brainfuck_tpu/stark/permutation.py:215",
}
SOURCES = {
    "ntt_block_stages": "zkvm_brainfuck_tpu_torch/csrc/ntt.cu",
    "ntt_stage": "zkvm_brainfuck_tpu_torch/csrc/ntt.cu",
    "poseidon2_hash_rows": "zkvm_brainfuck_tpu_torch/csrc/poseidon2.cu",
    "poseidon2_permute": "zkvm_brainfuck_tpu_torch/csrc/poseidon2.cu",
    "logup_entries": "zkvm_brainfuck_tpu_torch/csrc/logup.cu",
    "logup_scan": "zkvm_brainfuck_tpu_torch/csrc/logup.cu",
}
# The device functions of each kernel, as the profiler names them.
DEVICE_FUNCS = {
    "ntt_block_stages": ("block_stages_kernel",),
    "ntt_stage": ("stage_kernel",),
    "poseidon2_hash_rows": ("hash_rows_kernel",),
    "poseidon2_permute": ("permute_kernel",),
    "logup_entries": ("entries_kernel",),
    "logup_scan": ("scan_tiles_kernel", "scan_totals_kernel", "scan_carry_kernel"),
}
UNI_KERNELS = ("ntt_block_stages", "ntt_stage", "poseidon2_hash_rows", "poseidon2_permute")
GOLDEN_QUERIES, GOLDEN_POW_BITS = 84, 16
TRANSCRIPT_SEGMENTS = [("S1 setup", 0, 15), ("S2 main commit", 15, 31), ("S3 LogUp", 31, 67),
                       ("S4 quotient", 67, 79), ("S5 open", 79, 1741)]


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi unavailable"


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median CUDA-event time of `fn` in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, int_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev, report):
    from zkvm_brainfuck_tpu_torch.ops import ntt as nt
    from zkvm_brainfuck_tpu_torch.ops import poseidon2 as p2
    from zkvm_brainfuck_tpu_torch.ops.field import P

    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape):
        return torch.randint(0, P, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    def compare(name, got, want):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0 or got.shape != want.shape:
            raise AssertionError(f"{name}: kernel != plain (max abs err {err})")
        return err

    log_n, w = SLICE_LOG + 1, 31  # the LDE shape: 2^21 x 31
    n = 1 << log_n
    x = rand(n, w)
    tw_f = nt.twiddle_dev(log_n, False, dev)
    tw_i = nt.twiddle_dev(log_n, True, dev)
    kernels = {}

    # ntt_block_stages: the LDE shape, and one height below 1024 rows.
    kb = min(10, log_n)
    err = compare("ntt_block_stages", nt.ntt_block_stages(x, tw_f, kb),
                  nt.ntt_block_stages_plain(x, tw_f, kb))
    small = rand(256, w)
    err = max(err, compare("ntt_block_stages n=256", nt.ntt_block_stages(small, tw_f, 8),
                           nt.ntt_block_stages_plain(small, tw_f, 8)))
    ms = cuda_ms(torch, lambda: nt.ntt_block_stages(x, tw_f, kb))
    plain_ms = cuda_ms(torch, lambda: nt.ntt_block_stages_plain(x, tw_f, kb), reps=3)
    b = bound(2 * n * w * 4 + 4 * ((1 << kb) - 1), kb * (n // 2) * w)
    kernels["ntt_block_stages"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                                       shape=f"({n}, {w}), k={kb}")

    # ntt_stage: the last stage of the 2^21 LDE, and stage 11.
    err = compare("ntt_stage s=21", nt.ntt_stage(x, tw_f, log_n), nt.ntt_stage_plain(x, tw_f, log_n))
    s_lo = min(11, log_n)
    err = max(err, compare(f"ntt_stage s={s_lo}", nt.ntt_stage(x, tw_i, s_lo),
                           nt.ntt_stage_plain(x, tw_i, s_lo)))
    ms = cuda_ms(torch, lambda: nt.ntt_stage(x, tw_f, log_n))
    plain_ms = cuda_ms(torch, lambda: nt.ntt_stage_plain(x, tw_f, log_n), reps=3)
    b = bound(2 * n * w * 4 + 4 * (n // 2), (n // 2) * w)
    kernels["ntt_stage"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                                shape=f"({n}, {w}), s={log_n}")

    # Whole transforms, forward and inverse, kernels against plain stages.
    def plain_ntt(v, ln, tw, inverse):
        k = min(10, ln)
        vb = nt.ntt_block_stages_plain(v.index_select(0, nt.bitrev_dev(ln, dev)), tw, k)
        for s in range(k + 1, ln + 1):
            vb = nt.ntt_stage_plain(vb, tw, s)
        if inverse:
            vb = (vb.to(torch.int64) * pow(1 << ln, P - 2, P) % P).to(torch.int32)
        return vb

    for inverse, tw in ((False, tw_f), (True, tw_i)):
        compare(f"ntt inverse={inverse}", nt.ntt_dev(x, log_n, inverse), plain_ntt(x, log_n, tw, inverse))
    small = rand(512, 3)
    compare("ntt n=512", nt.ntt_dev(small, 9, False), plain_ntt(small, 9, nt.twiddle_dev(9, False, dev), False))
    report["ntt_2^21x31_ms"] = cuda_ms(torch, lambda: nt.ntt_dev(x, log_n, False))

    # poseidon2_hash_rows: the main commit's digest layer (bit-reversed).
    err = compare("poseidon2_hash_rows", p2.hash_rows(x, bitrev=True), p2.hash_rows_plain([x], bitrev=True))
    q = [rand(n, 4), rand(n, 4)]
    err = max(err, compare("poseidon2_hash_rows 2x4", p2.hash_rows(q, bitrev=True),
                           p2.hash_rows_plain(q, bitrev=True)))
    ms = cuda_ms(torch, lambda: p2.hash_rows(x, bitrev=True))
    plain_ms = cuda_ms(torch, lambda: p2.hash_rows_plain([x], bitrev=True), reps=3)
    b = bound(n * w * 4 + n * 8 * 4, n * ((w + 7) // 8) * P2_MULS_PER_PERM)
    kernels["poseidon2_hash_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                                          shape=f"({n}, {w}) -> ({n}, 8)")

    # poseidon2_permute: the first tree level of a 2^21-leaf tree.
    states = rand(n // 2, 16)
    err = compare("poseidon2_permute", p2.permute(states, out_cols=8), p2.permute_plain(states)[:, :8])
    err = max(err, compare("poseidon2_permute 16", p2.permute(states), p2.permute_plain(states)))
    ms = cuda_ms(torch, lambda: p2.permute(states, out_cols=8))
    plain_ms = cuda_ms(torch, lambda: p2.permute_plain(states)[:, :8].contiguous(), reps=3)
    b = bound((n // 2) * (16 + 8) * 4, (n // 2) * P2_MULS_PER_PERM)
    kernels["poseidon2_permute"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                                        shape=f"({n // 2}, 16) -> ({n // 2}, 8)")
    logup_kernels(torch, dev, rand, compare, kernels)
    torch.cuda.synchronize()
    for name, k in kernels.items():
        say(f"[kernels] {name} {k['shape']}: bit-exact; kernel {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, bound {k['bound'][0]:.4f} ms ({k['bound'][1]})")
    say(f"[kernels] ntt 2^21x31 (bit reversal + 1 block + 11 stages): {report['ntt_2^21x31_ms']:.4f} ms")
    return kernels


def logup_mults_per_row(table) -> int:
    """Modular multiplies per row of logup_entries, from the chip's
    interaction table (each counted as one integer operation): the affine
    terms and beta products of every fingerprint, 4 conversions to
    Montgomery form per denominator, the prefix products, one EF4 inverse
    (3 Frobenius scales x 3, 2 EF4 products, the norm, a 61-step Fermat
    power, 4 scales), the unwind (2 EF4 products per interaction) and the
    4 products of each term."""
    n = table.n_inter
    per = 0
    for lk, _send in table.interactions:
        per += sum(len(a.terms) + 4 for a in lk.values) + len(lk.multiplicity.terms) + 4
    einv = 3 + 8 + 2 * 16 + 4 + 61 + 4
    return per + 16 * (n - 1) + einv + 2 * 16 * (n - 1) + 4 * n


def logup_kernels(torch, dev, rand, compare, kernels):
    """logup_entries and logup_scan against their plain versions: the Cpu
    chip at 2^20 rows (16 interactions, 31 columns), the Byte chip at 2^16
    rows with its 2 preprocessed columns, and a Cpu height below one block
    of either kernel; random traces and challenges from a numpy seed."""
    import numpy as np

    from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu_torch.ops import logup as lu
    from zkvm_brainfuck_tpu_torch.ops.field import P
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.permutation import host_beta_pows, logup_table

    rng = np.random.default_rng(20)
    chips = {a.name: Chip(a) for a in brainfuck_chips()}
    cases = []
    for name, n in (("Cpu", 1 << SLICE_LOG), ("Byte", 1 << 16), ("Cpu", 100)):
        chip = chips[name]
        table = logup_table(chip)
        main = rand(n, chip.width)
        prep = rand(n, chip.preprocessed_width) if chip.preprocessed_width else None
        beta = tuple(int(x) for x in rng.integers(0, P, 4))
        chal = lu.challenge_matrix(rng.integers(0, P, 4), host_beta_pows(chip, beta), dev)
        cases.append((name, n, table, main, prep, chal))
    err_e = err_s = 0
    for name, n, table, main, prep, chal in cases:
        got = lu.logup_entries(table, main, prep, chal)
        want = lu.logup_entries_plain(table, main, prep, chal)
        err_e = max(err_e, compare(f"logup_entries {name} n={n}", got, want))
        csum = lu.logup_scan(got)
        want_csum = lu.logup_scan_plain(want)
        err_s = max(err_s, compare(f"logup_scan {name} n={n}", got, want),
                    compare(f"logup_scan csum {name} n={n}", csum, want_csum))
    name, n, table, main, prep, chal = cases[0]
    nb1 = table.nb + 1
    ms = cuda_ms(torch, lambda: lu.logup_entries(table, main, prep, chal))
    plain_ms = cuda_ms(torch, lambda: lu.logup_entries_plain(table, main, prep, chal), reps=3)
    b = bound(n * main.shape[1] * 4 + n * nb1 * 16, n * logup_mults_per_row(table))
    kernels["logup_entries"] = dict(max_abs_err=err_e, ms=ms, plain_ms=plain_ms, bound=b,
                                    shape=f"Cpu ({n}, {main.shape[1]}), I={table.n_inter}, "
                                          f"NB={table.nb} -> ({n}, {nb1}, 4)")
    perm = lu.logup_entries(table, main, prep, chal)
    ms = cuda_ms(torch, lambda: lu.logup_scan(perm))
    plain_ms = cuda_ms(torch, lambda: lu.logup_scan_plain(perm), reps=3)
    b = bound(2 * n * 16, n * 4)
    kernels["logup_scan"] = dict(max_abs_err=err_s, ms=ms, plain_ms=plain_ms, bound=b,
                                 shape=f"({n}, {nb1}, 4), column {table.nb}")


def phase_golden(torch, dev, report):
    from zkvm_brainfuck_tpu_torch import convert, guests
    from zkvm_brainfuck_tpu_torch.core.executor import execute
    from zkvm_brainfuck_tpu_torch.core.program import Program
    from zkvm_brainfuck_tpu_torch.models.base import ByteDeps
    from zkvm_brainfuck_tpu_torch.models.cpu import CpuChip
    from zkvm_brainfuck_tpu_torch.stark.challenger import DuplexChallenger
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.uni import uni_stark_prove, uni_stark_verify

    path = os.path.join(ROOT, "tests", "golden",
                        f"uni_cpu_{guests.GOLDEN_NAME}_q{guests.GOLDEN_QUERIES}.json")
    with open(path) as fh:
        golden = fh.read()
    rec = execute(Program.from_source(guests.GOLDEN_SOURCE), guests.GOLDEN_INPUT)
    chip = Chip(CpuChip())
    trace = chip.air.generate_trace(rec, ByteDeps(), device=dev)
    t0 = time.time()
    proof = uni_stark_prove(chip, trace, DuplexChallenger(), num_queries=guests.GOLDEN_QUERIES,
                            device=dev)
    secs = time.time() - t0
    text = convert.uni_proof_to_json(proof)
    if text != golden:
        raise AssertionError(f"card-path proof differs from {os.path.relpath(path, ROOT)}")
    uni_stark_verify(chip, proof, DuplexChallenger(), num_queries=guests.GOLDEN_QUERIES)
    report["golden"] = {"fixture": os.path.relpath(path, ROOT), "trace": list(trace.shape),
                        "prove_s": secs, "bytes": len(text)}
    say(f"[golden] {tuple(trace.shape)} proof at {guests.GOLDEN_QUERIES} queries equals "
        f"{os.path.relpath(path, ROOT)} byte for byte ({len(text)} bytes; prove {secs:.2f} s)")


def phase_slice(torch, dev, report):
    from zkvm_brainfuck_tpu_torch import convert, guests
    from zkvm_brainfuck_tpu_torch.core.executor import execute
    from zkvm_brainfuck_tpu_torch.core.program import Program
    from zkvm_brainfuck_tpu_torch.models.base import ByteDeps
    from zkvm_brainfuck_tpu_torch.models.cpu import CpuChip
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn
    from zkvm_brainfuck_tpu_torch.stark.challenger import DuplexChallenger
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.errors import VerificationFailure
    from zkvm_brainfuck_tpu_torch.stark.uni import uni_stark_prove, uni_stark_verify

    chip = Chip(CpuChip())
    program = Program.from_source(guests.bench_guest(SLICE_LOG))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kn.reset_counts()
    phases = {}
    t0 = time.time()
    rec = execute(program, b"")
    phases["execute"] = time.time() - t0
    t0 = time.time()
    trace = chip.air.generate_trace(rec, ByteDeps(), device=dev)
    torch.cuda.synchronize()
    phases["trace_gen"] = time.time() - t0
    t0 = time.time()
    proof = uni_stark_prove(chip, trace, DuplexChallenger(), num_queries=QUERIES, device=dev,
                            timings=phases)
    torch.cuda.synchronize()
    phases["prove_total"] = time.time() - t0
    counts = dict(kn.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.time()
    uni_stark_verify(chip, proof, DuplexChallenger(), num_queries=QUERIES)
    phases["verify"] = time.time() - t0

    assert rec.num_cycles == (1 << SLICE_LOG) - 1, rec.num_cycles
    assert tuple(trace.shape) == (1 << SLICE_LOG, 31) and proof.log_degree == SLICE_LOG
    assert len(proof.pcs_proof.query_input_openings) == QUERIES
    missing = [k for k in UNI_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the uni slice's path: {missing}")

    bad = convert.uni_proof_from_json(convert.uni_proof_to_json(proof))
    v = bad.main_local[0]
    bad.main_local[0] = ((v[0] + 1) % 0x7F000001,) + tuple(v[1:])
    try:
        uni_stark_verify(chip, bad, DuplexChallenger(), num_queries=QUERIES)
    except VerificationFailure as e:
        say(f"[slice] tampered proof rejected: {type(e).__name__}: {e}")
    else:
        raise AssertionError("a tampered proof was accepted")

    report["slice"] = {"cycles": rec.num_cycles, "trace": list(trace.shape), "queries": QUERIES,
                       "phases_s": phases, "peak_bytes": peak, "launches": counts}
    say(f"[slice] uni-STARK: {rec.num_cycles} cycles, trace {tuple(trace.shape)}, {QUERIES} queries: proved "
        f"and verified; peak device memory {peak / 2**30:.3f} GiB")
    for k in ("execute", "trace_gen", "main_commit", "quotient", "quotient_commit", "pcs_open",
              "open_eval", "reduced_open", "fri_commit", "grind", "query_open", "prove_total",
              "verify"):
        if k in phases:
            say(f"[slice]   {k:16s} {phases[k]:.4f} s")
    say(f"[slice] launches: {counts}")


def recording_config():
    """The production config (84 queries, 16 PoW bits) whose challengers
    record their observe/sample stream."""
    from zkvm_brainfuck_tpu_torch.stark.config import FriConfig, KoalaBearPoseidon2

    class RecordingConfig(KoalaBearPoseidon2):
        def __init__(self):
            super().__init__(FriConfig(log_blowup=1, num_queries=GOLDEN_QUERIES,
                                       proof_of_work_bits=GOLDEN_POW_BITS))
            self.challengers = []

        def challenger(self):
            ch = super().challenger()
            ch.start_recording()
            self.challengers.append(ch)
            return ch

    return RecordingConfig()


def phase_golden_main(torch, dev, report):
    from zkvm_brainfuck_tpu_torch import ProverClient, guests
    from zkvm_brainfuck_tpu_torch.sdk import CpuProver

    golden_dir = os.path.join(ROOT, "tests", "golden")

    def read(name, mode="rb"):
        with open(os.path.join(golden_dir, name), mode) as fh:
            return fh.read()

    config = recording_config()
    client = ProverClient(CpuProver(config=config))
    t0 = time.time()
    pk, vk = client.setup(guests.PRINTA_BF)
    proof = client.prove(pk, b"").run()
    secs = time.time() - t0
    if vk.to_bytes() != read("vk_printa_q84.bin"):
        raise AssertionError("card-path vk differs from tests/golden/vk_printa_q84.bin")
    want = json.loads(read("transcript_printa_q84.json", "r"))["transcript"]
    got = config.challengers[0].record
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None if len(got) == len(want) else min(len(got), len(want)))
    if first is not None:
        where = next((n for n, lo, hi in TRANSCRIPT_SEGMENTS if lo <= first < hi), "beyond S5")
        raise AssertionError(f"card-path transcript differs first at entry {first} ({where})")
    data = proof.proof.proof.to_bytes()
    if data != read("proof_printa_q84.bin"):
        raise AssertionError("card-path proof differs from tests/golden/proof_printa_q84.bin")
    client.verify(proof, vk)
    report["golden_main"] = {"guest": "printa", "setup_and_prove_s": secs, "proof_bytes": len(data),
                             "transcript_entries": len(got)}
    say(f"[golden-main] printa at {GOLDEN_QUERIES} queries / {GOLDEN_POW_BITS} PoW bits: vk, "
        f"{len(got)} transcript entries and {len(data)} proof bytes equal tests/golden/*_printa_q84 "
        f"(setup + prove {secs:.2f} s)")


def phase_main(torch, dev, report):
    """ProverClient setup -> prove -> verify of the 2^20 - 1 cycle guest."""
    from zkvm_brainfuck_tpu_torch import ProverClient, guests
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn
    from zkvm_brainfuck_tpu_torch.stark.errors import VerificationFailure
    from zkvm_brainfuck_tpu_torch.stark.types import MachineProof

    src = guests.bench_guest(SLICE_LOG)
    client = ProverClient()
    fri = client.prover.prover.config.fri
    assert (fri.num_queries, fri.proof_of_work_bits) == (QUERIES, GOLDEN_POW_BITS), fri
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kn.reset_counts()
    t0 = time.time()
    pk, vk = client.setup(src)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    after_setup = dict(kn.COUNTS)
    proof = client.prove(pk, b"").run()
    torch.cuda.synchronize()
    t0 = time.time()
    client.verify(proof, vk)
    verify_s = time.time() - t0
    counts = dict(kn.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    sp = proof.proof.proof.shard_proof
    assert proof.proof.cycles == (1 << SLICE_LOG) - 1, proof.proof.cycles
    assert sp.opened_values[sp.chip_ordering["Cpu"]].log_degree == SLICE_LOG
    assert len(sp.opening_proof.query_input_openings) == QUERIES

    data = proof.proof.proof.to_bytes()
    bad = copy.copy(proof)
    bad.proof = copy.copy(proof.proof)
    bad.proof.proof = MachineProof.from_bytes(data)
    c = bad.proof.proof.shard_proof.opened_values[0].cumulative_sum
    bad.proof.proof.shard_proof.opened_values[0].cumulative_sum = ((c[0] + 1) % 0x7F000001,) + c[1:]
    try:
        client.verify(bad, vk)
    except VerificationFailure as e:
        if type(e) is VerificationFailure:
            raise AssertionError("a tampered proof was rejected without a typed error")
        say(f"[main] tampered proof rejected: {type(e).__name__}: {e}")
    else:
        raise AssertionError("a tampered proof was accepted")

    phases = dict(proof.proof.timings, setup=setup_s, verify=verify_s)
    chips = []
    for name, i in sorted(sp.chip_ordering.items(), key=lambda kv: kv[1]):
        v = sp.opened_values[i]
        chips.append({"chip": name, "rows": 1 << v.log_degree, "main": len(v.main.local),
                      "preprocessed": len(v.preprocessed.local),
                      "permutation": len(v.permutation.local)})
    prove_counts = {k: counts[k] - after_setup[k] for k in counts}
    report["main"] = {"cycles": proof.proof.cycles, "queries": QUERIES, "pow_bits": GOLDEN_POW_BITS,
                      "phases_s": phases, "peak_bytes": peak, "launches": counts,
                      "launches_prove": prove_counts, "chips": chips,
                      "proof_bytes": len(data)}
    say(f"[main] {proof.proof.cycles} cycles, {len(chips)} chips, {QUERIES} queries, "
        f"{GOLDEN_POW_BITS} PoW bits: setup, prove and verify through ProverClient; peak device "
        f"memory {peak / 2**30:.3f} GiB")
    for ch in chips:
        say(f"[main]   {ch['chip']:12s} rows {ch['rows']:8d}  main {ch['main']:3d}  "
            f"preprocessed {ch['preprocessed']:2d}  permutation {ch['permutation']:3d}")
    for k in ("setup", "execute", "trace_gen", "main_commit", "perm_trace", "perm_commit",
              "quotient", "quotient_commit", "pcs_open_total", "open_eval", "reduced_open",
              "fri_commit", "grind", "query_open", "prove_total", "verify"):
        if k in phases:
            say(f"[main]   {k:16s} {phases[k]:.4f} s")
    say(f"[main] launches (setup + prove): {counts}")
    say(f"[main] launches (prove): {prove_counts}")
    return counts, client, pk


def phase_profile(torch, dev, report, client, pk):
    """A warm main-path prove with the same key under torch.profiler; device
    busy share = sum of device self times of all kernels over the wall time."""
    from torch.profiler import ProfilerActivity, profile

    def prove():
        out = client.prove(pk, b"").run()
        torch.cuda.synchronize()
        return out

    t0 = time.time()
    warm_phases = prove().proof.timings
    warm = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        prove()
        wall = time.time() - t0

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    # Only the device-side events (kernels, copies): an aten op's own row
    # repeats the device time of the kernels it launched.
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(
        ((e.key, dev_us(e), int(e.count)) for e in prof.key_averages()
         if getattr(e, "device_type", None) == cuda and dev_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows) / 1e3
    n_kernels = sum(r[2] for r in rows)

    def func_name(key):
        """'void (anonymous namespace)::stage_kernel(int const*, ...)' -> 'stage_kernel'."""
        head = key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
        words = head.split("::")[-1].split()
        return words[-1] if words else ""

    ours = {}
    for name, funcs in DEVICE_FUNCS.items():
        hit = [r for r in rows if func_name(r[0]) in funcs]
        ours[name] = {"device_ms": sum(r[1] for r in hit) / 1e3,
                      "device_launches": sum(r[2] for r in hit)}
    report["profile"] = {"warm_s": warm, "warm_phases_s": warm_phases, "wall_s": wall,
                         "device_busy_ms": busy_ms, "device_events": n_kernels,
                         "kernels": ours,
                         "top": [{"name": k[:120], "ms": us / 1e3, "count": c} for k, us, c in rows[:30]]}
    if not rows:
        say("[profile] the profiler recorded no device time (busy share not measured)")
        return
    say(f"[profile] warm main-path prove {warm:.4f} s without the profiler, {wall:.4f} s under it; "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / 1e3 / wall:.2f} % of the profiled wall, "
        f"{100 * busy_ms / 1e3 / warm:.2f} % of the unprofiled one) over {n_kernels} device events")
    say("[profile] warm prove phases (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in warm_phases.items()))
    for k, us, c in rows[:20]:
        say(f"[profile]   {us / 1e3:9.3f} ms  x{c:5d}  {k[:90]}")
    for name, v in ours.items():
        say(f"[profile] {name:20s} {v['device_ms']:9.3f} ms per prove over "
            f"{v['device_launches']} device launches")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from zkvm_brainfuck_tpu_torch import build

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    report = {"device": kind, "nvidia_smi": smi}

    t0 = time.time()
    build.build_all(verbose=True)
    report["build_s"] = time.time() - t0
    say(f"[build] kernels + executor built in {report['build_s']:.1f} s")

    kernels = phase_kernels(torch, dev, report)
    phase_golden(torch, dev, report)
    phase_golden_main(torch, dev, report)
    phase_slice(torch, dev, report)
    counts, client, pk = phase_main(torch, dev, report)
    phase_profile(torch, dev, report, client, pk)

    line = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": counts[name],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1],
            "library_ms": None,
        }
        for name, k in kernels.items()
    ]}
    report["kernels"] = line["kernels"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    say(smi)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
