#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkvm_brainfuck_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. device: the card's name and power limit (nvidia-smi).
2. build: the CUDA kernels (csrc/*.cu, one nvcc each, in parallel) and the
   native guest executor.
3. kernels: each kernel against its plain PyTorch version on the card, on
   the same random inputs at the shapes of the slice (bit-exact: integer
   field arithmetic, tolerance 0), with CUDA-event times (median of 5 after
   a warm-up) and the bound of each launch.
4. golden: the card-path uni-STARK proof of the golden guest at 84 queries
   must equal tests/golden/uni_cpu_<guest>_q84.json (made by the JAX
   package) byte for byte.
5. slice: execute the 2^20 - 1 cycle bench guest, generate its 2^20 x 31 Cpu
   trace, prove at 84 queries, verify, and reject a tampered proof; the
   launch counts of this run must be > 0 for every kernel.
6. profile: a second, warm prove of the same trace under torch.profiler; the
   device busy share (device self time of all kernels and copies over the
   wall time) and the device time by kernel.

The last two lines of standard output are the `kernels` JSON object (its
launch counts are those of the slice phase) and the `ok` JSON object.  A
longer record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

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
}
SOURCES = {
    "ntt_block_stages": "zkvm_brainfuck_tpu_torch/csrc/ntt.cu",
    "ntt_stage": "zkvm_brainfuck_tpu_torch/csrc/ntt.cu",
    "poseidon2_hash_rows": "zkvm_brainfuck_tpu_torch/csrc/poseidon2.cu",
    "poseidon2_permute": "zkvm_brainfuck_tpu_torch/csrc/poseidon2.cu",
}


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
    torch.cuda.synchronize()
    for name, k in kernels.items():
        say(f"[kernels] {name} {k['shape']}: bit-exact; kernel {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, bound {k['bound'][0]:.4f} ms ({k['bound'][1]})")
    say(f"[kernels] ntt 2^21x31 (bit reversal + 1 block + 11 stages): {report['ntt_2^21x31_ms']:.4f} ms")
    return kernels


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
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

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
    say(f"[slice] {rec.num_cycles} cycles, trace {tuple(trace.shape)}, {QUERIES} queries: proved "
        f"and verified; peak device memory {peak / 2**30:.3f} GiB")
    for k in ("execute", "trace_gen", "main_commit", "quotient", "quotient_commit", "pcs_open",
              "open_eval", "reduced_open", "fri_commit", "grind", "query_open", "prove_total",
              "verify"):
        if k in phases:
            say(f"[slice]   {k:16s} {phases[k]:.4f} s")
    say(f"[slice] launches: {counts}")
    return counts, chip, trace


def phase_profile(torch, dev, report, chip, trace):
    """A warm prove of the slice's trace under torch.profiler; device busy
    share = sum of device self times of all kernels over the wall time.  The
    slice phase's prove already filled the twiddle, point and selector caches."""
    from torch.profiler import ProfilerActivity, profile

    from zkvm_brainfuck_tpu_torch.stark.challenger import DuplexChallenger
    from zkvm_brainfuck_tpu_torch.stark.uni import uni_stark_prove

    def prove():
        uni_stark_prove(chip, trace, DuplexChallenger(), num_queries=QUERIES, device=dev)
        torch.cuda.synchronize()

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
    report["profile"] = {"wall_s": wall, "device_busy_ms": busy_ms, "device_events": n_kernels,
                         "top": [{"name": k[:120], "ms": us / 1e3, "count": c} for k, us, c in rows[:25]]}
    if not rows:
        say("[profile] the profiler recorded no device time (busy share not measured)")
        return
    say(f"[profile] warm prove {wall:.4f} s; device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / 1e3 / wall:.2f} % of wall) over {n_kernels} device events")
    for k, us, c in rows[:15]:
        say(f"[profile]   {us / 1e3:9.3f} ms  x{c:5d}  {k[:90]}")


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
    counts, chip, trace = phase_slice(torch, dev, report)
    phase_profile(torch, dev, report, chip, trace)

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
