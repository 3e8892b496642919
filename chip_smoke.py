#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkvm_brainfuck_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. device: the card's name and power limit (nvidia-smi).
2. build: the CUDA kernels (csrc/*.cu, one nvcc each, in parallel) and the
   native guest executor.
3. kernels: each of the nine kernels against its plain PyTorch version on
   the card, on the same random inputs at the shapes of the main path
   (bit-exact: integer field arithmetic, tolerance 0), with CUDA-event times
   (median of 5 after a warm-up) and the bound of each launch.  The LogUp
   kernel computes the running sum too (the TPU's separate scan, an entry
   of its own in the kernels line with "fused_into"): it is held against
   logup_entries_plain + logup_scan_plain over the whole trace and the
   cumulative sum, and the running sum is timed beside torch.cumsum.  The
   opening kernels (open_eval, ro_accum; their column products on the int8
   tensor cores) are held at the main path's largest opening unit, random
   and with every word p - 1 or p - 2, at single members of widths 1, 2, 8
   and 9 (one of 2^24 rows, so that each block flushes its 32-bit sums),
   at units on a shifted and on a source domain at a shard's rows, at
   members 4 bytes past a 16-byte boundary, at a unit too wide for tiles
   of 64 rows and at a unit of more members than one launch takes; their
   registers, spills
   and the IMMA instructions of their SASS (cuobjdump) are printed, and
   there must be IMMA instructions.
   The quotient (one kernel a chip, generated from the chip's constraints)
   is held for all 8 chips at the main path's coset heights on a whole LDE,
   in 8-column blocks and at a mesh shard's rows with a halo, at the edges
   of its tiles of rows (QUOTIENT_TILE_CASES), and for the Cpu chip without
   LogUp (the uni-STARK's); each chip's kernel is timed alone (its
   launches queued behind a sleep) and with the wrapper's host work, beside
   the bound of what the function needs and the bound counting conversions
   at load, with its registers and blocks an SM; ptxas's registers and
   spills of each generated kernel are printed from the build.
4. golden: the card-path uni-STARK proof of the golden guest at 84 queries
   must equal tests/golden/uni_cpu_<guest>_q84.json (made by the JAX
   package) byte for byte.
5. golden main path: ProverClient setup and prove of the `printa` guest at
   84 queries and 16 PoW bits on the card must reproduce the JAX-made
   tests/golden/{vk,proof}_printa_q84.bin and the 1741-entry transcript
   tests/golden/transcript_printa_q84.json byte for byte.
6. uni slice: execute the 2^20 - 1 cycle bench guest, generate its 2^20 x 31
   Cpu trace, uni-STARK prove at 84 queries, verify, and reject a tampered
   proof; the seven kernels of that path must have launched.
7. main path: ProverClient setup -> prove -> verify of the same guest over
   all 8 chips at 84 queries and 16 PoW bits; a tampered proof must be
   rejected with a typed error.  The launch counts are set to 0 just before
   setup and read just after verify: every kernel must have launched.  Prints
   each chip's rows and widths, the phase seconds and the peak device memory.
   A second, untimed prove records the shapes of each kernel's launches
   (for the per-prove bounds), of the LDEs and of the NTT tables they read;
   the NTT launches must be those the LDE shapes require, the tree walk
   must be one call for each commit the proof holds (main, permutation,
   quotient and one per FRI commit phase), LogUp one launch a chip, each
   after a clear of its scratch, and the opening rounds one open_eval
   launch (after a clear of its scratch) a unit and one ro_accum launch a
   reduced-opening sub-unit.
8. lde: the CUDA-event time of those LDEs back to back, against their
   bound; one LDE under torch.profiler must run the two NTT kernels only.
9. profile: a warm main-path prove with the same key, timed alone, then one
   more under torch.profiler: the device busy share (device self time of all
   kernels and copies over the wall time), device time by kernel, and the
   per-prove device ms and launches of each hand-written kernel; the tree
   walk may take at most 2 device launches a commit.
10. debug: a BF_DEBUG=1 prove of the 2^19 - 1 cycle bench guest (at 2^20
   the host replay takes over a minute): the replay, which checks every chip's
   permutation trace from the fused LogUp kernel row by row, must pass;
   then a corrupted cell of the Cpu main trace and a corrupted row of the
   Cpu running sum must each make it raise.
11. profile trace: a `printa` prove with ZKBF_PROFILE set must write a
   torch.profiler trace that names the fused LogUp kernel.
12. lowmem: the `printa` golden vk, transcript and proof reproduced on the
   card in the low-memory mode with every LDE in 4-column blocks
   (ZKBF_LOWMEM=1, ZKBF_BLK_LOG=4, ZKBF_BLK_W=4); every kernel must launch
   on that path.
13. scale: the 2^22 - 1 cycle bench guest proved twice with one key, by
   default (the low-memory mode, as the JAX package runs it at that size)
   and with ZKBF_LOWMEM=0; both verify and give the same bytes.  For each:
   launches, peak device memory, phase seconds and the peak at the end of
   each phase.  And the host seconds of a cold bit_reversal_perm(23).
14. mesh: proving over a row mesh (zkvm_brainfuck_tpu_torch/parallel/): the
   cards present if there are at least two (a power of two), else a virtual
   mesh of 4 x cuda:0.  `printa` under the mesh, by default and with
   ZKBF_LOWMEM=1, ZKBF_BLK_LOG=4, ZKBF_BLK_W=4, must reproduce the golden
   vk, transcript and proof.  Then the 2^20 - 1 and the 2^22 - 1 cycle
   guests, each set up and proved under the mesh with the default settings
   (at 2^22 the low-memory main, permutation and quotient rounds with
   8-column blocks), must give the main phase's and the scale phase's
   default vk and proof bytes, verify, and reject a tampered proof.  For
   each, the launch counts are set to 0 just before the setup and read
   after the verify: all eight kernels must launch, and the 4-step NTT's
   local transform (ntt_block_stages + ntt_stage) must run on every shard;
   the traces, the kept LDEs or evals, every LDE block made, the leaf
   digests, the permutation traces and the quotient values must hold at
   most 1.01/d of their rows a shard.  Prints the phase seconds beside the
   single-device prove's, the peak at the end of each phase, the
   collective bytes of a prove by kind, the shard fractions and the peak
   device memory.

The last two lines of standard output are the `kernels` JSON object (its
launch counts are those of the main path, phase 7) and the `ok` JSON object.
A longer record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Products of one EF4 inverse through the norm: 8 Frobenius scales by
# constants, 2 EF4 products, the norm's 4, the Fermat power p - 2 =
# (2^6 - 1) * 2^25 + 2^24 - 1 by an addition chain of 48 squarings and 6
# products, and 4 scales.
EF4_INV_MULS = 8 + 2 * 16 + 4 + 48 + 6 + 4
# Integer instruction rate: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost (Hopper
# white paper).  The operation bounds count the integer instructions of the
# field operations that each function needs at the least, not those that
# the kernels happen to run: a modular multiply (Montgomery: the 32x32->64
# product, the reduction's multiply and multiply-add, a compare and a
# select) as MUL_INSTR, a modular addition, subtraction, doubling or halving
# (add, compare, select) as ADD_INSTR.  Both are estimates, not read from
# the SASS.
INT_OPS_PER_S = 64 * 132 * 1.98e9
MUL_INSTR, ADD_INSTR = 5, 2
# The int8 tensor cores: 1,979 dense TOP/s (NVIDIA's H100 SXM data sheet).  A
# product of two canonical (4-byte) values is 16 byte products of 2
# operations each (a multiply and an add), which the tensor cores sum
# exactly in 32 bits (csrc/openings.cu).
IMMA_OPS_PER_S = 1.979e15
IMMA_OPS_PER_PRODUCT = 16 * 2
# Poseidon2, width 16: the fewest field operations of one permutation.
# - An external linear layer: 4 products by the 4x4 matrix (Plonky3's
#   apply_mat4: 9 additions and 2 doublings each), then 4 column sums of 3
#   additions and 16 additions of them: 72 additions.
# - A full round: 16 constant additions and 16 cubes (2 products each).
# - A partial round: 1 constant addition, 1 cube, the 15-addition lane sum and
#   sum + d_i * x_i for the internal diagonal d = [-2, 1, 2, 1/2, 3, 4, -1/2,
#   -3, -4, 2^-8, 2^-3, 2^-24, -2^-8, -2^-3, -2^-4, -2^-24]: 1 operation for
#   d = 1, 2 for +-2 and +-1/2 (a doubling or halving, then the sum), 3 for
#   +-3 and +-4, and a product and an addition for each of the 7 powers
#   2^-k: 28 additions and 7 products.
# 9 external layers (the initial one and 8 full rounds), 13 partial rounds.
P2_MULS_PER_PERM = 8 * 16 * 2 + 13 * (2 + 7)
P2_ADDS_PER_PERM = 9 * 72 + 8 * 16 + 13 * (1 + 15 + 28)
P2_INSTR_PER_PERM = P2_MULS_PER_PERM * MUL_INSTR + P2_ADDS_PER_PERM * ADD_INSTR
SLICE_LOG = 20
QUERIES = 84

REPLACES = {
    "ntt_block_stages": "zkvm_brainfuck_tpu/ops/ntt_pallas.py:50",
    "ntt_stage": "zkvm_brainfuck_tpu/ops/ntt.py:114",
    "poseidon2_hash_rows": "zkvm_brainfuck_tpu/ops/merkle.py:96",
    "poseidon2_tree": "zkvm_brainfuck_tpu/ops/merkle.py:151",
    "poseidon2_permute": "zkvm_brainfuck_tpu/ops/poseidon2.py:279",
    "logup_entries": "zkvm_brainfuck_tpu/stark/permutation.py:77",
    "logup_scan": "zkvm_brainfuck_tpu/stark/permutation.py:215",
    "open_eval": "zkvm_brainfuck_tpu/stark/pcs.py:467",
    "ro_accum": "zkvm_brainfuck_tpu/stark/pcs.py:542",
    "quotient_eval": "zkvm_brainfuck_tpu/stark/quotient.py:94",
}
# Functions that have no kernel of their own: {function: the kernel that
# computes it}.  They keep an entry in the kernels line.
FUSED = {"logup_scan": "logup_entries"}
SOURCES = {
    "ntt_block_stages": "zkvm_brainfuck_tpu_torch/csrc/ntt.cu",
    "ntt_stage": "zkvm_brainfuck_tpu_torch/csrc/ntt.cu",
    "poseidon2_hash_rows": "zkvm_brainfuck_tpu_torch/csrc/poseidon2.cu",
    "poseidon2_tree": "zkvm_brainfuck_tpu_torch/csrc/poseidon2.cu",
    "poseidon2_permute": "zkvm_brainfuck_tpu_torch/csrc/poseidon2.cu",
    "logup_entries": "zkvm_brainfuck_tpu_torch/csrc/logup.cu",
    "logup_scan": "zkvm_brainfuck_tpu_torch/csrc/logup.cu",
    "open_eval": "zkvm_brainfuck_tpu_torch/csrc/openings.cu",
    "ro_accum": "zkvm_brainfuck_tpu_torch/csrc/openings.cu",
    "quotient_eval": "zkvm_brainfuck_tpu_torch/csrc/quotient.cuh",
}
# The device functions of each kernel, as the profiler names them.
DEVICE_FUNCS = {
    "ntt_block_stages": ("block_stages_kernel",),
    "ntt_stage": ("stage_kernel",),
    "poseidon2_hash_rows": ("hash_rows_kernel",),
    "poseidon2_tree": ("bulk_kernel", "tree_kernel"),
    "poseidon2_permute": ("permute_kernel",),
    "logup_entries": ("entries_kernel",),
    "open_eval": ("open_eval_kernel",),
    "ro_accum": ("ro_accum_kernel",),
    "quotient_eval": ("quotient_kernel",),
}
UNI_KERNELS = ("ntt_block_stages", "ntt_stage", "poseidon2_hash_rows", "poseidon2_tree",
               "poseidon2_permute", "open_eval", "ro_accum", "quotient_eval")
# The main path's largest opening unit: its 2^21-row LDEs opened at zeta,
# in round order (the AddSub and Cpu main traces, their permutation traces,
# and two 4-column quotient chunks of each).
OPEN_UNIT_LOG, OPEN_UNIT_WIDTHS = SLICE_LOG + 1, (7, 31, 16, 36, 4, 4, 4, 4)
# The main path's quotient launches: the coset rows of each chip at 2^20
# (twice its trace rows, PERF.md section 4).
QUOTIENT_LOG = {"Cpu": 21, "AddSub": 21, "Jump": 20, "Program": 18, "Byte": 17,
                "MemoryInstrs": 13, "IO": 5, "Memory": 5}
# The opening kernels' cases (opening_kernels): name -> (log_m, domain, row0,
# rows, member widths, every member word, or "offset" for random words in a
# tensor that starts 4 bytes past a 16-byte boundary, or None); the
# domain's shift is GENERATOR for "lde", 7 GENERATOR for "shifted", 1 for
# "source" and "one".  64 and 32 rows are the kernels' tiles; a block of
# open_eval flushes its 32-bit sums after 8,192 rows.
OPENING_CASES = {
    "largest unit": (OPEN_UNIT_LOG, "lde", 0, 1 << OPEN_UNIT_LOG, OPEN_UNIT_WIDTHS, None),
    "largest unit, every word p - 1": (OPEN_UNIT_LOG, "lde", 0, 1 << OPEN_UNIT_LOG,
                                       OPEN_UNIT_WIDTHS, "p-1"),
    "largest unit, every word p - 2": (OPEN_UNIT_LOG, "lde", 0, 1 << OPEN_UNIT_LOG,
                                       OPEN_UNIT_WIDTHS, "p-2"),
    "width 1, 8,193 rows": (14, "lde", 0, 8193, (1,), None),
    "width 2, 2^24 rows of p - 2 (blocks take over 128 tiles: a flush)": (24, "lde", 0, 1 << 24,
                                                                          (2,), "p-2"),
    "width 8, 1,000 rows": (10, "lde", 0, 1000, (8,), None),
    "width 9, 1,000 rows at row0 24": (10, "lde", 24, 1000, (9,), None),
    "odd widths, shard rows": (9, "shifted", 128, 64, (3, 5, 1), None),
    "301 rows, members 4 bytes past a 16-byte boundary (4-byte copies)": (9, "shifted", 0, 301,
                                                                           (3, 5, 4), "offset"),
    "source domain, a quarter shard's rows": (SLICE_LOG, "source", 1 << 18, 1 << 18, (31, 36), None),
    "18 members": (7, "one", 0, 128, tuple(1 + k % 3 for k in range(18)), None),
    "16 members of 30 columns (too wide for tiles of 64 rows: tiles of 32)": (12, "one", 0, 4000,
                                                                             (30,) * 16, None),
}
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


def bound(bytes_moved: float, int_ops: float, tensor_ops: float = 0):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM rate
    and the operations' time, integer instructions on the INT32 lanes plus
    tensor-core operations at the int8 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (int_ops / INT_OPS_PER_S + tensor_ops / IMMA_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stages_instr(n: int, w: int, first: int, last: int) -> int:
    """Integer instructions of NTT stages first..last over n rows x w
    columns: n/2 butterflies a stage and column, two modular additions
    each, and a product unless the twiddle is 1 (n/2^s of them at stage s)."""
    muls = sum((n >> 1) - (n >> s) for s in range(first, last + 1)) * w
    return muls * MUL_INSTR + (last - first + 1) * (n >> 1) * w * 2 * ADD_INSTR


def block_pass_instr(m: int, w: int, log_n: int, k: int, scaled: bool) -> int:
    """ntt_block_stages on m nonzero input rows of 2^log_n: while the rows
    that bit reversal pairs are all zero a stage only copies (the first
    log_n - ceil(log2 m) stages), and a scaled coefficient is one product by
    a factor kept in Montgomery form."""
    copies = min(k, log_n - (m - 1).bit_length())
    return stages_instr(1 << log_n, w, copies + 1, k) + (m * w * MUL_INSTR if scaled else 0)


def launch_bounds():
    """{kernel: (module, wrapper name, bound of one launch from the wrapper's
    arguments)}: each input read once, each output written once, and the
    integer instructions of the field operations these inputs need on the
    INT32 lanes, plus, for the opening kernels, their column products at
    the int8 tensor-core rate."""
    import torch

    from zkvm_brainfuck_tpu_torch.ops import logup as lu
    from zkvm_brainfuck_tpu_torch.ops import merkle as mk
    from zkvm_brainfuck_tpu_torch.ops import ntt as nt
    from zkvm_brainfuck_tpu_torch.ops import openings as op
    from zkvm_brainfuck_tpu_torch.ops import poseidon2 as p2
    from zkvm_brainfuck_tpu_torch.ops import quotient as oq

    def block_stages(x, log_n, k, inverse=False, factors=None):
        m, w = x.shape
        scale = 0 if factors is None else m * 4
        return bound(m * w * 4 + (w << log_n) * 4 + scale + 4 * ((1 << k) - 1),
                     block_pass_instr(m, w, log_n, k, factors is not None))

    def stage(x, first, last, inverse=False):
        n, w = x.shape
        return bound(2 * n * w * 4, stages_instr(n, w, first, last))

    def hash_rows(mats, bitrev=False):
        mats = [mats] if isinstance(mats, torch.Tensor) else list(mats)
        h = mats[0].shape[0]
        width = sum(m.numel() // h for m in mats)
        return bound(h * width * 4 + h * 8 * 4, h * ((width + 7) // 8) * P2_INSTR_PER_PERM)

    def permute(states, out_cols=16):
        n = states.shape[0]
        return bound(n * (16 + out_cols) * 4, n * P2_INSTR_PER_PERM)

    def tree(plan, digests_by_height):
        inject = dict(plan.inject_levels)
        perms = sum((plan.max_h >> i) * (2 if i in inject else 1) for i in range(1, plan.log_max + 1))
        read = plan.max_h + sum(h for _lvl, h in plan.inject_levels)
        return bound((read + plan.flat_len) * 8 * 4, perms * P2_INSTR_PER_PERM)

    def entries(table, main, prep, chal):
        """The fused kernel: the entries' products (each with an addition)
        and the running sum's 4 additions a row; no bytes beyond the
        entries' (the cumulative sum's 16 are left out)."""
        n = main.shape[0]
        pw = 0 if prep is None else prep.shape[1]
        return bound(n * (main.shape[1] + pw) * 4 + n * (table.nb + 1) * 16,
                     n * (logup_mults_per_row(table) * (MUL_INSTR + ADD_INSTR) + 4 * ADD_INSTR))

    def unit_elems(mats):
        return sum(m.numel() for m in mats), sum(int(m.shape[1]) for m in mats)

    def open_eval(mats, z, log_m, shift, row0=0):
        """Every member read once and the (W, 4) sums written; an element's
        4 column products (by the row's 4 EF4 weights) on the int8 tensor
        cores, and on the INT32 lanes a row's EF4 inverse and the 4
        products of x by it."""
        elems, w = unit_elems(mats)
        h = int(mats[0].shape[0])
        return bound(4 * elems + 16 * w, h * (EF4_INV_MULS + 4) * MUL_INSTR,
                     elems * 4 * IMMA_OPS_PER_PRODUCT)

    def ro_accum(ro, mats, alpha_pows, s, z, log_m, shift, row0=0, first=False):
        """Every member and the alpha powers read once, the (h, 4) reduced
        opening read (unless first) and written; an element's 4 column
        products (by its column's 4 alpha powers) on the int8 tensor
        cores, and on the INT32 lanes a row's EF4 inverse, its 4
        subtractions of S, the EF4 product (16 products, 12 additions)
        and, unless first, 4 additions."""
        elems, w = unit_elems(mats)
        h = int(mats[0].shape[0])
        return bound(4 * elems + 16 * w + 16 * h * (1 if first else 2),
                     h * ((EF4_INV_MULS + 16) * MUL_INSTR + (16 if first else 20) * ADD_INSTR),
                     elems * 4 * IMMA_OPS_PER_PRODUCT)

    def quotient(chip, main, prep, perm, sels, next_step, perm_challenges, alpha, cumulative_sum,
                 halo=None):
        """Each column the chip's program reads (its halo rows too), the
        selectors it reads and the inverse zeroifier read once, the (rows,
        4) result written; the products and additions that the function
        needs a row (stark/codegen.py counts: the constraints, their fold
        and the product by the inverse zeroifier; no conversion into
        Montgomery form, which is a choice of the kernel's)."""
        return quotient_bound_converting(chip, main, prep, perm, sels, next_step, halo=halo,
                                         conversions=False)

    return {
        "ntt_block_stages": (nt, "ntt_block_stages", block_stages),
        "ntt_stage": (nt, "ntt_stage", stage),
        "poseidon2_hash_rows": (p2, "hash_rows", hash_rows),
        "poseidon2_tree": (mk, "build_tree", tree),
        "poseidon2_permute": (p2, "permute", permute),
        "logup_entries": (lu, "logup_trace", entries),
        "open_eval": (op, "open_eval", open_eval),
        "ro_accum": (op, "ro_accum", ro_accum),
        "quotient_eval": (oq, "quotient_eval", quotient),
    }


def quotient_bound_converting(chip, main, prep, perm, sels, next_step, *_args, halo=None,
                              conversions=True, **_kwargs):
    """The bound of a quotient_eval launch: each column, selector and the
    inverse zeroifier read once, the result written once, and the
    products and additions of the generated program, with (`conversions`)
    the conversions into Montgomery form of each distinct (column, row)
    value and selector read, as the row-wise kernel converted them at
    load, or without them: what the function needs (launch_bounds)."""
    from zkvm_brainfuck_tpu_torch.stark import codegen

    c = codegen.program(chip, perm is not None).counts
    rows = int(main[0].shape[0])
    read = c["columns"] * (rows + (next_step if halo is not None else 0))
    products = c["products"] + (c["loads"] + c["selectors"] if conversions else 0)
    return bound(4 * read + 4 * rows * (c["selectors"] + 1) + 16 * rows,
                 rows * (products * MUL_INSTR + c["additions"] * ADD_INSTR))


def scan_bound(n):
    """The running sum of n row sums on its own: read and write 16 bytes a
    row, 4 additions a row."""
    return bound(2 * n * 16, n * 4 * ADD_INSTR)


@contextlib.contextmanager
def recording(targets):
    """Inside the block, each (module, name, tag, note) function passes its
    calls on and appends (tag, note(*args, **kwargs)) to the yielded list."""
    calls, saved = [], []
    for module, name, tag, note in targets:
        inner = getattr(module, name)

        def wrapper(*args, _inner=inner, _tag=tag, _note=note, **kwargs):
            calls.append((_tag, _note(*args, **kwargs)))
            return _inner(*args, **kwargs)

        saved.append((module, name, inner))
        setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        for module, name, inner in saved:
            setattr(module, name, inner)


@contextlib.contextmanager
def stream_events(torch, targets):
    """Inside the block, each (module, name, tag) function records a CUDA
    event on the current stream before and after each call.  Yields a dict
    tag -> list of (start, end) events; after a synchronize, the sum of
    their elapsed times is the stream's time inside those calls (their
    device work and any gap the host leaves the stream idle)."""
    pairs, saved = {tag: [] for _m, _n, tag in targets}, []
    for module, name, tag in targets:
        inner = getattr(module, name)

        def wrapper(*args, _inner=inner, _tag=tag, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = _inner(*args, **kwargs)
            end.record()
            pairs[_tag].append((start, end))
            return out

        saved.append((module, name, inner))
        setattr(module, name, wrapper)
    try:
        yield pairs
    finally:
        for module, name, inner in reversed(saved):
            setattr(module, name, inner)


def func_name(key: str) -> str:
    """'void (anonymous namespace)::stage_kernel<6, 5>(int const*, ...)' -> 'stage_kernel'."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    words = head.split("::")[-1].split()
    return words[-1] if words else ""


def phase_kernels(torch, dev, report):
    from zkvm_brainfuck_tpu_torch.ops import ntt as nt
    from zkvm_brainfuck_tpu_torch.ops import poseidon2 as p2
    from zkvm_brainfuck_tpu_torch.ops.field import P
    from zkvm_brainfuck_tpu_torch.stark import pcs

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
    kb = nt.BLOCK_LOG
    bounds = {k: v[2] for k, v in launch_bounds().items()}
    kernels = {}

    def plain_transform(v, ln, inverse, factors=None, pass_log=nt.PASS_LOG_MAX):
        k = min(nt.BLOCK_LOG, ln)
        y = nt.ntt_block_stages_plain(v, ln, k, inverse, factors)
        for first in range(k + 1, ln + 1, pass_log):
            y = nt.ntt_stage_plain(y, first, min(ln, first + pass_log - 1), inverse)
        return y

    # ntt_block_stages: 2^21 x 31 both ways, a height below 1024 rows, and the
    # LDE's forward block pass (2^20 x 31 coefficients, factors, 2^21 rows).
    err = 0
    for inverse in (False, True):
        err = max(err, compare(f"ntt_block_stages inverse={inverse}",
                               nt.ntt_block_stages(x, log_n, kb, inverse),
                               nt.ntt_block_stages_plain(x, log_n, kb, inverse)))
    small = rand(256, w)
    err = max(err, compare("ntt_block_stages n=256", nt.ntt_block_stages(small, 8, 8),
                           nt.ntt_block_stages_plain(small, 8, 8)))
    coeffs = rand(n // 2, w)
    fac = nt.scale_factors_dev(log_n - 1, 3, dev)
    err = max(err, compare("ntt_block_stages LDE 2^20 -> 2^21",
                           nt.ntt_block_stages(coeffs, log_n, kb, False, fac),
                           nt.ntt_block_stages_plain(coeffs, log_n, kb, False, fac)))
    ms = cuda_ms(torch, lambda: nt.ntt_block_stages(x, log_n, kb))
    plain_ms = cuda_ms(torch, lambda: nt.ntt_block_stages_plain(x, log_n, kb), reps=3)
    kernels["ntt_block_stages"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                       bound=bounds["ntt_block_stages"](x, log_n, kb),
                                       shape=f"({n}, {w}), k={kb}")
    lde_ms = cuda_ms(torch, lambda: nt.ntt_block_stages(coeffs, log_n, kb, False, fac))
    say(f"[kernels] ntt_block_stages LDE forward ({n // 2}, {w}) -> ({n}, {w}) with factors: "
        f"{lde_ms:.4f} ms, bound {bounds['ntt_block_stages'](coeffs, log_n, kb, False, fac)[0]:.4f} ms")

    # ntt_stage (in place): stages 11..21 of 2^21 x 31 both ways, a forced
    # split (stages 11..14), and the largest pass (12 stages, 2^22 x 8).
    y = nt.ntt_block_stages(x, log_n, kb)
    err = 0
    for inverse in (False, True):
        err = max(err, compare(f"ntt_stage {kb + 1}..{log_n} inverse={inverse}",
                               nt.ntt_stage(y.clone(), kb + 1, log_n, inverse),
                               nt.ntt_stage_plain(y, kb + 1, log_n, inverse)))
    err = max(err, compare("ntt_stage 11..14", nt.ntt_stage(y.clone(), 11, 14),
                           nt.ntt_stage_plain(y, 11, 14)))
    tall = rand(1 << 22, 8)
    err = max(err, compare("ntt_stage 11..22 (2^22, 8)", nt.ntt_stage(tall.clone(), 11, 22),
                           nt.ntt_stage_plain(tall, 11, 22)))
    del tall
    yc = y.clone()
    ms = cuda_ms(torch, lambda: nt.ntt_stage(yc, kb + 1, log_n))
    plain_ms = cuda_ms(torch, lambda: nt.ntt_stage_plain(y, kb + 1, log_n), reps=3)
    kernels["ntt_stage"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound=bounds["ntt_stage"](y, kb + 1, log_n),
                                shape=f"({n}, {w}), stages {kb + 1}..{log_n}")

    # Whole transforms and the LDE, kernels against plain passes: both ways
    # at 2^21 x 31, split into passes of 4 stages, below one block, and
    # stark/pcs.py lde of a 2^20 x 31 trace.
    for inverse in (False, True):
        fi = nt.scale_factors_dev(log_n, 1, dev) if inverse else None
        compare(f"ntt inverse={inverse}", nt.ntt_dev(x, log_n, inverse),
                plain_transform(x, log_n, inverse, fi))
    compare("ntt passes of 4 stages", nt.ntt_dev(x, log_n, False, pass_log=4),
            plain_transform(x, log_n, False, pass_log=4))
    small = rand(512, 3)
    compare("ntt n=512", nt.ntt_dev(small, 9, False), plain_transform(small, 9, False))
    compare("lde 2^20 x 31", pcs.lde(coeffs, log_n - 1, 1),
            plain_transform(plain_transform(coeffs, log_n - 1, True), log_n, False,
                            nt.scale_factors_dev(log_n - 1, 3, dev)))
    report["ntt_2^21x31_ms"] = cuda_ms(torch, lambda: nt.ntt_dev(x, log_n, False))

    # poseidon2_hash_rows: the main commit's digest layer (bit-reversed).
    err = compare("poseidon2_hash_rows", p2.hash_rows(x, bitrev=True), p2.hash_rows_plain([x], bitrev=True))
    q = [rand(n, 4), rand(n, 4)]
    err = max(err, compare("poseidon2_hash_rows 2x4", p2.hash_rows(q, bitrev=True),
                           p2.hash_rows_plain(q, bitrev=True)))
    ms = cuda_ms(torch, lambda: p2.hash_rows(x, bitrev=True))
    plain_ms = cuda_ms(torch, lambda: p2.hash_rows_plain([x], bitrev=True), reps=3)
    kernels["poseidon2_hash_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          bound=bounds["poseidon2_hash_rows"](x, bitrev=True),
                                          shape=f"({n}, {w}) -> ({n}, 8)")

    tree_kernels(torch, rand, compare, kernels, bounds)

    # poseidon2_permute: the grind's batch, 2^17 candidate states a launch
    # (stark/challenger.py grind), its only caller on the main path; held at
    # 2^20 states as well.
    grind = rand(1 << 17, 16)
    err = compare("poseidon2_permute grind batch", p2.permute(grind, out_cols=8),
                  p2.permute_plain(grind)[:, :8])
    states = rand(n // 2, 16)
    err = max(err, compare("poseidon2_permute 2^20", p2.permute(states, out_cols=8),
                           p2.permute_plain(states)[:, :8]))
    err = max(err, compare("poseidon2_permute 16", p2.permute(states), p2.permute_plain(states)))
    ms = cuda_ms(torch, lambda: p2.permute(grind, out_cols=8))
    plain_ms = cuda_ms(torch, lambda: p2.permute_plain(grind)[:, :8].contiguous(), reps=3)
    kernels["poseidon2_permute"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                        bound=bounds["poseidon2_permute"](grind, out_cols=8),
                                        shape=f"({1 << 17}, 16) -> ({1 << 17}, 8)")
    logup_kernels(torch, dev, rand, compare, kernels, bounds)
    opening_kernels(torch, rand, compare, kernels, bounds)
    quotient_kernels(torch, dev, rand, compare, kernels, bounds)
    torch.cuda.synchronize()
    for name, k in kernels.items():
        say(f"[kernels] {name} {k['shape']}: bit-exact; kernel {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, bound {k['bound'][0]:.4f} ms ({k['bound'][1]})")
    say(f"[kernels] ntt 2^21x31 (1 block pass + 1 stage pass): {report['ntt_2^21x31_ms']:.4f} ms")
    return kernels


def tree_kernels(torch, rand, compare, kernels, bounds):
    """poseidon2_tree against build_tree_plain, bit for bit: the main
    commit's tree (2^21 leaves, inject levels at 2^20, 2^18, 2^17, 2^13 and
    2^5, the LDE heights of the 8 chips), one FRI layer's tree (the digests
    of a (2^20, 8) matrix), trees of 1, 2 and 16 leaves, and a 2^12-leaf tree
    with an inject at every level.  Timed at the main commit's tree."""
    from zkvm_brainfuck_tpu_torch.ops import merkle as mk
    from zkvm_brainfuck_tpu_torch.ops import poseidon2 as p2

    n = 1 << (SLICE_LOG + 1)
    cases = [("main commit", (n, n >> 1, n >> 3, n >> 4, n >> 8, n >> 16)),
             ("FRI layer (2^20, 8)", (n >> 1,)), ("1 leaf", (1,)), ("2 leaves", (2,)),
             ("16 leaves", (16,)), ("inject at every level", tuple(1 << i for i in range(12, -1, -1)))]
    err = 0
    for name, heights in cases:
        plan = mk.make_plan(heights)
        if name.startswith("FRI"):
            digests = {heights[0]: p2.hash_rows(rand(heights[0], 8))}
        else:
            digests = {h: rand(h, 8) for h in heights}
        err = max(err, compare(f"poseidon2_tree {name}", mk.build_tree(plan, digests),
                               mk.build_tree_plain(plan, digests)))
        if name == "main commit":
            main_plan, main_digests = plan, digests
    ms = cuda_ms(torch, lambda: mk.build_tree(main_plan, main_digests))
    plain_ms = cuda_ms(torch, lambda: mk.build_tree_plain(main_plan, main_digests), reps=3)
    kernels["poseidon2_tree"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound=bounds["poseidon2_tree"](main_plan, main_digests),
                                     shape=f"{n} leaves, injects at {main_plan.inject_levels}")


def logup_mults_per_row(table) -> int:
    """Modular multiplies per row of logup_entries, from the chip's
    interaction table (the bound counts each with one addition): the affine
    terms and beta products of every fingerprint, the prefix products, one
    EF4 inverse (8 Frobenius scales by constants, 2 EF4 products, the norm's
    4, the Fermat power p - 2 = (2^6 - 1) * 2^25 + 2^24 - 1 by an addition
    chain of 48 squarings and 6 products, 4 scales), the unwind (2 EF4
    products per interaction) and the 4 products of each term."""
    n = table.n_inter
    per = 0
    for lk, _send in table.interactions:
        per += sum(len(a.terms) + 4 for a in lk.values) + len(lk.multiplicity.terms)
    return per + 16 * (n - 1) + EF4_INV_MULS + 2 * 16 * (n - 1) + 4 * n


def logup_kernels(torch, dev, rand, compare, kernels, bounds):
    """The fused LogUp kernel (logup_trace) against its plain composition,
    logup_entries_plain then logup_scan_plain, over the whole trace and the
    cumulative sum: the 8 chips at their main-path heights (the Cpu chip at
    2^20 rows: 16 interactions, 31 columns; Program and Byte with their
    preprocessed columns) and a Cpu height below one tile; random traces
    and challenges from a numpy seed.  Timed at the Cpu chip, beside the
    plain versions and, for the running sum, torch.cumsum of the int64
    row-sum column (one PyTorch call that computes it, without the mod-p
    reduction)."""
    import numpy as np

    from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu_torch.ops import logup as lu
    from zkvm_brainfuck_tpu_torch.ops.field import P
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.permutation import host_beta_pows, logup_table

    rng = np.random.default_rng(20)
    chips = {a.name: Chip(a) for a in brainfuck_chips()}
    cases = []
    for name, n in (("Cpu", 1 << SLICE_LOG), ("AddSub", 1 << SLICE_LOG), ("Jump", 1 << 19),
                    ("Program", 1 << 17), ("Byte", 1 << 16), ("MemoryInstrs", 1 << 12),
                    ("IO", 16), ("Memory", 16), ("Cpu", 100)):
        chip = chips[name]
        table = logup_table(chip)
        main = rand(n, chip.width)
        prep = rand(n, chip.preprocessed_width) if chip.preprocessed_width else None
        beta = tuple(int(x) for x in rng.integers(0, P, 4))
        chal = lu.challenge_matrix(rng.integers(0, P, 4), host_beta_pows(chip, beta), dev)
        cases.append((name, n, table, main, prep, chal))
    err_e = err_s = 0
    for name, n, table, main, prep, chal in cases:
        got, csum = lu.logup_trace(table, main, prep, chal)
        want = lu.logup_entries_plain(table, main, prep, chal)
        want_csum = lu.logup_scan_plain(want)
        err_e = max(err_e, compare(f"logup_trace entries {name} n={n}", got[:, :-1], want[:, :-1]))
        err_s = max(err_s, compare(f"logup_trace phi {name} n={n}", got[:, -1], want[:, -1]),
                    compare(f"logup_trace csum {name} n={n}", csum, want_csum))
    say(f"[kernels] logup_trace bit-exact against logup_entries_plain + logup_scan_plain "
        f"(whole trace and cumulative sum) at {len(cases)} shapes")
    name, n, table, main, prep, chal = cases[0]
    nb1 = table.nb + 1

    def plain():
        perm = lu.logup_entries_plain(table, main, prep, chal)
        return perm, lu.logup_scan_plain(perm)

    ms = cuda_ms(torch, lambda: lu.logup_trace(table, main, prep, chal))
    plain_ms = cuda_ms(torch, plain, reps=3)
    kernels["logup_entries"] = dict(max_abs_err=err_e, ms=ms, plain_ms=plain_ms,
                                    bound=bounds["logup_entries"](table, main, prep, chal),
                                    shape=f"Cpu ({n}, {main.shape[1]}), I={table.n_inter}, "
                                          f"NB={table.nb} -> ({n}, {nb1}, 4) and (4,)")
    perm = lu.logup_entries_plain(table, main, prep, chal)
    sums = perm[:, table.nb].to(torch.int64)  # (n, 4), the row sums
    scan_plain_ms = cuda_ms(torch, lambda: lu.logup_scan_plain(perm), reps=3)  # in place
    library_ms = cuda_ms(torch, lambda: torch.cumsum(sums, 0))
    sums_t = sums.t().contiguous()
    library_t_ms = cuda_ms(torch, lambda: torch.cumsum(sums_t, 1))
    kernels["logup_scan"] = dict(max_abs_err=err_s, ms=ms, plain_ms=scan_plain_ms,
                                 bound=scan_bound(n), library_ms=library_ms,
                                 shape=f"({n}, {nb1}, 4), column {table.nb}, inside logup_entries")
    say(f"[kernels] the running sum at ({n}, 4): fused into logup_entries ({ms:.4f} ms a launch "
        f"with the entries); on its own its bound is {scan_bound(n)[0]:.4f} ms, the plain version "
        f"{scan_plain_ms:.4f} ms, torch.cumsum of the int64 column {library_ms:.4f} ms (of its "
        f"transpose (4, {n}) along the rows: {library_t_ms:.4f} ms)")


def opening_kernels(torch, rand, compare, kernels, bounds):
    """open_eval and ro_accum against open_eval_plain and ro_accum_plain, bit
    for bit, on random members, alpha powers and points from a numpy seed
    (OPENING_CASES): the main path's largest unit (OPEN_UNIT_WIDTHS on the
    2^21-row LDE coset), the same unit with every member word p - 1 and
    with every word p - 2 (bytes 255, 255, 255, 126: each byte product
    at its largest), single members of widths 1, 8 and 9 over a row count
    that is not a multiple of a tile and of width 2 over 2^24 rows (each
    block flushes its 32-bit sums), a unit of odd widths and a Cpu-like
    source-domain unit at the rows of a mesh shard (row0 > 0), a unit of
    members that start 4 bytes past a 16-byte boundary (the kernels' 4-byte
    copies in place of TMA bulk copies), a unit of 18 members (two
    launches each) and one of 480 columns (the kernels' tiles of 32 rows).
    ro_accum writes (`first`) and adds in place.  Timed at the largest unit,
    ro_accum adding in place (as every group of a height after its first).
    Prints each kernel's registers and spills (ptxas) and the IMMA
    instructions of its SASS: there must be some."""
    import numpy as np

    from zkvm_brainfuck_tpu_torch.ops import openings as op
    from zkvm_brainfuck_tpu_torch.ops.field import GENERATOR, P

    sass = openings_sass()
    for fn, info in sass.items():
        say(f"[build] {fn}: {info['registers']} registers, spill {info['spill_stores']} / "
            f"{info['spill_loads']} bytes, stack {info['stack_frame']} bytes; {info['imma']} IMMA "
            f"instructions in its SASS")
        if not info["imma"]:
            raise AssertionError(f"{fn}: no IMMA instruction in the SASS of openings.cu")

    rng = np.random.default_rng(9)

    def ef():
        return tuple(int(x) for x in rng.integers(0, P, 4))

    shifts = {"lde": GENERATOR, "shifted": GENERATOR * 7 % P, "source": 1, "one": 1}
    fills = {"p-1": P - 1, "p-2": P - 2}

    def member(h, w, fill):
        if fill is None:
            return rand(h, w)
        if fill == "offset":
            return rand(h * w + 1)[1:].view(h, w)
        return torch.full((h, w), fills[fill], dtype=torch.int32, device=rand(1).device)

    err_o = err_r = 0
    for name, (log_m, domain, row0, h, widths, fill) in OPENING_CASES.items():
        shift = shifts[domain]
        mats = [member(h, w, fill) for w in widths]
        z, s = ef(), ef()
        aps = rand(sum(widths), 4)
        args = (z, log_m, shift, row0)
        err_o = max(err_o, compare(f"open_eval {name}", op.open_eval(mats, *args),
                                   op.open_eval_plain(mats, *args)))
        args = (mats, aps, s, z, log_m, shift, row0)
        err_r = max(err_r, compare(f"ro_accum first {name}", op.ro_accum(None, *args, first=True),
                                   op.ro_accum_plain(None, *args, first=True)))
        base = rand(h, 4)
        err_r = max(err_r, compare(f"ro_accum add {name}", op.ro_accum(base.clone(), *args),
                                   op.ro_accum_plain(base.clone(), *args)))
        if name == "largest unit":
            big = (mats, z, s, aps, log_m, base)
    mats, z, s, aps, log_m, base = big
    shape = f"2^{log_m} rows x {'+'.join(map(str, OPEN_UNIT_WIDTHS))} columns"
    kernels["open_eval"] = dict(
        max_abs_err=err_o, ms=cuda_ms(torch, lambda: op.open_eval(mats, z, log_m, GENERATOR)),
        plain_ms=cuda_ms(torch, lambda: op.open_eval_plain(mats, z, log_m, GENERATOR), reps=3),
        bound=bounds["open_eval"](mats, z, log_m, GENERATOR), shape=f"{shape} -> ({sum(OPEN_UNIT_WIDTHS)}, 4)",
        sass=sass["open_eval_kernel"])
    acc = base.clone()
    kernels["ro_accum"] = dict(
        max_abs_err=err_r,
        ms=cuda_ms(torch, lambda: op.ro_accum(acc, mats, aps, s, z, log_m, GENERATOR)),
        plain_ms=cuda_ms(torch, lambda: op.ro_accum_plain(acc, mats, aps, s, z, log_m, GENERATOR),
                         reps=3),
        bound=bounds["ro_accum"](acc, mats, aps, s, z, log_m, GENERATOR),
        shape=f"{shape}, added into (2^{log_m}, 4)", sass=sass["ro_accum_kernel"])
    say(f"[kernels] open_eval and ro_accum bit-exact against open_eval_plain and ro_accum_plain "
        f"at {len(OPENING_CASES)} units ({'; '.join(OPENING_CASES)}; ro_accum writing and adding)")


OPENING_FUNCS = ("open_eval_kernel", "ro_accum_kernel")


def _opening_func(mangled: str) -> str:
    """The opening kernel a mangled name holds, or the name itself."""
    return next((f for f in OPENING_FUNCS if f in mangled), mangled)


def ptxas_functions(log: str) -> dict:
    """{kernel function: registers, spills and stack frame} from an nvcc
    -Xptxas -v log (the opening kernels by their short names)."""
    import re

    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = _opening_func(chunk.split("'")[0])
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        stack = re.search(r"(\d+) bytes stack frame", chunk)
        out[name] = {"registers": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spill.group(1)) if spill else None,
                     "spill_loads": int(spill.group(2)) if spill else None,
                     "stack_frame": int(stack.group(1)) if stack else None}
    return out


def sass_imma(lib_path: str) -> dict:
    """{kernel function: IMMA instructions in its SASS}, from cuobjdump
    --dump-sass of a built library."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "--dump-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib_path}:\n{res.stderr}")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = _opening_func(line.split("Function :")[1].strip())
            counts[name] = 0
        elif name is not None and "IMMA" in line:
            counts[name] += 1
    return counts


def openings_sass(lib_path: str = None, log: str = None) -> dict:
    """Registers, spills and IMMA count of open_eval_kernel and
    ro_accum_kernel in the built openings library (the committed source by
    default; its ptxas log from build.LOGS, so the library must have been
    built by this process)."""
    from zkvm_brainfuck_tpu_torch import build

    if lib_path is None:
        lib_path = build.build_cuda(["openings.cu"])["openings.cu"]
        log = build.LOGS.get("openings.cu", "")
    ptx = ptxas_functions(log or "")
    imma = sass_imma(lib_path)
    empty = {"registers": None, "spill_stores": None, "spill_loads": None, "stack_frame": None}
    return {fn: {**ptx.get(fn, empty), "imma": imma.get(fn, 0)} for fn in OPENING_FUNCS}


# Tile-edge cases of the quotient kernel (csrc/quotient.cuh stages tiles of
# zkbfq::TILE = 128 rows), as in tests/test_torch_quotient.py: name ->
# (trace log_n, blowup log, row0, rows or None for the whole LDE, block
# width, or (f, w) for a first block of f columns then blocks of w, or None
# for one block a group; blocks as views of one tensor).
QUOTIENT_TILE_CASES = {
    "whole 2^10, the wrap at the last tile": (9, 1, 0, None, None, False),
    "300 rows at row0 38 (unaligned 16-byte runs, a short last tile)": (9, 1, 38, 300, None, True),
    "100 rows, fewer than a tile, 4-column blocks after a 2-column one (EF4 planes straddle)":
        (9, 1, 400, 100, (2, 4), False),
    "a shard of 4, 8-column blocks after a 2-column one (EF4 planes straddle)":
        (9, 1, 256, 256, (2, 8), False),
    "6-column views (row stride > width, EF4 planes straddle)": (9, 1, 0, None, 6, True),
    "next_step 4, 8-column blocks": (8, 2, 0, None, 8, False),
}


def queued_ms(torch, fn, n: int = 20, reps: int = 3) -> float:
    """Median device ms of one of n back-to-back calls of `fn`, queued
    behind a torch.cuda._sleep so that the host's work for each call (a
    ctypes launch) stays off the device timeline: the kernel alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def quotient_kernels(torch, dev, rand, compare, kernels, bounds):
    """quotient_eval against quotient_rows_plain, bit for bit, on random
    LDE columns and challenges (a numpy seed): every chip at its main-path
    coset height (QUOTIENT_LOG) on a whole LDE whose next rows wrap, in
    8-column blocks (the low-memory 2^22 layout) and at the rows of a shard
    of 4 (row0 = Nq/4) in 8-column blocks with the next shard's first rows
    as its halo, then at the tile edges (QUOTIENT_TILE_CASES); the Cpu chip
    without LogUp (the uni-STARK's kernel).  For each chip at its height:
    the kernel alone (a prepared launch, queued_ms), the whole wrapper
    (cuda_ms: its host work too), the bound of what the function needs and
    the bound counting the conversions at load too, the registers,
    the tile's bytes and the blocks an SM holds.  The entry is the Cpu
    chip's."""
    import ctypes

    import numpy as np

    from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn
    from zkvm_brainfuck_tpu_torch.ops import quotient as oq
    from zkvm_brainfuck_tpu_torch.ops.field import P
    from zkvm_brainfuck_tpu_torch.stark import codegen
    from zkvm_brainfuck_tpu_torch.stark import quotient as tquot
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.domains import Domain, selectors_on_coset

    rng = np.random.default_rng(10)

    def ef():
        return tuple(int(x) for x in rng.integers(0, P, 4))

    def blocked(m, rows=slice(None), width=8, views=False):
        if m is None:
            return None
        if width is None:
            return [m[rows]]
        first, w = (0, width) if isinstance(width, int) else width
        edges = [0] + list(range(first or w, m.shape[1], w)) + [m.shape[1]]
        return [m[rows, a:b] if views else m[rows, a:b].contiguous()
                for a, b in zip(edges, edges[1:])]

    def info(launch):
        regs, smem, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        kn.check(launch.lib.zkbf_quotient_info(2, ctypes.addressof(regs), ctypes.addressof(smem),
                                               ctypes.addressof(per_sm)), "zkbf_quotient_info")
        return regs.value, smem.value, per_sm.value

    def inputs(chip, nq):
        main = rand(nq, chip.width)
        prep = rand(nq, chip.preprocessed_width) if chip.preprocessed_width else None
        perm = rand(nq, 4 * chip.permutation_width)
        return main, prep, perm, dict(perm_challenges=(ef(), ef()), alpha=ef(),
                                      cumulative_sum=ef())

    err, per_chip = 0, {}
    for air in brainfuck_chips():
        chip = Chip(air)
        log_q = QUOTIENT_LOG[chip.name]
        nq = 1 << log_q
        td = Domain(log_q - 1, 1)
        qd = td.create_disjoint_domain(nq)
        sels = selectors_on_coset(td.log_n, qd.log_n, qd.shift, dev)
        main, prep, perm, ch = inputs(chip, nq)
        args = ([main], None if prep is None else [prep], [perm], sels, 2)
        want = tquot.quotient_rows_plain(chip, *args, **ch)
        err = max(err, compare(f"quotient_eval {chip.name}", oq.quotient_eval(chip, *args, **ch),
                               want))
        launch = oq.Launch(chip, *args, **ch)
        alone = queued_ms(torch, launch)
        err = max(err, compare(f"quotient_eval {chip.name} (prepared launch)", launch.out, want))
        regs, smem, per_sm = info(launch)
        per_chip[chip.name] = {
            "coset_rows": nq, "ms": alone,
            "wrapper_ms": cuda_ms(torch, lambda: oq.quotient_eval(chip, *args, **ch)),
            "counts": codegen.program(chip).counts,
            "bound": bounds["quotient_eval"](chip, *args, **ch),
            "bound_converting": quotient_bound_converting(chip, *args, **ch),
            "registers": regs, "tile_bytes": smem, "blocks_per_sm": per_sm}
        got = oq.quotient_eval(chip, blocked(main), blocked(prep), blocked(perm), sels, 2, **ch)
        err = max(err, compare(f"quotient_eval {chip.name} 8-column blocks", got, want))
        rows = row0 = nq // 4
        sub, nxt = slice(row0, row0 + rows), slice(row0 + rows, row0 + rows + 2)
        ssels = selectors_on_coset(td.log_n, qd.log_n, qd.shift, dev, row0, rows)
        got = oq.quotient_eval(chip, blocked(main, sub), blocked(prep, sub), blocked(perm, sub),
                               ssels, 2, **ch, halo=(blocked(main, nxt), blocked(prep, nxt),
                                                     blocked(perm, nxt)))
        err = max(err, compare(f"quotient_eval {chip.name} shard", got, want[sub]))
        for case, (log_n, log_b, row0, rows, width, views) in QUOTIENT_TILE_CASES.items():
            etd = Domain(log_n, 1)
            eqd = etd.create_disjoint_domain(1 << (log_n + log_b))
            step = 1 << log_b
            esels = selectors_on_coset(etd.log_n, eqd.log_n, eqd.shift, dev)
            emain, eprep, eperm, ech = inputs(chip, eqd.size)
            ewant = tquot.quotient_rows_plain(chip, [emain], None if eprep is None else [eprep],
                                              [eperm], esels, step, **ech)
            mats = (emain, eprep, eperm)
            if rows is None:
                got = oq.quotient_eval(chip, *[blocked(m, width=width, views=views) for m in mats],
                                       esels, step, **ech)
            else:
                sub, nxt = slice(row0, row0 + rows), slice(row0 + rows, row0 + rows + step)
                ewant = ewant[sub]
                got = oq.quotient_eval(
                    chip, *[blocked(m, sub, width, views) for m in mats],
                    selectors_on_coset(etd.log_n, eqd.log_n, eqd.shift, dev, row0, rows), step,
                    **ech, halo=tuple(blocked(m, nxt, width, views) for m in mats))
            err = max(err, compare(f"quotient_eval {chip.name} {case}", got, ewant))
        if chip.name == "Cpu":
            timed = (chip, args, ch)
    chip, args, ch = timed
    uni = dict(perm_challenges=None, alpha=ch["alpha"], cumulative_sum=None)
    uni_args = (args[0], None, None, args[3], 2)
    err = max(err, compare("quotient_eval Cpu without LogUp",
                           oq.quotient_eval(chip, *uni_args, **uni),
                           tquot.quotient_rows_plain(chip, *uni_args, **uni)))
    nq = int(args[0][0].shape[0])
    kernels["quotient_eval"] = dict(
        max_abs_err=err, ms=per_chip["Cpu"]["ms"],
        plain_ms=cuda_ms(torch, lambda: tquot.quotient_rows_plain(chip, *args, **ch), reps=3),
        bound=per_chip["Cpu"]["bound"], library_ms=None, per_chip=per_chip,
        shape=f"Cpu: 2^{nq.bit_length() - 1} coset rows x ({chip.width} + "
              f"{4 * chip.permutation_width}) columns -> ({nq}, 4)")
    for name, v in per_chip.items():
        b, bc = v["bound"][0], v["bound_converting"][0]
        say(f"[kernels] quotient_eval {name:12s} at {v['coset_rows']:8d} coset rows: bit-exact; "
            f"kernel alone {v['ms']:.4f} ms ({100 * b / v['ms']:.1f} % of its bound), wrapper "
            f"{v['wrapper_ms']:.4f} ms; bound {b:.4f} ms ({v['bound'][1]}; counting the "
            f"conversions at load {bc:.4f} ms); {v['registers']} registers, "
            f"{v['tile_bytes']} tile bytes, {v['blocks_per_sm']} blocks an SM; a row: "
            f"{v['counts']['products']} products, "
            f"{v['counts']['additions']} additions, {v['counts']['columns']} columns "
            f"({v['counts']['reads']} tile reads)")
    say(f"[kernels] quotient_eval bit-exact for all {len(per_chip)} chips on a whole LDE, in "
        f"8-column blocks, at a shard's rows with a halo and at the tile edges "
        f"({'; '.join(QUOTIENT_TILE_CASES)}), and for Cpu without LogUp")


def quotient_ptxas(report):
    """Registers and spills of each generated quotient kernel, from the
    build's ptxas output (build.LOGS; empty for a library built earlier)."""
    import re

    from zkvm_brainfuck_tpu_torch import build

    out = {}
    for name in build.quotient_sources():
        log = build.LOGS.get(name, "")
        regs = re.search(r"Used (\d+) registers", log)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        stack = re.search(r"(\d+) bytes stack frame", log)
        out[name] = {"registers": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spill.group(1)) if spill else None,
                     "spill_loads": int(spill.group(2)) if spill else None,
                     "stack_frame": int(stack.group(1)) if stack else None}
    report["quotient_ptxas"] = out
    say("[build] quotient_kernel ptxas (registers / spill stores / spill loads, bytes): "
        + ", ".join(f"{k} {v['registers']} / {v['spill_stores']} / {v['spill_loads']}"
                    for k, v in out.items()))


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


def check_golden_printa(vk, transcript, proof_bytes, what):
    """Raise unless the vk, the transcript and the proof bytes of a `printa`
    prove equal tests/golden/{vk,proof}_printa_q84.bin and
    transcript_printa_q84.json."""
    golden_dir = os.path.join(ROOT, "tests", "golden")

    def read(name, mode="rb"):
        with open(os.path.join(golden_dir, name), mode) as fh:
            return fh.read()

    if vk.to_bytes() != read("vk_printa_q84.bin"):
        raise AssertionError(f"{what} vk differs from tests/golden/vk_printa_q84.bin")
    want = json.loads(read("transcript_printa_q84.json", "r"))["transcript"]
    first = next((i for i, (a, b) in enumerate(zip(transcript, want)) if a != b),
                 None if len(transcript) == len(want) else min(len(transcript), len(want)))
    if first is not None:
        where = next((n for n, lo, hi in TRANSCRIPT_SEGMENTS if lo <= first < hi), "beyond S5")
        raise AssertionError(f"{what} transcript differs first at entry {first} ({where})")
    if proof_bytes != read("proof_printa_q84.bin"):
        raise AssertionError(f"{what} proof differs from tests/golden/proof_printa_q84.bin")


def phase_golden_main(torch, dev, report):
    from zkvm_brainfuck_tpu_torch import ProverClient, guests
    from zkvm_brainfuck_tpu_torch.sdk import CpuProver

    config = recording_config()
    client = ProverClient(CpuProver(config=config))
    t0 = time.time()
    pk, vk = client.setup(guests.PRINTA_BF)
    proof = client.prove(pk, b"").run()
    secs = time.time() - t0
    got = config.challengers[0].record
    data = proof.proof.proof.to_bytes()
    check_golden_printa(vk, got, data, "card-path")
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
    from zkvm_brainfuck_tpu_torch.ops import merkle as mk
    from zkvm_brainfuck_tpu_torch.ops import ntt as nt
    from zkvm_brainfuck_tpu_torch.stark import pcs
    from zkvm_brainfuck_tpu_torch.stark import quotient as tquot
    from zkvm_brainfuck_tpu_torch.stark.errors import VerificationFailure
    from zkvm_brainfuck_tpu_torch.stark.types import MachineProof

    src = guests.bench_guest(SLICE_LOG)
    client = ProverClient()
    fri = client.prover.prover.config.fri
    assert (fri.num_queries, fri.proof_of_work_bits) == (QUERIES, GOLDEN_POW_BITS), fri
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain_before = tquot.PLAIN_CALLS
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
    plain_calls = tquot.PLAIN_CALLS - plain_before
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
    # The shapes of a prove's launches, LDEs and cached NTT tables, from a
    # second prove with those functions recorded, so the timed one above
    # ran unwrapped.  Its launches are not in `counts`.
    targets = [(mod, fn, name, note) for name, (mod, fn, note) in launch_bounds().items()]
    targets += [(mk, "make_plan", "commits", lambda heights: heights),
                (pcs, "lde", "lde", lambda evals, log_n, shift: (tuple(evals.shape), log_n, shift)),
                (nt, "twiddle_mont_dev", "twiddles", lambda log_n, inverse, device: (log_n, inverse)),
                (nt, "scale_factors_dev", "factors", lambda log_n, shift, device: (log_n, shift))]
    with recording(targets) as calls:
        client.prove(pk, b"").run()
    torch.cuda.synchronize()
    lde_calls = [note for tag, note in calls if tag == "lde"]
    prove_bounds = {k: sum(note[0] for tag, note in calls if tag == k) for k in counts}
    recorded = {k: sum(1 for tag, _ in calls if tag == k) for k in counts}
    if recorded != prove_counts:
        raise AssertionError(f"wrapper calls {recorded} != launches {prove_counts} of a prove")
    twiddles = {note for tag, note in calls if tag == "twiddles"}
    factors = {note for tag, note in calls if tag == "factors"}
    table_bytes = (sum(4 * max(1, (1 << ln) - 1) for ln, _inv in twiddles)
                   + sum(4 << ln for ln, _shift in factors))
    # Every LDE is two transforms: one block pass each, and one stage pass
    # per PASS_LOG_MAX stages above BLOCK_LOG.
    heights = [ln for _s, ln, _sh in lde_calls] + [ln + pcs.LOG_BLOWUP for _s, ln, _sh in lde_calls]
    want = {"ntt_block_stages": len(heights),
            "ntt_stage": sum(-(-(ln - nt.BLOCK_LOG) // nt.PASS_LOG_MAX)
                             for ln in heights if ln > nt.BLOCK_LOG)}
    got = {k: prove_counts[k] for k in want}
    if got != want:
        raise AssertionError(f"NTT launches per prove {got}, expected {want} from the LDE shapes")
    # The commits a prove makes, from the proof: main, permutation and
    # quotient, and one per FRI commit phase.
    commits = 3 + len(sp.opening_proof.fri.commit_phase_commits)
    plans = sum(1 for tag, _ in calls if tag == "commits")
    if prove_counts["poseidon2_tree"] != commits or plans != commits:
        raise AssertionError(f"{prove_counts['poseidon2_tree']} poseidon2_tree calls and {plans} "
                             f"tree plans for the proof's {commits} commits")
    # LogUp: one fused launch a chip, each after one clear of its scratch.
    logup_lib = kn.lib("logup.cu")
    scratch = [4 * logup_lib.zkbf_logup_scratch_words(ch["rows"]) for ch in chips]
    if prove_counts["logup_entries"] != len(chips):
        raise AssertionError(f"{prove_counts['logup_entries']} LogUp launches for {len(chips)} chips")
    # The quotient: one generated kernel's launch a chip, and no eager
    # evaluation (the plain version's transposed and rolled copies).
    if prove_counts["quotient_eval"] != len(chips) or plain_calls != 0:
        raise AssertionError(f"{prove_counts['quotient_eval']} quotient launches for {len(chips)} "
                             f"chips and {plain_calls} calls of the plain quotient")
    report["main"] = {"cycles": proof.proof.cycles, "queries": QUERIES, "pow_bits": GOLDEN_POW_BITS,
                      "quotient_prove": {"launches": prove_counts["quotient_eval"],
                                         "plain_calls": plain_calls},
                      "logup_prove": {"launches": prove_counts["logup_entries"],
                                      "scratch_clears": len(scratch), "scratch_bytes": scratch},
                      "phases_s": phases, "peak_bytes": peak, "launches": counts,
                      "launches_prove": prove_counts, "bound_ms_prove": prove_bounds,
                      "commits_prove": commits,
                      "ntt_tables": {"twiddle_blobs": sorted(twiddles), "factor_tables": sorted(factors),
                                     "bytes": table_bytes},
                      "chips": chips, "proof_bytes": len(data)}
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
    say(f"[main] LogUp per prove: {prove_counts['logup_entries']} launches of the fused kernel "
        f"(entries and running sum; no scan launch), each after a scratch clear "
        f"(cudaMemsetAsync): {len(scratch)} clears, {sum(scratch)} bytes in all")
    say(f"[main] quotient per prove: {prove_counts['quotient_eval']} quotient_eval launches (one "
        f"generated kernel a chip, on the LDE blocks in place) and {plain_calls} calls of the "
        f"plain quotient (no eager evaluation, transpose or roll) in setup, prove and verify")
    say(f"[main] {len(lde_calls)} LDEs per prove: {want['ntt_block_stages']} ntt_block_stages and "
        f"{want['ntt_stage']} ntt_stage launches, as the LDE shapes require")
    say(f"[main] opening rounds per prove: {prove_counts['open_eval']} open_eval launches (one a "
        f"unit, each after a scratch clear) and {prove_counts['ro_accum']} ro_accum launches (one "
        f"a reduced-opening sub-unit)")
    say(f"[main] {commits} commits per prove: {prove_counts['poseidon2_tree']} poseidon2_tree calls "
        f"(the tree walk), {prove_counts['poseidon2_permute']} poseidon2_permute launches (the grind)")
    say("[main] bound per prove (ms, summed over the launches' shapes): " + ", ".join(
        f"{k} {v:.4f}" for k, v in prove_bounds.items()))
    say(f"[main] NTT tables a prove reads, cached on the card: {len(twiddles)} Montgomery twiddle "
        f"blobs and {len(factors)} row-factor tables, {table_bytes / 2**20:.3f} MiB")
    single = {"vk": vk.to_bytes(), "proof": data, "phases": phases}
    return counts, client, pk, lde_calls, prove_bounds, commits, single


def phase_lde(torch, dev, report, lde_calls):
    """CUDA-event time of stark/pcs.py `lde` over the LDE shapes of one
    main-path prove (random canonical inputs of those shapes), run back to
    back, against the sum of each LDE's bound: the larger of its bytes (4 B
    read per input element, 8 B written at blowup 2) and the instructions
    of the inverse transform, the coefficient scale and the forward
    transform of the zero-padded coefficients.  Then one `lde` of the largest shape under torch.profiler: it must run
    the two NTT kernels and no gather, concatenation, dtype copy or int64
    product."""
    from torch.profiler import ProfilerActivity, profile

    from zkvm_brainfuck_tpu_torch.ops.field import P
    from zkvm_brainfuck_tpu_torch.stark import pcs

    gen = torch.Generator(device=dev).manual_seed(3)
    inputs = [(torch.randint(0, P, shape, generator=gen, device=dev, dtype=torch.int64)
               .to(torch.int32), log_n, shift) for shape, log_n, shift in lde_calls]

    def run():
        for x, log_n, shift in inputs:
            pcs.lde(x, log_n, shift)

    ms = cuda_ms(torch, run)
    elems = sum(x.numel() for x, _, _ in inputs)
    bytes_ms = elems * (4 + (4 << pcs.LOG_BLOWUP)) / HBM_BYTES_PER_S * 1e3
    bound_ms = 0.0
    for x, log_n, _shift in inputs:
        n, w = x.shape
        big = log_n + pcs.LOG_BLOWUP
        bound_ms += bound(n * w * (4 + (4 << pcs.LOG_BLOWUP)),
                          stages_instr(n, w, 1, log_n) + block_pass_instr(n, w, big, big, True))[0]
    report["lde"] = {"calls": len(inputs), "input_elements": elems, "ms_per_prove": ms,
                     "bound_ms": bound_ms, "bytes_ms": bytes_ms,
                     "shapes": [[list(s), ln, sh] for s, ln, sh in lde_calls]}
    say(f"[lde] {len(inputs)} LDEs of one main-path prove ({elems} input elements): "
        f"{ms:.4f} ms per prove, bound {bound_ms:.4f} ms (their bytes alone {bytes_ms:.4f} ms)")

    x, log_n, shift = max(inputs, key=lambda t: t[0].numel())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pcs.lde(x, log_n, shift)
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = sorted({e.key for e in events if e.key.startswith("aten::")})
    cuda = torch.autograd.DeviceType.CUDA
    device_funcs = sorted({func_name(e.key) for e in events
                           if getattr(e, "device_type", None) == cuda})
    banned = {"aten::index_select", "aten::index", "aten::cat", "aten::remainder", "aten::fmod",
              "aten::mul", "aten::where", "aten::copy_", "aten::_to_copy"}
    if banned & set(ops) or device_funcs != ["block_stages_kernel", "stage_kernel"]:
        raise AssertionError(f"lde {tuple(x.shape)} ran {ops} on the host and {device_funcs} "
                             f"on the device")
    report["lde"]["ops"] = {"shape": list(x.shape), "aten": ops, "device": device_funcs}
    say(f"[lde] one lde of {tuple(x.shape)} runs {device_funcs} on the device and, on the host, "
        f"{ops}: no gather, cat, dtype copy or int64 product")


def phase_profile(torch, dev, report, client, pk, prove_bounds, commits):
    """A warm main-path prove with the same key under torch.profiler; device
    busy share = sum of device self times of all kernels over the wall time.
    The tree walk may take at most 2 device launches per commit."""
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

    ours = {}
    for name, funcs in DEVICE_FUNCS.items():
        hit = [r for r in rows if func_name(r[0]) in funcs]
        ours[name] = {"device_ms": sum(r[1] for r in hit) / 1e3,
                      "device_launches": sum(r[2] for r in hit),
                      "bound_ms": prove_bounds[name]}
    report["profile"] = {"warm_s": warm, "warm_phases_s": warm_phases, "wall_s": wall,
                         "device_busy_ms": busy_ms, "device_events": n_kernels,
                         "kernels": ours,
                         "top": [{"name": k[:120], "ms": us / 1e3, "count": c} for k, us, c in rows[:30]]}
    if not rows:
        say("[profile] the profiler recorded no device time (busy share not measured)")
        return
    tree = ours["poseidon2_tree"]["device_launches"]
    if not 0 < tree <= 2 * commits:
        raise AssertionError(f"the tree walk made {tree} device launches for {commits} commits")
    say(f"[profile] warm main-path prove {warm:.4f} s without the profiler, {wall:.4f} s under it; "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / 1e3 / wall:.2f} % of the profiled wall, "
        f"{100 * busy_ms / 1e3 / warm:.2f} % of the unprofiled one) over {n_kernels} device events")
    say("[profile] warm prove phases (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in warm_phases.items()))
    for k, us, c in rows[:20]:
        say(f"[profile]   {us / 1e3:9.3f} ms  x{c:5d}  {k[:90]}")
    for name, v in ours.items():
        say(f"[profile] {name:20s} {v['device_ms']:9.3f} ms per prove over "
            f"{v['device_launches']} device launches; bound {v['bound_ms']:.4f} ms per prove")
    memsets = sum(c for k, _us, c in rows if "memset" in k.lower())
    memset_ms = sum(us for k, us, _c in rows if "memset" in k.lower()) / 1e3
    report["profile"]["memsets"] = {"count": memsets, "device_ms": memset_ms}
    say(f"[profile] the tree walk: {tree} device launches for {commits} commits per prove")
    say(f"[profile] {memsets} memsets on the device per prove, {memset_ms:.3f} ms (the LogUp "
        f"scratch clears among them)")


# The BF_DEBUG replay's guest: 2^19 - 1 cycles.  The replay is host numpy
# and grows with the rows (17.8 s at 2^18 on the H100's host, PERF.md), so
# 2^20 would take over a minute.
DEBUG_LOG = 19


def phase_debug(torch, dev, report):
    """BF_DEBUG=1 prove of the 2^DEBUG_LOG - 1 cycle bench guest on the card:
    the replay (StarkMachine.debug_constraints: AIR constraints and lookup
    balance on the host, every chip's permutation trace from the fused
    LogUp kernel, the permutation constraints row by row, the cumulative
    sums cancel) must pass; its host seconds are printed.  Then two
    corruptions must each make the replay raise: one cell of the Cpu chip's
    main trace (its pc at a row past the middle), and one row of the Cpu
    chip's running-sum column as the fused kernel returns it."""
    import numpy as np

    from zkvm_brainfuck_tpu_torch import ProverClient, guests
    from zkvm_brainfuck_tpu_torch.core.executor import execute
    from zkvm_brainfuck_tpu_torch.core.program import Program
    from zkvm_brainfuck_tpu_torch.ops.field import P
    from zkvm_brainfuck_tpu_torch.stark import permutation

    src = guests.bench_guest(DEBUG_LOG)
    client = ProverClient()
    machine = client.prover.prover.machine
    replay = machine.debug_constraints
    secs = []

    def timed(*args, **kwargs):
        t0 = time.time()
        replay(*args, **kwargs)
        secs.append(time.time() - t0)

    pk, vk = client.setup(src)
    machine.debug_constraints = timed
    os.environ["BF_DEBUG"] = "1"
    try:
        t0 = time.time()
        proof = client.prove(pk, b"").run()
        wall = time.time() - t0
    finally:
        del os.environ["BF_DEBUG"]
        del machine.debug_constraints
    if len(secs) != 1:
        raise AssertionError(f"BF_DEBUG=1: the replay ran {len(secs)} times")
    client.verify(proof, vk)
    say(f"[debug] BF_DEBUG=1 prove of {proof.proof.cycles} cycles (2^{DEBUG_LOG} - 1): the replay "
        f"passed in {secs[0]:.4f} s on the host (prove + replay {wall:.4f} s)")

    program = Program.from_source(src)
    record = execute(program, b"")
    rng = np.random.default_rng(8)
    cpu = next(c for c in machine.chips if c.name == "Cpu")
    pc = cpu.air.cols.offset_of("pc")
    row = int(rng.integers(1 << (DEBUG_LOG - 1), 1 << DEBUG_LOG))
    generate = cpu.air.generate_trace

    def bad_trace(*args, **kwargs):
        t = generate(*args, **kwargs)
        t[row, pc] = (int(t[row, pc]) + 1) % P
        return t

    def bad_phi(chip, prep, main, alpha, beta, _inner=permutation.generate_permutation_trace):
        perm, csum = _inner(chip, prep, main, alpha, beta)
        if chip.name == "Cpu":
            perm[row, -1, 1] = (int(perm[row, -1, 1]) + 1) % P
        return perm, csum

    caught = {}
    for what, install, remove in (
            (f"Cpu main trace, pc of row {row}", lambda: setattr(cpu.air, "generate_trace", bad_trace),
             lambda: delattr(cpu.air, "generate_trace")),
            (f"Cpu running sum (fused kernel), row {row}",
             lambda: setattr(permutation, "generate_permutation_trace", bad_phi),
             lambda: setattr(permutation, "generate_permutation_trace",
                             bad_phi.__defaults__[0]))):
        install()
        t0 = time.time()
        try:
            replay(program, record)
        except AssertionError as e:
            caught[what] = (str(e)[:160], time.time() - t0)
        else:
            raise AssertionError(f"the BF_DEBUG replay missed a corrupted {what}")
        finally:
            remove()
        say(f"[debug] corrupted {what}: the replay raised in {caught[what][1]:.4f} s: "
            f"{caught[what][0]}")
    report["debug"] = {"log_cycles": DEBUG_LOG, "cycles": proof.proof.cycles, "replay_s": secs[0],
                       "prove_and_replay_s": wall,
                       "corruptions": {k: {"error": v[0], "s": v[1]} for k, v in caught.items()}}


def phase_profile_trace(torch, dev, report):
    """A prove of `printa` with ZKBF_PROFILE=<dir> writes a torch.profiler
    Chrome trace into <dir> that names the fused LogUp kernel."""
    import shutil

    from zkvm_brainfuck_tpu_torch import ProverClient, guests

    out = os.path.join(ROOT, "build", "profile_check")
    shutil.rmtree(out, ignore_errors=True)
    client = ProverClient()
    pk, vk = client.setup(guests.PRINTA_BF)
    os.environ["ZKBF_PROFILE"] = out
    try:
        t0 = time.time()
        proof = client.prove(pk, b"").run()
        secs = time.time() - t0
    finally:
        del os.environ["ZKBF_PROFILE"]
    client.verify(proof, vk)
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    if len(files) != 1:
        raise AssertionError(f"ZKBF_PROFILE: {len(files)} trace files in {out}")
    path = os.path.join(out, files[0])
    size = os.path.getsize(path)
    with open(path) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    shutil.rmtree(out)
    hits = sorted(n for n in names if "entries_kernel" in n)
    if not hits:
        raise AssertionError("the ZKBF_PROFILE trace does not name the fused LogUp kernel")
    report["profile_trace"] = {"prove_s": secs, "bytes": size, "events": len(names), "logup": hits}
    say(f"[profile-trace] ZKBF_PROFILE prove of printa in {secs:.4f} s wrote {files[0]} "
        f"({size} bytes), which names {func_name(hits[0])}")


@contextlib.contextmanager
def phase_peaks(torch):
    """Wrap utils.phases.add, which every prover phase calls as it ends:
    record the peak device memory since the previous phase ended (then
    start a new peak).  Yields the list of (phase, seconds, peak bytes) in
    order; a total's entry (pcs_open_total, prove_total) covers only what
    follows its last inner phase."""
    from zkvm_brainfuck_tpu_torch.utils import phases as ph

    inner = ph.add
    seen = []

    def add(name, seconds):
        inner(name, seconds)
        torch.cuda.synchronize()
        seen.append((name, seconds, torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    ph.add = add
    try:
        yield seen
    finally:
        ph.add = inner


SCALE_LOG = 22


def phase_scale(torch, dev, report):
    """The 2^22 - 1 cycle bench guest (the largest MAX_CPU_LOG_DEGREE allows)
    proved twice with one key: by default, which is the low-memory mode for
    the main, permutation and quotient rounds (their tallest LDE reaches
    2^ZKBF_LOWMEM_LOG = 2^23 rows) with the LDEs in blocks of 8 columns, as
    the JAX package runs it; then with ZKBF_LOWMEM=0.  Both proofs verify and
    their bytes are equal.  For each: the launch counts (set to 0 just
    before the prove, read after its verify: every kernel must launch), the
    peak device memory, the phase seconds and the peak at the end of each
    phase.  Also the host seconds of a cold bit_reversal_perm(23), the
    table that query_open built before the query indices were reversed
    directly.  Returns the default mode's vk and proof bytes, phase seconds
    and phase peaks, which the mesh phase must match."""
    from zkvm_brainfuck_tpu_torch import ProverClient, guests
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn
    from zkvm_brainfuck_tpu_torch.ops import ntt as nt
    from zkvm_brainfuck_tpu_torch.stark import quotient as tquot

    t0 = time.time()
    nt.bit_reversal_perm.__wrapped__(SCALE_LOG + 1)  # uncached, so cold
    table_s = time.time() - t0
    say(f"[scale] bit_reversal_perm({SCALE_LOG + 1}) cold on the host: {table_s:.4f} s")
    torch.cuda.empty_cache()
    client = ProverClient()
    t0 = time.time()
    pk, vk = client.setup(guests.bench_guest(SCALE_LOG))
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    report["scale"] = {"log_cycles": SCALE_LOG, "bit_reversal_perm_23_s": table_s, "setup_s": setup_s}
    proofs, default = {}, None
    for mode, env in (("default (low-memory)", None), ("ZKBF_LOWMEM=0", "0")):
        if env is not None:
            os.environ["ZKBF_LOWMEM"] = env
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kn.reset_counts()
            plain_before = tquot.PLAIN_CALLS
            with phase_peaks(torch) as seen:
                proof = client.prove(pk, b"").run()
            torch.cuda.synchronize()
            peak = max([torch.cuda.max_memory_allocated()] + [b for _n, _s, b in seen])
            t0 = time.time()
            client.verify(proof, vk)
            verify_s = time.time() - t0
            counts = dict(kn.COUNTS)
        finally:
            os.environ.pop("ZKBF_LOWMEM", None)
        if proof.proof.cycles != (1 << SCALE_LOG) - 1:
            raise AssertionError(f"2^{SCALE_LOG} guest ran {proof.proof.cycles} cycles")
        missing = [k for k, v in counts.items() if v <= 0]
        if missing or tquot.PLAIN_CALLS != plain_before:
            raise AssertionError(f"kernels not launched by the {mode} 2^{SCALE_LOG} prove: "
                                 f"{missing}; {tquot.PLAIN_CALLS - plain_before} plain quotient "
                                 f"calls")
        proofs[mode] = proof.proof.proof.to_bytes()
        phases = dict(proof.proof.timings, verify=verify_s)
        if default is None:
            default = {"vk": vk.to_bytes(), "proof": proofs[mode],
                       "phases": dict(phases, setup=setup_s), "phase_peaks": seen}
        report["scale"][mode] = {"peak_bytes": peak, "phases_s": phases, "launches": counts,
                                 "phase_peaks": [[n, s, b] for n, s, b in seen]}
        say(f"[scale] {mode}: 2^{SCALE_LOG} - 1 cycles proved and verified; peak device memory "
            f"{peak / 2**30:.3f} GiB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
        say(f"[scale] {mode}: phases (s): " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()))
        say(f"[scale] {mode}: peak device memory at the end of each phase (GiB, since the previous "
            f"phase ended): " + ", ".join(f"{n} {b / 2**30:.3f}" for n, _s, b in seen))
        say(f"[scale] {mode}: launches: {counts}")
    a, b = proofs.values()
    if a != b:
        raise AssertionError("the low-memory and normal 2^22 proofs differ")
    say(f"[scale] the two modes' proofs are the same {len(a)} bytes")
    return default


def phase_lowmem(torch, dev, report):
    """The golden `printa` prove under ZKBF_LOWMEM=1 with every LDE height
    blocked (ZKBF_BLK_LOG=4) on the card must reproduce the JAX-made vk,
    1741-entry transcript and proof byte for byte.  Blocks of 4 columns
    (ZKBF_BLK_W=4) give digest layers of more blocks than one hash_rows
    launch takes (up to 15), so the wrapper's joining runs too.  The launch
    counts are set to 0 just before setup and read after verify: every
    kernel must have launched on this path."""
    from zkvm_brainfuck_tpu_torch import ProverClient, guests
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn
    from zkvm_brainfuck_tpu_torch.sdk import CpuProver

    env = {"ZKBF_LOWMEM": "1", "ZKBF_BLK_LOG": "4", "ZKBF_BLK_W": "4"}
    os.environ.update(env)
    try:
        config = recording_config()
        client = ProverClient(CpuProver(config=config))
        kn.reset_counts()
        t0 = time.time()
        pk, vk = client.setup(guests.PRINTA_BF)
        proof = client.prove(pk, b"").run()
        torch.cuda.synchronize()
        secs = time.time() - t0
        client.verify(proof, vk)
        counts = dict(kn.COUNTS)
    finally:
        for k in env:
            del os.environ[k]
    if not (pk.pk.data.lowmem and pk.pk.data.tree.flat is None):
        raise AssertionError("ZKBF_LOWMEM=1: the setup commit kept its LDEs or tree")
    check_golden_printa(vk, config.challengers[0].record, proof.proof.proof.to_bytes(), "low-memory")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the low-memory path: {missing}")
    report["lowmem"] = {"env": env, "setup_and_prove_s": secs, "launches": counts}
    say(f"[lowmem] printa with {env}: vk, 1741 transcript entries and proof bytes equal "
        f"tests/golden/*_printa_q84 (setup + prove {secs:.2f} s); launches {counts}")


MESH_SHARDS = 4  # shards of the virtual mesh on one card


@contextlib.contextmanager
def capturing(targets):
    """Inside the block, each (module, name, tag, pick) function passes its
    calls on and appends (tag, pick(its result)) to the yielded list."""
    seen, saved = [], []
    for module, name, tag, pick in targets:
        inner = getattr(module, name)

        def wrapper(*args, _inner=inner, _tag=tag, _pick=pick, **kwargs):
            out = _inner(*args, **kwargs)
            seen.append((_tag, _pick(out)))
            return out

        saved.append((module, name, inner))
        setattr(module, name, wrapper)
    try:
        yield seen
    finally:
        for module, name, inner in saved:
            setattr(module, name, inner)


MESH_PRINTA_ENVS = (("default", {}),
                    ("low-memory blocked", {"ZKBF_LOWMEM": "1", "ZKBF_BLK_LOG": "4", "ZKBF_BLK_W": "4"}))


def phase_mesh(torch, dev, report, single, scale):
    """printa in two modes, then the 2^20 - 1 and 2^22 - 1 cycle guests, over
    a row mesh; see the module docstring, item 14."""
    from zkvm_brainfuck_tpu_torch import ProverClient, guests
    from zkvm_brainfuck_tpu_torch.parallel.mesh import make_row_mesh, set_shard_mesh
    from zkvm_brainfuck_tpu_torch.sdk import CpuProver

    cards = torch.cuda.device_count()
    if 2 <= cards <= 16 and cards & (cards - 1) == 0:
        mesh = make_row_mesh(cards)
    else:
        mesh = make_row_mesh(devices=["cuda:0"] * MESH_SHARDS)
    info = {"shards": mesh.size, "cards": mesh.cards, "virtual": mesh.cards < mesh.size}
    say("[mesh] " + json.dumps(info))
    report["mesh"] = dict(info)

    for label, env in MESH_PRINTA_ENVS:
        config = recording_config()
        client = ProverClient(CpuProver(config=config))
        os.environ.update(env)
        set_shard_mesh(mesh)
        try:
            t0 = time.time()
            pk, vk = client.setup(guests.PRINTA_BF)
            proof = client.prove(pk, b"").run()
            secs = time.time() - t0
        finally:
            set_shard_mesh(None)
            for k in env:
                del os.environ[k]
        if pk.pk.data.mesh != mesh or pk.pk.data.lowmem != bool(env):
            raise AssertionError(f"{label}: the setup round is not on the mesh in its mode")
        check_golden_printa(vk, config.challengers[0].record, proof.proof.proof.to_bytes(),
                            f"mesh, {label}")
        client.verify(proof, vk)
        report["mesh"][f"printa {label}"] = {"env": env, "setup_and_prove_s": secs}
        say(f"[mesh] printa over {mesh.size} shards, {label} {env}: vk, 1741 transcript entries "
            f"and proof bytes equal tests/golden/*_printa_q84 (setup + prove {secs:.2f} s; on one "
            f"device {report['golden_main']['setup_and_prove_s']:.2f} s)")

    report["mesh"][f"2^{SLICE_LOG}"] = mesh_prove(torch, mesh, SLICE_LOG, single, "main phase")
    report["mesh"][f"2^{SCALE_LOG}"] = mesh_prove(torch, mesh, SCALE_LOG, scale, "scale phase")


def mesh_prove(torch, mesh, log_cycles, want, label):
    """The 2^log_cycles - 1 cycle guest set up and proved under `mesh` with
    the default settings.  Its vk and proof must be want's bytes (the
    single-device prove of the `label`), it must verify, and a tampered
    proof must be rejected.  The launch counts are set to 0 just before the
    setup and read after the verify: all eight kernels must launch, and the
    4-step NTT's local transform (ntt_block_stages + ntt_stage) must run on
    every shard.  The traces, each commit's LDEs (normal rounds) or evals
    (low-memory rounds), every LDE block made (committed, recomputed for
    the quotient or rebuilt for the queries), the leaf digests, the
    permutation traces and the quotient values must each hold at most
    1.01/d of their rows a shard; each is read as it is made, so nothing is
    kept alive.  Returns the record; prints the phase seconds beside want's,
    the peak at the end of each phase, the collective bytes by kind, the
    peak device memory, and the prove's stream time inside the 4-step NTT,
    its eager size-d DFT and twiddle (K16) and its local transform (CUDA
    events around each call)."""
    from zkvm_brainfuck_tpu_torch import ProverClient, guests
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn
    from zkvm_brainfuck_tpu_torch.parallel import collectives as co
    from zkvm_brainfuck_tpu_torch.parallel import sharded
    from zkvm_brainfuck_tpu_torch.parallel.mesh import set_shard_mesh, shard_fraction
    from zkvm_brainfuck_tpu_torch.stark import machine as stark_machine
    from zkvm_brainfuck_tpu_torch.stark import pcs
    from zkvm_brainfuck_tpu_torch.stark import prover as stark_prover
    from zkvm_brainfuck_tpu_torch.stark import quotient as tquot
    from zkvm_brainfuck_tpu_torch.stark.errors import VerificationFailure
    from zkvm_brainfuck_tpu_torch.stark.types import MachineProof

    def most(xs):
        return max(shard_fraction(x) for x in xs)

    def kept(out):
        data = out[1]
        return most(data.evals if data.lowmem else data.ldes)

    tag = f"[mesh] 2^{log_cycles}"
    targets = [(stark_prover, "place_rows", "traces", shard_fraction),
               (stark_machine, "place_rows", "traces", shard_fraction),
               (stark_machine, "pcs_commit", "kept LDEs or evals", kept),
               (stark_prover, "pcs_commit", "kept LDEs or evals", kept),
               (pcs, "_lde_blocks", "LDE blocks", most),
               (pcs, "sharded_digest_layer", "leaf digests", shard_fraction),
               (stark_prover, "generate_permutation_trace", "permutation traces",
                lambda out: shard_fraction(out[0])),
               (stark_prover, "quotient_values", "quotient values", shard_fraction)]
    client = ProverClient()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kn.reset_counts()
    co.reset_bytes()
    plain_before = tquot.PLAIN_CALLS
    set_shard_mesh(mesh)
    try:
        with capturing(targets) as seen, recording(
                [(sharded, "local_transform", "local", lambda z, log_m, inverse, shard: shard)]
        ) as local, phase_peaks(torch) as peaks, stream_events(
            torch, [(sharded, "four_step", "4-step NTT"), (sharded, "_dft_twiddle", "DFT and twiddle"),
                    (sharded, "local_transform", "local transform")]) as events:
            t0 = time.time()
            pk, vk = client.setup(guests.bench_guest(log_cycles))
            torch.cuda.synchronize()
            setup_s = time.time() - t0
            setup_bytes = dict(co.BYTES)
            after_setup = dict(kn.COUNTS)
            co.reset_bytes()
            for v in events.values():
                v.clear()
            proof = client.prove(pk, b"").run()
            torch.cuda.synchronize()
            prove_bytes = dict(co.BYTES)
    finally:
        set_shard_mesh(None)
    ntt_ms = {tag: [len(v), sum(a.elapsed_time(b) for a, b in v)] for tag, v in events.items()}
    peak = max([torch.cuda.max_memory_allocated()] + [b for _n, _s, b in peaks])
    t0 = time.time()
    client.verify(proof, vk)
    verify_s = time.time() - t0
    counts = dict(kn.COUNTS)
    missing = [k for k, v in counts.items() if v <= 0]
    if missing or tquot.PLAIN_CALLS != plain_before:
        raise AssertionError(f"kernels not launched on the 2^{log_cycles} mesh path: {missing}; "
                             f"{tquot.PLAIN_CALLS - plain_before} plain quotient calls")
    shards = sorted({note for _tag, note in local})
    if shards != list(range(mesh.size)) or counts["ntt_block_stages"] < len(local):
        raise AssertionError(f"the 4-step NTT's local transform ran on shards {shards} "
                             f"({len(local)} calls, {counts['ntt_block_stages']} block passes)")
    if proof.proof.cycles != (1 << log_cycles) - 1:
        raise AssertionError(f"the 2^{log_cycles} guest ran {proof.proof.cycles} cycles")
    data = proof.proof.proof.to_bytes()
    if vk.to_bytes() != want["vk"]:
        raise AssertionError(f"the 2^{log_cycles} mesh vk differs from the {label}'s")
    if data != want["proof"]:
        raise AssertionError(f"the 2^{log_cycles} mesh proof differs from the {label}'s")
    bad = copy.copy(proof)
    bad.proof = copy.copy(proof.proof)
    bad.proof.proof = MachineProof.from_bytes(data)
    c = bad.proof.proof.shard_proof.opened_values[0].cumulative_sum
    bad.proof.proof.shard_proof.opened_values[0].cumulative_sum = ((c[0] + 1) % 0x7F000001,) + c[1:]
    try:
        client.verify(bad, vk)
    except VerificationFailure as e:
        say(f"{tag} tampered proof rejected: {type(e).__name__}: {e}")
    else:
        raise AssertionError(f"a tampered 2^{log_cycles} mesh proof was accepted")

    worst = {}
    for what, frac in seen:
        worst[what] = max(worst.get(what, 0.0), frac)
    if set(worst) != {t[2] for t in targets} or any(v > 1.01 / mesh.size for v in worst.values()):
        raise AssertionError(f"a row-sharded intermediate holds more than 1/{mesh.size}: {worst}")
    phases = dict(proof.proof.timings, setup=setup_s, verify=verify_s)
    prove_counts = {k: counts[k] - after_setup[k] for k in counts}
    say(f"{tag} - 1 cycles over {mesh.size} shards: the {label}'s vk and {len(data)} proof bytes, "
        f"verified; peak device memory {peak / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB "
        "resident before the setup)")
    say(f"{tag} launches (setup + prove): {counts}; the 4-step NTT's local transform ran "
        f"{len(local)} times, on shards {shards}")
    say(f"{tag} launches (prove): {prove_counts}")
    say(f"{tag} phase seconds, mesh / single device ({label}): " + ", ".join(
        f"{k} {v:.4f} / {want['phases'].get(k, float('nan')):.4f}" for k, v in phases.items()))
    say(f"{tag} peak device memory at the end of each phase (GiB, since the previous phase "
        "ended): " + ", ".join(f"{n} {b / 2**30:.3f}" for n, _s, b in peaks))
    if "phase_peaks" in want:
        say(f"{tag} the same on a single device ({label}): " + ", ".join(
            f"{n} {b / 2**30:.3f}" for n, _s, b in want["phase_peaks"]))
    say(f"{tag} collective bytes a prove: {prove_bytes}; in setup: {setup_bytes}")
    say(f"{tag} largest shard fraction: " + ", ".join(f"{k} {v:.4f}" for k, v in worst.items()))
    say(f"{tag} stream time a prove inside (calls, ms): " + ", ".join(
        f"{k} {n} calls {ms:.3f} ms" for k, (n, ms) in ntt_ms.items())
        + f"; prove_total {1e3 * phases['prove_total']:.3f} ms")
    return {"ntt_stream_ms_prove": ntt_ms, "phases_s": phases, "single_phases_s": want["phases"], "peak_bytes": peak,
            "resident_bytes_before": resident, "phase_peaks": [[n, s, b] for n, s, b in peaks],
            "launches": counts, "launches_prove": prove_counts, "local_transform_calls": len(local),
            "collective_bytes_setup": setup_bytes, "collective_bytes_prove": prove_bytes,
            "shard_fraction_max": worst, "proof_bytes": len(data)}


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
    quotient_ptxas(report)

    kernels = phase_kernels(torch, dev, report)
    report["quotient_per_chip"] = kernels["quotient_eval"]["per_chip"]
    phase_golden(torch, dev, report)
    phase_golden_main(torch, dev, report)
    phase_slice(torch, dev, report)
    counts, client, pk, lde_calls, prove_bounds, commits, single = phase_main(torch, dev, report)
    phase_lde(torch, dev, report, lde_calls)
    phase_profile(torch, dev, report, client, pk, prove_bounds, commits)
    del client, pk
    phase_debug(torch, dev, report)
    phase_profile_trace(torch, dev, report)
    phase_lowmem(torch, dev, report)
    scale = phase_scale(torch, dev, report)
    phase_mesh(torch, dev, report, single, scale)

    line = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            **({"fused_into": FUSED[name]} if name in FUSED else {}),
            "launches": counts[FUSED.get(name, name)],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1],
            "library_ms": k.get("library_ms"),
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
