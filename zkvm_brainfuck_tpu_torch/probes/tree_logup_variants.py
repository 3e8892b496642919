#!/usr/bin/env python3
"""The variants of the Poseidon2 tree walk and of logup_entries, timed on one GPU.

    python3 zkvm_brainfuck_tpu_torch/probes/tree_logup_variants.py

Builds the committed csrc/poseidon2.cu and csrc/logup.cu and copies of
them that differ in a few constants (VARIANTS): for the tree walk, the
levels of the bulk pass (BULK_LEVELS: 2 or 3) with its register cap
(BULK_MIN_BLOCKS: 12 or 16 blocks of 128 threads an SM), the register cap
of `tree_kernel` (TREE_MIN_BLOCKS: 4 or 8 blocks of 256 threads) and the
crossover below which a level takes 16 lanes a state (TREE_CROSSOVER: 16,
32, 64 or 128 nodes); for the fused LogUp kernel (`logup_entries`, through
`logup_trace`), the threads a row (ENTRY_LANES: 1, 2 or 4) by the register
cap (ENTRY_MIN_BLOCKS: 1, 6 or 8 blocks of 128 threads), the look-back lag
(LAG_PERCENT: 0 = every tile resolves itself before its store, 50, 200),
and a copy without the running sum (FUSED_SCAN 0: column NB keeps the row
sums), timed alone and followed by the three-pass scan the port ran before
(probes/logup_three_pass.cu).  The committed values are 2 bulk levels,
caps 16, 4 and 8, crossover 32, 2 lanes and a lag of 100.  One nvcc each,
in parallel, into build/probe_variants/; prints what ptxas reports for
each.  Then, with CUDA events (median of 5 calls after a warm-up), on
random inputs, each variant through the port's own wrappers:

- `poseidon2_tree` (at most two launches a tree), beside a walk of one
  `poseidon2_permute` launch a level (and one more a compress-and-inject
  level), over three loads: the main commit's tree (2^21 leaves, injects
  at the LDE heights of the 8 chips), the 20 FRI trees of a prove back to
  back (stark/fri.py commits layers of 2^21 .. 2^2 EF4 values, each paired
  into a tree of half as many leaves: 2^20 .. 2), and one 2^16-leaf tree;
- `logup_trace` for the Cpu chip at 2^20 rows and for the 8 chips at
  their main-path heights back to back.

Every result is checked against the plain version first (the copy without
the running sum against `logup_entries_plain` alone, and with the
three-pass scan against the plain composition).  Both sweeps run
twice, in turns, to show the spread.  Prints the card's name and power
limit first and writes chiprun_out/tree_logup_variants.json.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(ROOT, "zkvm_brainfuck_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "probe_variants")
# (source, {constant: value}); {} is the committed source.
VARIANTS = [("poseidon2.cu", {}), ("poseidon2.cu", {"BULK_MIN_BLOCKS": 12}),
            ("poseidon2.cu", {"BULK_LEVELS": 3}),
            ("poseidon2.cu", {"BULK_LEVELS": 3, "BULK_MIN_BLOCKS": 12}),
            ("poseidon2.cu", {"TREE_MIN_BLOCKS": 8})]
VARIANTS += [("poseidon2.cu", {"TREE_CROSSOVER": c}) for c in (16, 64, 128)]
VARIANTS += [("logup.cu", {"ENTRY_LANES": lanes, "ENTRY_MIN_BLOCKS": c})
             for c in (1, 6, 8) for lanes in (1, 2, 4)]
VARIANTS += [("logup.cu", {"LAG_PERCENT": lag}) for lag in (0, 50, 200)]
VARIANTS += [("logup.cu", {"FUSED_SCAN": 0}), ("logup_three_pass.cu", {})]
NO_SCAN = "logup.cu FUSED_SCAN 0"
THREE_PASS = "logup_three_pass.cu committed"
HEIGHTS = (("Cpu", 20), ("AddSub", 20), ("Jump", 19), ("Program", 17), ("Byte", 16),
           ("MemoryInstrs", 12), ("IO", 4), ("Memory", 4))


def cuda_ms(torch, fn, reps: int = 5) -> float:
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


def build_variants():
    """{name: (source, library path, ptxas summary)} of every variant."""
    from zkvm_brainfuck_tpu_torch import build

    procs = []
    for src, values in VARIANTS:
        name = f"{src} " + (", ".join(f"{k} {v}" for k, v in values.items()) or "committed")
        d = os.path.join(OUT, re.sub(r"\W+", "_", name))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(HERE if src == "logup_three_pass.cu" else CSRC, src)) as fh:
            text = fh.read()
        for const, value in values.items():
            text, hits = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                                 text)
            assert hits == 1, (src, const)
        with open(os.path.join(d, src), "w") as fh:
            fh.write(text)
        for header in build.CUDA_HEADERS:
            shutil.copy(os.path.join(CSRC, header), d)
        lib = os.path.join(d, "lib.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, os.path.join(d, src)]
        procs.append((src, name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True)))
    out = {}
    for src, name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernels = {"poseidon2.cu": ("tree_kernel", "bulk_kernel"), "logup.cu": ("entries_kernel",),
                   "logup_three_pass.cu": ("scan_tiles_kernel", "scan_totals_kernel",
                                           "scan_carry_kernel")}[src]
        summary = []
        for m in re.finditer(r"Function properties for (\S+)\n\s+(\d+) bytes stack frame, (\d+) bytes "
                             r"spill stores, (\d+) bytes spill loads\nptxas info\s+: Used (\d+) "
                             r"registers", log):
            kernel = next((k for k in kernels if k in m.group(1)), None)
            if kernel:
                summary.append(f"{kernel}: {m.group(5)} registers, {m.group(3)} B spilled")
        out[name] = (src, lib, summary)
        print(f"[build] {name}: " + "; ".join(summary), flush=True)
    return out


def load(kn, src, path):
    """Put the library at `path` in place of csrc/<src> for the wrappers."""
    from zkvm_brainfuck_tpu_torch.ops.poseidon2 import montgomery_constants

    handle = ctypes.CDLL(path)
    if src == "logup_three_pass.cu":
        # (perm, n, nb, totals, stream)
        handle.zkbf_logup_scan.argtypes = [kn._P, kn._I, kn._I, kn._P, kn._P]
        return handle
    for fn, argtypes in kn._ARGTYPES[src].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = kn._RESTYPES.get(fn, ctypes.c_int)
    if src == "poseidon2.cu":
        arrays = [(ctypes.c_uint32 * len(c))(*c) for c in montgomery_constants()]
        kn.check(handle.zkbf_p2_set_constants(*[ctypes.addressof(a) for a in arrays]), "constants")
    kn._LIBS[src] = handle


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tree_logup_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn
    from zkvm_brainfuck_tpu_torch.ops import logup as lu
    from zkvm_brainfuck_tpu_torch.ops import merkle as mk
    from zkvm_brainfuck_tpu_torch.ops import poseidon2 as p2
    from zkvm_brainfuck_tpu_torch.ops.field import P
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.permutation import host_beta_pows, logup_table

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; {smi}", flush=True)
    variants = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape):
        return torch.randint(0, P, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    def by_levels(plan, digests):
        """The tree walk before poseidon2_tree: a permute launch per level."""
        inject = dict(plan.inject_levels)
        top = digests[plan.max_h]
        flat = torch.empty((plan.flat_len, 8), dtype=torch.int32, device=dev)
        flat[: plan.max_h] = top
        prev = top
        for i in range(1, plan.log_max + 1):
            s = plan.max_h >> i
            out = p2.permute(prev.reshape(s, 16), out_cols=8)
            if i in inject:
                out = p2.compress(out, digests[inject[i]])
            flat[plan.level_off[i] : plan.level_off[i] + s] = out
            prev = out
        return flat

    n = 1 << 21
    loads = {
        "main commit tree (2^21 leaves)": [(n, n >> 1, n >> 3, n >> 4, n >> 8, n >> 16)],
        "20 FRI trees (2^20 .. 2 leaves)": [(1 << k,) for k in range(20, 0, -1)],
        "one 2^16-leaf tree": [(1 << 16,)],
    }
    trees = {}
    for name, shapes in loads.items():
        trees[name] = []
        for heights in shapes:
            plan = mk.make_plan(heights)
            digests = {h: rand(h, 8) for h in heights}
            trees[name].append((plan, digests, mk.build_tree_plain(plan, digests)))

    def time_tree(walk):
        row = {}
        for name, ts in trees.items():
            for plan, digests, want in ts:
                if not torch.equal(walk(plan, digests), want):
                    raise AssertionError(f"{name}: differs from build_tree_plain")
            row[name] = cuda_ms(torch, lambda: [walk(p, d) for p, d, _w in ts])
        return row

    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "ptxas": {k: v[2] for k, v in variants.items()}, "tree": [], "logup": []}
    tree_variants = [k for k, v in variants.items() if v[0] == "poseidon2.cu"]
    for rnd, order in enumerate((tree_variants, tree_variants[::-1])):
        for name in order:
            load(kn, "poseidon2.cu", variants[name][1])
            if name == order[0]:
                row = time_tree(by_levels)
                report["tree"].append({"round": rnd, "variant": "per-level permute launches", "ms": row})
                print(f"[tree] round {rnd} per-level permute launches: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
            row = time_tree(mk.build_tree)
            report["tree"].append({"round": rnd, "variant": name, "ms": row})
            print(f"[tree] round {rnd} {name}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    del trees
    torch.cuda.empty_cache()

    rng = np.random.default_rng(9)
    chips = {a.name: Chip(a) for a in brainfuck_chips()}
    cases = []
    for name, log_n in HEIGHTS:
        chip = chips[name]
        rows = 1 << log_n
        main_t = rand(rows, chip.width)
        prep = rand(rows, chip.preprocessed_width) if chip.preprocessed_width else None
        beta = tuple(int(x) for x in rng.integers(0, P, 4))
        chal = lu.challenge_matrix(rng.integers(0, P, 4), host_beta_pows(chip, beta), dev)
        table = logup_table(chip)
        entries = lu.logup_entries_plain(table, main_t, prep, chal)
        phi = entries.clone()
        cases.append((table, main_t, prep, chal, entries, phi, lu.logup_scan_plain(phi)))
    three_pass = load(kn, "logup_three_pass.cu", variants[THREE_PASS][1])

    def entries_then_scan(table, main_t, prep, chal):
        """The entries-only copy, then the three-pass scan of column NB."""
        perm, _ = lu.logup_trace(table, main_t, prep, chal)
        n = perm.shape[0]
        totals = torch.empty(4 * ((n + 1023) // 1024), dtype=torch.int32, device=dev)
        kn.check(three_pass.zkbf_logup_scan(perm.data_ptr(), n, table.nb, totals.data_ptr(),
                                            kn.stream()), "zkbf_logup_scan")
        return perm, perm[n - 1, table.nb].clone()

    entry_variants = [k for k, v in variants.items() if v[0] == "logup.cu"]
    entry_variants.append(THREE_PASS)
    for rnd, order in enumerate((entry_variants, entry_variants[::-1])):
        for name in order:
            load(kn, "logup.cu", variants[NO_SCAN if name == THREE_PASS else name][1])
            run = entries_then_scan if name == THREE_PASS else lu.logup_trace
            for table, main_t, prep, chal, entries, phi, csum in cases:
                perm, got_csum = run(table, main_t, prep, chal)
                ok = (torch.equal(perm, entries) if name == NO_SCAN
                      else torch.equal(perm, phi) and torch.equal(got_csum, csum))
                if not ok:
                    raise AssertionError(f"logup_trace {table.n_inter} interactions, "
                                         f"{name}: differs from plain")
            cpu = cases[0]
            row = {"Cpu 2^20": cuda_ms(torch, lambda: run(*cpu[:4])),
                   "8 chips": cuda_ms(torch, lambda: [run(*c[:4]) for c in cases])}
            label = f"{NO_SCAN} + three-pass scan" if name == THREE_PASS else name
            report["logup"].append({"round": rnd, "variant": label, "ms": row})
            print(f"[logup] round {rnd} {label}: Cpu 2^20 {row['Cpu 2^20']:.4f} ms, "
                  f"8 chips at their main-path heights {row['8 chips']:.4f} ms", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tree_logup_variants.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
