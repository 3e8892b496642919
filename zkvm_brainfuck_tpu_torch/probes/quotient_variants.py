#!/usr/bin/env python3
"""The quotient kernel's designs, timed in turns on one GPU.

    python3 zkvm_brainfuck_tpu_torch/probes/quotient_variants.py [--chips Cpu,Jump] [--variants all]

Each chip's generated body (stark/codegen.py, recorded once) is built into
several libraries, one nvcc each, all in parallel:

- `rowwise`: the skeleton before tiles (probes/quotient_rowwise.cuh: a
  thread a row, each column read from device memory once into a register
  and converted into Montgomery form there), with the body that skeleton
  took (`rowwise_text`: each value loaded at its place in the recording
  order, where the perm planes come first);
- `tile128`: the committed csrc/quotient.cuh (tiles of 128 rows staged in
  shared memory, 4 blocks an SM asked of __launch_bounds__): the library
  the proving path loads;
- copies of that header with a line changed (EDITS): `tile64`, tiles of
  64 rows and 8 blocks an SM; `tile128-minb2`, 2 blocks an SM (up to 255
  registers a thread); `tile128-merged`, tile reads that are not
  volatile, so that the compiler merges a column's reads into one value.

By default `rowwise` and `tile128` run for all 8 chips and the other three
for Cpu, AddSub and Jump.  Prints what ptxas reports for each library.
Then, for each chip at its main-path coset height (chip_smoke.py
QUOTIENT_LOG) on random columns, every variant is held bit for bit against
the plain version (stark/quotient.py quotient_rows_plain) and timed alone
(chip_smoke.py queued_ms: 20 launches queued behind a sleep, median of 3)
in turns: the variants in order, then in reverse, twice.  Prints the
card's name and power limit first and writes
chiprun_out/quotient_variants.json.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ROWWISE = os.path.join(HERE, "quotient_rowwise.cuh")
OUT = os.path.join(ROOT, "build", "probe_quotient")
VARIANTS = ("rowwise", "tile128", "tile64", "tile128-minb2", "tile128-merged")
# name -> (text, replacement) of each line of csrc/quotient.cuh that the
# variant's copy of the header changes
EDITS = {
    "tile64": [("constexpr int TILE = 128;", "constexpr int TILE = 64;"),
               ("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 8;")],
    "tile128-minb2": [("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 2;")],
    "tile128-merged": [("typedef const volatile uint32_t* TileRow;",
                        "typedef const uint32_t* TileRow;")],
}
WIDE = ("Cpu", "AddSub", "Jump")  # the chips every variant runs for by default
SIGNATURE = ("body(const Args& a, long long r, TileRow lp, TileRow np,\n"
             "                                     uint32_t acc[4])")


def _digest(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()[:16]


def rowwise_text(prog) -> str:
    """The body as the row-wise skeleton takes it: each (column, row)
    value loaded once into a named value, `v<i> = ld(a, w, c, next)`,
    placed at its node's place in the recording order (node i of
    prog.rec.ops), and every tile read of it replaced by that name."""
    text = prog.text
    assert SIGNATURE in text
    node = {(a, bool(b)): i for i, (op, a, b) in enumerate(prog.rec.ops) if op == "ld"}
    used = {(int(c), w == "np") for w, c in re.findall(r"\b(lp|np)\[(\d+)\]", text)}
    head, rest = text.split(SIGNATURE + " {\n")
    body, tail = rest.split("\n}\n", 1)
    lines = [(int(re.match(r"  const uint32_t v(\d+) =", ln).group(1)), ln)
             for ln in body.splitlines() if ln.startswith("  const uint32_t v")]
    lines += [(node[k], f"  const uint32_t v{node[k]} = ld(a, w, {k[0]}, {str(k[1]).lower()});")
              for k in used]
    acc = [ln for ln in body.splitlines() if ln.startswith("  acc[")]
    out = "\n".join([ln for _i, ln in sorted(lines)] + acc)
    out = re.sub(r"\b(lp|np)\[(\d+)\]", lambda m: f"v{node[(int(m.group(2)), m.group(1) == 'np')]}",
                 out).replace("sel(a, r, ", "sel(a, w, ")
    head = head.replace('#include "quotient.cuh"', f'#include "{ROWWISE}"')
    return (f"// {ROWWISE} {_digest(ROWWISE)}\n{head}"
            "body(const Args& a, const Row& w, uint32_t acc[4]) {\n" + out + "\n}\n" + tail)


def variant_text(prog, variant: str) -> str:
    """The chip's generated source for a variant; a header the variant
    includes instead of csrc/quotient.cuh is named by its path and digest,
    so that the library's name (a hash of the text) follows it."""
    text = prog.text
    from zkvm_brainfuck_tpu_torch import build

    if variant == "tile128":
        return text
    if variant == "rowwise":
        return rowwise_text(prog)
    with open(os.path.join(build.CSRC, build.QUOTIENT_HEADER)) as fh:
        header = fh.read()
    for old, new in EDITS[variant]:
        assert old in header
        header = header.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"quotient_{variant}.cuh")
    with open(path, "w") as fh:
        fh.write(header)
    return (f"// {path} {_digest(path)}\n"
            + text.replace('#include "quotient.cuh"', f'#include "{path}"'))


def ptxas(log: str) -> dict:
    regs = re.search(r"Used (\d+) registers", log)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None}


def rowwise_launch(torch, kn, lib, prog, blocks, sels, step, words, out):
    """A launch of the row-wise skeleton: its table of one entry a column."""
    from zkvm_brainfuck_tpu_torch.ops.quotient import SELECTORS

    local, strides = [], []
    for b in blocks:
        for c in range(int(b.shape[1])):
            local.append(b.data_ptr() + 4 * c)
            strides.append(b.stride(0))
    n = len(local)
    keep = [(ctypes.c_void_p * n)(*local), (ctypes.c_int * n)(*strides),
            (ctypes.c_void_p * 4)(*[sels[s].data_ptr() for s in SELECTORS])]
    args = (ctypes.addressof(keep[0]), ctypes.addressof(keep[0]), ctypes.addressof(keep[1]),
            ctypes.addressof(keep[1]), n, ctypes.addressof(keep[2]), words.ctypes.data,
            len(words), int(out.shape[0]), step, out.data_ptr(), kn.stream())

    def launch():
        kn.check(lib.zkbf_quotient(*args), f"rowwise {prog.name}")

    launch.keep = keep
    return launch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", default="all", help="comma-separated chip names, or all")
    ap.add_argument("--variants", default="default",
                    help="comma-separated variants, `all`, or `default` (see the docstring)")
    ap.add_argument("--out", default="quotient_variants.json")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("quotient_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import numpy as np

    from zkvm_brainfuck_tpu_torch import build
    from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn
    from zkvm_brainfuck_tpu_torch.ops import quotient as oq
    from zkvm_brainfuck_tpu_torch.ops.field import P
    from zkvm_brainfuck_tpu_torch.stark import codegen
    from zkvm_brainfuck_tpu_torch.stark import quotient as tquot
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.domains import Domain, selectors_on_coset

    smi = cs.nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    chips = [Chip(a) for a in brainfuck_chips()
             if opts.chips == "all" or a.name in opts.chips.split(",")]
    plan = {}
    for chip in chips:
        if opts.variants == "default":
            plan[chip.name] = VARIANTS if chip.name in WIDE else VARIANTS[:2]
        else:
            plan[chip.name] = VARIANTS if opts.variants == "all" else opts.variants.split(",")
    texts = {f"{c.name}__{v}": variant_text(codegen.program(c), v)
             for c in chips for v in plan[c.name]}
    libs = build.build_generated(texts)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "chips": {}}
    for key in texts:
        print(f"[ptxas] {key}: {ptxas(build.LOGS.get(key, ''))}", flush=True)

    rng = np.random.default_rng(11)
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return torch.randint(0, P, shape, generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)

    def ef():
        return tuple(int(x) for x in rng.integers(0, P, 4))

    for chip in chips:
        prog = codegen.program(chip)
        log_q = cs.QUOTIENT_LOG[chip.name]
        nq = 1 << log_q
        td = Domain(log_q - 1, 1)
        qd = td.create_disjoint_domain(nq)
        sels = selectors_on_coset(td.log_n, qd.log_n, qd.shift, "cuda")
        main = [rand(nq, chip.width)]
        prep = [rand(nq, chip.preprocessed_width)] if chip.preprocessed_width else None
        perm = [rand(nq, 4 * chip.permutation_width)]
        ch = dict(perm_challenges=(ef(), ef()), alpha=ef(), cumulative_sum=ef())
        want = tquot.quotient_rows_plain(chip, main, prep, perm, sels, 2, **ch)
        launches, outs = {}, {}
        for v in plan[chip.name]:
            vp, i = ctypes.c_void_p, ctypes.c_int
            argtypes = ({"zkbf_set_device": [i],
                         "zkbf_quotient": [vp, vp, vp, vp, i, vp, vp, i, i, i, vp, vp]}
                        if v == "rowwise" else kn._ARGTYPES["quotient"])
            lib = kn._open(libs[f"{chip.name}__{v}"], argtypes)
            kn.check(lib.zkbf_set_device(torch.cuda.current_device()), "zkbf_set_device")
            if v == "rowwise":
                out = torch.empty((nq, 4), dtype=torch.int32, device="cuda")
                words = prog.params(**ch)
                blocks = main + (prep or []) + perm
                launches[v] = rowwise_launch(torch, kn, lib, prog, blocks, sels, 2, words, out)
            else:
                launch = oq.Launch(chip, main, prep, perm, sels, 2, **ch)
                launch.lib = lib
                out = launch.out
                launches[v] = launch
            outs[v] = out
            launches[v]()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{chip.name} {v}: kernel != plain")
        order = list(plan[chip.name]) + list(reversed(plan[chip.name]))
        times = {v: [] for v in plan[chip.name]}
        for v in order * 2:
            times[v].append(cs.queued_ms(torch, launches[v]))
        bound = cs.quotient_bound_converting(chip, main, prep, perm, sels, 2, halo=None,
                                             conversions=False)
        rec = {}
        for v in plan[chip.name]:
            rec[v] = {"ms": times[v], "median_ms": statistics.median(times[v]),
                      **ptxas(build.LOGS.get(f"{chip.name}__{v}", ""))}
            print(f"[variants] {chip.name} at {nq} coset rows, {v}: bit-exact; median "
                  f"{rec[v]['median_ms']:.4f} ms ({100 * bound[0] / rec[v]['median_ms']:.1f} % of "
                  f"its {bound[0]:.4f} ms bound) over turns "
                  f"{', '.join(f'{t:.4f}' for t in times[v])}; {rec[v]['registers']} registers, "
                  f"spill {rec[v]['spill_stores']} / {rec[v]['spill_loads']} bytes", flush=True)
        report["chips"][chip.name] = {"coset_rows": nq, "bound_ms": bound[0], "variants": rec}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", opts.out), "w") as fh:
        json.dump(report, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
