#!/usr/bin/env python3
"""The opening kernels' designs, timed in turns on one GPU.

    python3 zkvm_brainfuck_tpu_torch/probes/openings_variants.py [--out openings_variants.json]

Builds, one nvcc each, all in parallel:

- `rowwise`: the kernels before the tensor-core design
  (probes/openings_rowwise.cu: every column product a Montgomery product
  on the INT32 lanes, staging and compute taking turns);
- `cp-async`: the first tensor-core design (probes/openings_cp_async.cu:
  every thread issues 4-byte cp.async copies of the next tile, then
  computes, two __syncthreads a tile);
- `tensor`: the committed csrc/openings.cu, the library the proving path
  loads;
- copies of csrc/openings.cu with lines changed (EDITS), to see what bounds
  it: `no-inverse` (the row's EF4 inverse replaced by its input),
  `no-mma` (the products skipped), `staging-only` (both skipped: the tiles'
  copies, the weights' or rows' stores and the reduced-opening rows).
  These give wrong values and are timed only.

Prints what ptxas reports and the IMMA instructions of each library's two
kernels.  Then, at the main path's largest opening unit (chip_smoke.py
OPEN_UNIT_WIDTHS on 2^21 rows) and at Byte's unit (2^17 rows x 2 + 2 + 8 +
4 + 4 columns, on every prove), on random members, each of `rowwise`,
`cp-async` and `tensor` is held bit for bit against the plain versions (open_eval_plain,
ro_accum_plain adding in place), and every variant's open_eval and
ro_accum (adding) are timed alone (chip_smoke.py queued_ms: 20 launches
queued behind a sleep, median of 3) in turns: the variants in order, then
in reverse, twice.  Prints the median of the 4 turns and their spread
beside each kernel's bound (chip_smoke.py launch_bounds), the card's name
and power limit, and writes chiprun_out/<out>.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ROWWISE = os.path.join(HERE, "openings_rowwise.cu")
CP_ASYNC = os.path.join(HERE, "openings_cp_async.cu")
OUT = os.path.join(ROOT, "build", "probe_openings")
VARIANTS = ("rowwise", "cp-async", "tensor", "no-inverse", "no-mma", "staging-only")
EXACT = ("rowwise", "cp-async", "tensor")
NO_INVERSE = [("const E4 inv = inv_x_minus_z(x, z_m);",  # both kernels' inverse threads
               "const E4 inv = {{x, z_m.c[1], z_m.c[2], x}};")]
NO_MMA = [("  for (int st = warp; st < m.steps; st += OPEN_WARPS) {\n    const int2 d = s_step[st];",
           "  for (int st = warp; st < 0; st += OPEN_WARPS) {\n    const int2 d = s_step[st];"),
          ("    for (int k = 0; k < m.count; ++k) {\n      const int w = m.width[k];\n      const uint32_t* fa",
           "    for (int k = 0; k < 0; ++k) {\n      const int w = m.width[k];\n      const uint32_t* fa")]
# name -> (text, replacement) of each line of csrc/openings.cu that the
# variant's copy changes
EDITS = {"no-inverse": NO_INVERSE, "no-mma": NO_MMA, "staging-only": NO_INVERSE + NO_MMA}
UNITS = {"largest unit": (21, (7, 31, 16, 36, 4, 4, 4, 4)), "Byte's unit": (17, (2, 2, 8, 4, 4))}


def sources() -> dict:
    """{variant: source path}, each edited copy written into OUT."""
    from zkvm_brainfuck_tpu_torch import build

    committed = os.path.join(build.CSRC, "openings.cu")
    with open(committed) as fh:
        text = fh.read()
    out = {"rowwise": ROWWISE, "cp-async": CP_ASYNC, "tensor": committed}
    os.makedirs(OUT, exist_ok=True)
    for name, edits in EDITS.items():
        copy = text
        for old, new in edits:
            assert old in copy, (name, old)
            copy = copy.replace(old, new)
        path = os.path.join(OUT, f"openings_{name}.cu")
        with open(path, "w") as fh:
            fh.write(copy)
        out[name] = path
    return out


def build_variants() -> dict:
    """{variant: library path}, every missing one built (nvcc, in parallel);
    a library is named by its source's digest and the flags."""
    from zkvm_brainfuck_tpu_torch import build

    headers = [os.path.join(build.CSRC, h) for h in build.CUDA_HEADERS]
    jobs = {}
    for name, src in sources().items():
        key = build._digest([src] + headers, build.NVCC_FLAGS)
        jobs[name] = (src, os.path.join(OUT, f"libzkbf_openings_{name}_{key}.so"))
    return build._nvcc_all(jobs, verbose=False)


class Lib:
    """Launches of one variant's library: the wrappers' ctypes calls
    (ops/openings.py), with their scratch and outputs made once."""

    def __init__(self, torch, path):
        from zkvm_brainfuck_tpu_torch.ops import kernels as kn

        self.torch, self.kn = torch, kn
        self.lib = kn._open(path, kn._ARGTYPES["openings.cu"])
        kn.check(self.lib.zkbf_set_device(torch.cuda.current_device()), "zkbf_set_device")

    def open_eval(self, mats, z, log_m, shift):
        from zkvm_brainfuck_tpu_torch.ops import field as xf
        from zkvm_brainfuck_tpu_torch.ops import openings as op

        torch, kn = self.torch, self.kn
        total = sum(int(m.shape[1]) for m in mats)
        out = torch.empty((total, 4), dtype=torch.int32, device="cuda")
        scratch = torch.empty(self.lib.zkbf_open_eval_scratch_words(total), dtype=torch.int64,
                              device="cuda")
        ptrs, widths = op._member_arrays(mats)
        zw = op._words(z)
        args = (ctypes.addressof(ptrs), ctypes.addressof(widths), len(mats), int(mats[0].shape[0]),
                xf.two_adic_root(log_m), shift, 0, ctypes.addressof(zw), out.data_ptr(),
                scratch.data_ptr(), kn.stream())

        def launch():
            kn.check(self.lib.zkbf_open_eval(*args), "open_eval")
            return out

        launch.keep = (ptrs, widths, zw, scratch)
        return launch

    def ro_accum(self, ro, mats, aps, s, z, log_m, shift):
        from zkvm_brainfuck_tpu_torch.ops import field as xf
        from zkvm_brainfuck_tpu_torch.ops import openings as op

        kn = self.kn
        ptrs, widths = op._member_arrays(mats)
        zw, sw = op._words(z), op._words(s)
        args = (ctypes.addressof(ptrs), ctypes.addressof(widths), len(mats), int(mats[0].shape[0]),
                xf.two_adic_root(log_m), shift, 0, ctypes.addressof(zw), ctypes.addressof(sw),
                aps.data_ptr(), ro.data_ptr(), 0, kn.stream())

        def launch():
            kn.check(self.lib.zkbf_ro_accum(*args), "ro_accum")
            return ro

        launch.keep = (ptrs, widths, zw, sw)
        return launch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="openings_variants.json")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("openings_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import numpy as np

    from zkvm_brainfuck_tpu_torch import build
    from zkvm_brainfuck_tpu_torch.ops import openings as op
    from zkvm_brainfuck_tpu_torch.ops.field import GENERATOR, P

    smi = cs.nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    paths = build_variants()
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "build": {}, "units": {}}
    for v in VARIANTS:
        info = cs.openings_sass(paths[v], build.LOGS.get(v, ""))
        report["build"][v] = info
        print(f"[ptxas] {v}: " + "; ".join(
            f"{fn} {i['registers']} registers, spill {i['spill_stores']} / {i['spill_loads']}, "
            f"{i['imma']} IMMA" for fn, i in info.items()), flush=True)
    libs = {v: Lib(torch, paths[v]) for v in VARIANTS}
    bounds = {k: b[2] for k, b in cs.launch_bounds().items()}

    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda").manual_seed(12)

    def rand(*shape):
        return torch.randint(0, P, shape, generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)

    def ef():
        return tuple(int(x) for x in rng.integers(0, P, 4))

    for unit, (log_m, widths) in UNITS.items():
        h = 1 << log_m
        mats = [rand(h, w) for w in widths]
        z, s = ef(), ef()
        aps = rand(sum(widths), 4)
        base = rand(h, 4)
        want_o = op.open_eval_plain(mats, z, log_m, GENERATOR)
        want_r = op.ro_accum_plain(base.clone(), mats, aps, s, z, log_m, GENERATOR)
        launches = {}
        for v in VARIANTS:
            ro = base.clone()
            launches[v] = {"open_eval": libs[v].open_eval(mats, z, log_m, GENERATOR),
                           "ro_accum": libs[v].ro_accum(ro, mats, aps, s, z, log_m, GENERATOR)}
            if v in EXACT:
                got_o = launches[v]["open_eval"]()
                got_r = launches[v]["ro_accum"]()
                torch.cuda.synchronize()
                if not torch.equal(got_o, want_o):
                    raise AssertionError(f"{unit} {v}: open_eval != plain")
                if not torch.equal(got_r, want_r):
                    raise AssertionError(f"{unit} {v}: ro_accum != plain")
        rec = {}
        for kernel in ("open_eval", "ro_accum"):
            bound = (bounds["open_eval"](mats, z, log_m, GENERATOR) if kernel == "open_eval"
                     else bounds["ro_accum"](base, mats, aps, s, z, log_m, GENERATOR))
            times = {v: [] for v in VARIANTS}
            for v in (list(VARIANTS) + list(reversed(VARIANTS))) * 2:
                times[v].append(cs.queued_ms(torch, launches[v][kernel]))
            rec[kernel] = {"bound_ms": bound[0], "bound_by": bound[1], "variants": {}}
            for v in VARIANTS:
                med = statistics.median(times[v])
                spread = max(times[v]) - min(times[v])
                rec[kernel]["variants"][v] = {"ms": times[v], "median_ms": med, "spread_ms": spread}
                print(f"[variants] {kernel} at {unit} (2^{log_m} x {'+'.join(map(str, widths))}), "
                      f"{v}{': bit-exact' if v in EXACT else ' (timed only)'}; median {med:.4f} ms "
                      f"(spread {spread:.4f}; {100 * bound[0] / med:.1f} % of its {bound[0]:.4f} ms "
                      f"bound, {bound[1]}) over turns {', '.join(f'{t:.4f}' for t in times[v])}",
                      flush=True)
        report["units"][unit] = {"log_m": log_m, "widths": widths, **rec}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", opts.out), "w") as fh:
        json.dump(report, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
