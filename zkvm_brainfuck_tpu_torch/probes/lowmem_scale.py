#!/usr/bin/env python3
"""The 2^22 - 1 cycle bench guest proved in turns in the PCS memory modes, on one GPU.

    python3 zkvm_brainfuck_tpu_torch/probes/lowmem_scale.py [--modes default,0,0,default]
        [--log 22] [--root DIR] [--out lowmem_scale.json]

Sets up the guest once, then proves it once per entry of --modes, in that
order: `default` leaves ZKBF_LOWMEM unset (at 2^22 the main, permutation
and quotient rounds are low-memory, the preprocessed round normal), `0`
and `1` set it.  Each proof is verified, and all must be the same bytes.
For each prove it prints the phase seconds, the peak device memory and
the peak at the end of each phase (chip_smoke.py `phase_peaks`).  Turns
such as default,0,0,default put each mode once first and once last in the
process, since the first prove at a size builds the NTT and domain tables
that later ones find cached.  --root proves with the package of another
checkout (an unpacked parent commit, where the knob may mean nothing).
Prints the card's name and power limit first and the host seconds of a
cold bit_reversal_perm(23); writes chiprun_out/<--out>.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="default,0,0,default")
    ap.add_argument("--log", type=int, default=22)
    ap.add_argument("--root", default=ROOT, help="checkout whose package proves")
    ap.add_argument("--out", default="lowmem_scale.json", help="file name under chiprun_out/")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("lowmem_scale: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import nvidia_smi_line, phase_peaks

    sys.path.insert(0, os.path.abspath(args.root))
    from zkvm_brainfuck_tpu_torch import ProverClient, build, guests
    from zkvm_brainfuck_tpu_torch.ops import ntt as nt

    smi = nvidia_smi_line()
    print(f"{smi}; package from {os.path.relpath(os.path.abspath(args.root), ROOT) or '.'}", flush=True)
    build.build_all()
    t0 = time.time()
    nt.bit_reversal_perm.__wrapped__(args.log + 1)
    table_s = time.time() - t0
    print(f"bit_reversal_perm({args.log + 1}) cold on the host: {table_s:.4f} s", flush=True)

    client = ProverClient()
    t0 = time.time()
    pk, vk = client.setup(guests.bench_guest(args.log))
    torch.cuda.synchronize()
    out = {"nvidia_smi": smi, "root": args.root, "log_cycles": args.log,
           "bit_reversal_perm_s": table_s, "setup_s": time.time() - t0, "proves": []}
    first = None
    for mode in args.modes.split(","):
        if mode != "default":
            os.environ["ZKBF_LOWMEM"] = mode
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with phase_peaks(torch) as seen:
                proof = client.prove(pk, b"").run()
            torch.cuda.synchronize()
            peak = max([torch.cuda.max_memory_allocated()] + [b for _n, _s, b in seen])
        finally:
            os.environ.pop("ZKBF_LOWMEM", None)
        client.verify(proof, vk)
        data = proof.proof.proof.to_bytes()
        first = data if first is None else first
        if data != first:
            raise AssertionError(f"mode {mode}: the proof differs from the first one")
        t = proof.proof.timings
        out["proves"].append({"mode": mode, "peak_bytes": peak, "phases_s": t,
                              "phase_peaks": [[n, s, b] for n, s, b in seen]})
        print(f"[{mode}] peak {peak / 2**30:.3f} GiB; " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()), flush=True)
        print(f"[{mode}] peak at the end of each phase (GiB): " + ", ".join(
            f"{n} {b / 2**30:.3f}" for n, _s, b in seen), flush=True)
    print(f"all {len(out['proves'])} proofs verified and are the same {len(first)} bytes")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", args.out), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
