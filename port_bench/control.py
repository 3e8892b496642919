"""The control of a cell, and the faults it must catch, run through the
whole harness on each seed, in one process.  Every line it prints must
read `"correct": false`; the benchmark's own runs never run it.

- `--fault queries` (the control): the program with one stated guarantee
  broken by its own switch, `FRI_QUERIES` one below the configuration's.
- `--fault stale`: each job returns the previous job's proof, beside its
  own output, cycles and stdin: a state left unchanged.
- `--fault unchanged`: each job returns the previous job's whole result.
- `--fault opened_value`, `output`, `cycles`: the proof's first opened
  cumulative sum, the output's first byte or the cycle count altered where
  produced.

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 --seconds 2 --fault stale
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import manifest, run, traffic

FAULTS = ("queries", "stale", "unchanged", "opened_value", "output", "cycles")
P = 0x7F000001


class FaultyClient:
    """A `ProverClient` whose results are broken where they are produced."""

    def __init__(self, fault: str, device=None):
        from zkvm_brainfuck_tpu_torch import ProverClient

        self.inner = ProverClient(device=device)
        self.fault = fault
        self.last = None

    def setup(self, source):
        return self.inner.setup(source)

    def prove(self, pk, stdin):
        outer = self

        class _Action:
            def run(self):
                p = outer.inner.prove(pk, stdin).run()
                prev, outer.last = outer.last, p
                if outer.fault == "unchanged" and prev is not None:
                    return prev
                if outer.fault == "stale" and prev is not None:
                    p.proof.proof = prev.proof.proof
                if outer.fault == "opened_value":
                    ov = p.proof.proof.shard_proof.opened_values[0]
                    ov.cumulative_sum = ((ov.cumulative_sum[0] + 1) % P,) + tuple(ov.cumulative_sum[1:])
                if outer.fault == "output":
                    p.proof.public_values = bytes([p.proof.public_values[0] ^ 1]) + p.proof.public_values[1:]
                if outer.fault == "cycles":
                    p.proof.cycles += 1
                return p

        return _Action()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=FAULTS, default="queries")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    config = manifest.config(cell["config"])
    mix = traffic.load(cell["traffic"])
    run.apply_environment(config.get("environment", {}))
    if args.fault == "queries":
        os.environ["FRI_QUERIES"] = str(int(config["guarantees"]["num_queries"]) - 1)

    import torch

    if not torch.cuda.is_available():
        print("port_bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        client = None if args.fault == "queries" else FaultyClient(args.fault)
        r = run.run_cell(cell, config, mix, seed, args.seconds, False, client=client)
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
