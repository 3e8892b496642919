"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the configuration's environment, `ProverClient()` on the card,
`setup` of the mix's guest, and one warm-up job of the cell's own size.
Window: a closed loop of one client, each job `client.prove(pk,
stdin).run()` with a fresh stdin from the seed (the host executor and the
whole prove), until `--seconds` have passed; the job running at that
moment finishes inside the window, so the window holds whole jobs only.
After the window, every one of its proofs is judged by the reference
(reference/judge.py), in a few worker processes.  With `--trace 1` the window runs
under torch.profiler and the cell's per-layer metrics are printed instead
of its end-to-end ones.

The last line of standard output is the result, a JSON object; the
numbers compared, each beside its limit, are also the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from . import manifest, traffic

JAX_NAMES = {"jax", "jaxlib", "flax", "zkvm_brainfuck_tpu"}
# The port's switches that the environment can set; a run clears them and
# then applies its configuration's own.
PORT_ENV_PREFIXES = ("ZKBF_",)
PORT_ENV = ("FRI_QUERIES", "BF_DEBUG", "SKIP_CONSTRAINTS")
JUDGE_WORKERS = 6  # processes that judge a window's proofs, at most one a core but two


def process_seconds() -> float:
    """Seconds since this process started (from /proc, at clock-tick
    resolution)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & JAX_NAMES)


def apply_environment(env: dict) -> None:
    for k in list(os.environ):
        if k.startswith(PORT_ENV_PREFIXES) or k in PORT_ENV:
            del os.environ[k]
    os.environ.update({k: str(v) for k, v in env.items()})


class Collector(dict):
    """A phase collector for the port's `utils.phases`: besides the summed
    seconds, it keeps each phase's interval (wall clock, seconds)."""

    def __init__(self):
        super().__init__()
        self.intervals = []

    def __setitem__(self, name, total):
        now = time.time()
        self.intervals.append((name, now - (total - self.get(name, 0.0)), now))
        super().__setitem__(name, total)


class Window:
    """What the metric readers read: the jobs of the window and, in a
    traced run, the trace's summary."""

    def __init__(self, guarantees, proofs, seconds, setup_s, peak_bytes, trace=None):
        self.guarantees = guarantees
        self.proofs = proofs
        self.seconds = seconds
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.trace = trace

    def per_proof(self, *phases) -> Optional[float]:
        """Mean milliseconds a proof of the sum of the program's phases."""
        if not self.proofs:
            return None
        vals = [sum(p.proof.timings.get(ph, 0.0) for ph in phases) for p in self.proofs]
        return 1e3 * float(np.mean(vals))


def read_metrics(names: List[str], win: Window) -> dict:
    out = {}
    for spec in names:
        mod = importlib.import_module(f"port_bench.metrics.{spec['name']}")
        v = mod.read(win)
        if v is not None:
            out[spec["name"]] = {"value": v, "unit": spec["unit"]}
    return out


def judge_workers(jobs: int) -> int:
    return max(1, min(jobs, JUDGE_WORKERS, (os.cpu_count() or 1) - 2))


def run_cell(cell: dict, config: dict, mix, seed: int, seconds: float, traced: bool,
             device=None, client=None, workers: Optional[int] = None) -> dict:
    """One run of a cell; returns the result object.  `device` and `client`
    stand in for the card in the CPU tests; `workers` judge the proofs."""
    import torch

    from zkvm_brainfuck_tpu_torch import ProverClient
    from zkvm_brainfuck_tpu_torch.utils import phases

    from .reference.judge import checks as judge_checks, judge, passed

    on_card = device is None
    client = client or ProverClient(device=device)
    pk, vk = client.setup(mix.source)
    client.prove(pk, mix.job(seed, -1)).run()
    pool = [mix.job(seed, j) for j in range(int(seconds) + 4)]
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_seconds()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    collector = Collector()
    prof = None
    if traced:
        from . import trace as tr

        prof = tr.start(on_card)
        mark = tr.mark()
    proofs, attempted, failed, errors = [], 0, 0, []
    t0 = time.perf_counter()
    with phases.collect(collector):
        while True:
            j = attempted
            stdin = pool[j] if j < len(pool) else mix.job(seed, j)
            attempted += 1
            try:
                proofs.append((stdin, client.prove(pk, stdin).run()))
            except Exception as e:  # a failed job counts against the run
                failed += 1
                errors.append(f"job {j}: {type(e).__name__}: {e}")
            if time.perf_counter() - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = None
    if traced:
        summary = tr.summarize(prof, mark, collector.intervals, window_s)
    win = Window(config["guarantees"], [p for _, p in proofs], window_s, setup_s, peak, summary)
    specs = manifest.metrics_for(cell["name"], "per_layer" if traced else "end_to_end")
    metrics = read_metrics(specs, win)

    # The judgement of every proof, on the host, once the window's peak is read.
    vk_bytes = vk.to_bytes()
    del pk, client
    jobs = [dict(stdin=stdin, proof=p.proof.proof.to_bytes(), public_values=p.public_values,
                 cycles=p.proof.cycles) for stdin, p in proofs]
    del proofs, win
    t_judge = time.perf_counter()
    n = judge_workers(len(jobs)) if workers is None else workers
    res = judge(mix.source, config["guarantees"], vk_bytes, jobs, n)
    print(f"judged {res['judged']} proofs in {n} processes in {time.perf_counter() - t_judge:.1f} s",
          file=sys.stderr)
    checks = judge_checks(res, config["guarantees"], len(jobs))
    checks["failed"] = {"value": failed, "limit": 0, "op": "=="}
    for line in res["why"] + errors:
        print(line, file=sys.stderr)

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": passed(checks), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = window_s
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks  # the last key: each number compared, beside its limit
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = manifest.cell(args.workload)
    config = manifest.config(cell["config"])
    mix = traffic.load(cell["traffic"])
    apply_environment(config.get("environment", {}))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"port_bench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, config, mix, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['op']} {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
