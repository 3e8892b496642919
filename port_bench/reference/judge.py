"""The judgement of the proofs a run made, against the reference alone.

For the guest's source and the configuration's guarantees, the reference
works out the verifying key again (vk.py) and, for every judged job, runs
the job's stdin through its own interpreter.  A proof is then held to:

- its bytes decoding (the proof format), its verification under the
  reference's own key with the stated queries, proof-of-work bits and
  blowup (every commitment's Merkle openings, the LogUp cumulative sums,
  the out-of-domain constraint check of the quotient, the opened values,
  the reduced openings, FRI and the proof-of-work witness);
- the chips it proves and each chip's height, which follow from the
  interpreter's counts of the job's instructions and touched addresses;
- its IO and Memory openings at zeta, against those chips' traces built
  from the interpreter's run (bind.py): the job's stdin, output, touched
  memory and last timestamps, so a proof of another job does not pass;
- the output stream and the cycle count that the program reports beside
  the proof.

Each count below must be 0; `queries` must be at least the configuration's.
`judge` spreads the jobs over worker processes where it is given more than
one; each builds its own key.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

from . import bind, interp
from .air.base import next_power_of_two
from .air.chip import Chip
from .air.machine_def import brainfuck_chips
from .stark.challenger import DuplexChallenger
from .stark.errors import VerificationFailure
from .stark.serial import ProofDecodeError, encode_vk
from .stark.types import ShardProof
from .stark.verifier import verify_shard
from .vk import verifying_key

MAX_CPU_LOG_DEGREE = 22  # one shard's CPU trace (reference cpu/mod.rs:8)
MEMORY_ENTRIES_PER_ROW = 2
COUNTS = ("rejected", "shape_mismatch", "binding_mismatch", "output_mismatch", "cycles_mismatch")


def expected_heights(run: interp.Run, program_len: int) -> Dict[str, int]:
    """log2 of each chip's height for one execution of a program of
    `program_len` instructions; chips with nothing to hold are left out of
    a proof."""
    c = run.cycles
    rows = {
        "Cpu": max(1, 1 << (c - 1).bit_length()) if c else 0,
        "Program": next_power_of_two(program_len),
        "AddSub": next_power_of_two(run.alu) if run.alu else 0,
        "Jump": next_power_of_two(run.jumps) if run.jumps else 0,
        "Memory": next_power_of_two(-(-run.touched // MEMORY_ENTRIES_PER_ROW)) if run.touched else 0,
        "Byte": 1 << 16,
        "MemoryInstrs": next_power_of_two(run.steps) if run.steps else 0,
        "IO": next_power_of_two(run.io) if run.io else 0,
    }
    return {k: v.bit_length() - 1 for k, v in rows.items() if v}


class Judge:
    def __init__(self, source: str, guarantees: dict):
        self.source = source
        self.g = SimpleNamespace(
            num_queries=int(guarantees["num_queries"]),
            proof_of_work_bits=int(guarantees["proof_of_work_bits"]),
            log_blowup=int(guarantees["log_blowup"]),
        )
        self.vk = verifying_key(source, self.g.log_blowup)
        self.vk_bytes = encode_vk(self.vk)
        self.chips = {c.name: c for c in (Chip(a) for a in brainfuck_chips())}
        self.program_len = len(interp.compile_source(source)[0])

    def verify(self, sp: ShardProof) -> Tuple[str, Optional[tuple]]:
        """('', zeta) if the proof verifies under the reference's key, else
        (why not, None)."""
        try:
            if "Cpu" not in sp.chip_ordering:
                return "no Cpu chip", None
            if sp.opened_values[sp.chip_ordering["Cpu"]].log_degree > MAX_CPU_LOG_DEGREE:
                return "Cpu chip taller than one shard", None
            chips = sorted((self.chips[n] for n in sp.chip_ordering), key=lambda c: sp.chip_ordering[c.name])
            challenger = DuplexChallenger()
            self.vk.observe_into(challenger)
            zeta = verify_shard(SimpleNamespace(fri=self.g), self.vk, chips, challenger, sp)
        except (VerificationFailure, ProofDecodeError) as e:
            return f"{type(e).__name__}: {e}", None
        except (KeyError, IndexError, AttributeError, TypeError, ValueError) as e:
            return f"malformed: {type(e).__name__}: {e}", None
        return "", zeta

    def judge_one(self, job: dict) -> dict:
        """job: `stdin` (what the benchmark sent), and what the program
        returned: `proof` (bytes), `public_values`, `cycles`.  Returns this
        job's counts, its queries and the reasons of any failure."""
        out = dict.fromkeys(COUNTS, 0)
        out["queries"], out["why"] = 0, []
        run = interp.run(self.source, job["stdin"])
        try:
            sp = ShardProof.from_bytes(job["proof"])
            heights = {n: sp.opened_values[i].log_degree for n, i in sp.chip_ordering.items()}
            out["queries"] = len(sp.opening_proof.query_input_openings)
            why, zeta = self.verify(sp)
        except (ProofDecodeError, IndexError, ValueError) as e:
            sp, heights, why, zeta = None, {}, f"undecodable: {e}", None
        if why:
            out["rejected"] = 1
            out["why"].append(why)
        want = expected_heights(run, self.program_len)
        if heights != want:
            out["shape_mismatch"] = 1
            out["why"].append(f"chip heights {heights} != {want}")
        if zeta is not None:
            opened = {n: sp.opened_values[i] for n, i in sp.chip_ordering.items()}
            why = bind.mismatch(run, opened, zeta)
            if why:
                out["binding_mismatch"] = 1
                out["why"].append(why)
        if job["public_values"] != run.output:
            out["output_mismatch"] = 1
            out["why"].append("output differs from the interpreter's")
        if job["cycles"] != run.cycles:
            out["cycles_mismatch"] = 1
            out["why"].append(f"{job['cycles']} cycles, the interpreter ran {run.cycles}")
        return out


_WORKER: Optional[Judge] = None


def _init(source: str, guarantees: dict) -> None:
    global _WORKER
    _WORKER = Judge(source, guarantees)


def _judge_one(job: dict) -> dict:
    return _WORKER.judge_one(job)


def _vk_bytes(_=None) -> bytes:
    return _WORKER.vk_bytes


def judge(source: str, guarantees: dict, vk_bytes: bytes, jobs: List[dict], workers: int = 1) -> dict:
    """Judge every job; returns the summed counts, the fewest queries, the
    number judged and the reasons of any failure, by job."""
    if workers <= 1:
        _init(source, guarantees)
        ref_vk, results = _vk_bytes(), [_judge_one(j) for j in jobs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx, initializer=_init,
                                 initargs=(source, guarantees)) as ex:
            ref_vk = ex.submit(_vk_bytes).result()
            results = list(ex.map(_judge_one, jobs))
    out = {k: sum(r[k] for r in results) for k in COUNTS}
    out["vk_mismatch"] = int(vk_bytes != ref_vk)
    out["queries"] = min((r["queries"] for r in results), default=0)
    out["judged"] = len(results)
    out["why"] = [f"job {k}: {w}" for k, r in enumerate(results) for w in r["why"]]
    return out


def checks(res: dict, guarantees: dict, proofs: int) -> Dict[str, dict]:
    """Each number compared, beside its limit (`op`: how it is held);
    every one of the window's `proofs` is judged."""
    c = {k: {"value": res[k], "limit": 0, "op": "=="} for k in ("vk_mismatch",) + COUNTS}
    c["queries"] = {"value": res["queries"], "limit": int(guarantees["num_queries"]), "op": ">="}
    c["judged"] = {"value": res["judged"], "limit": max(1, proofs), "op": ">="}
    return c


def passed(checks: Dict[str, dict]) -> bool:
    for c in checks.values():
        ok = c["value"] == c["limit"] if c["op"] == "==" else c["value"] >= c["limit"]
        if not ok:
            return False
    return True
