"""The least time the window's proofs need on the card (port_bench.work,
counted from each proof's chip heights) over the time the card was busy, %."""

from ..work import proof_work, seconds
from ..work.shapes import chip_shapes


def read(win):
    if win.trace is None or not win.trace["busy_s"] or not win.proofs:
        return None
    g = win.guarantees
    least = 0.0
    for p in win.proofs:
        sp = p.proof.proof.shard_proof
        heights = {name: sp.opened_values[i].log_degree for name, i in sp.chip_ordering.items()}
        work = proof_work(chip_shapes(heights), int(g["log_blowup"]), int(g["proof_of_work_bits"]))
        least += sum(seconds(w) for w in work.values())
    return 100.0 * least / win.trace["busy_s"]
