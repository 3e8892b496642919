"""Milliseconds a proof in the reduced openings, the host-heavy part of the
opening: the program's `reduced_open` phase (`BfCoreProof.timings`,
synchronised with the card at its end), averaged over the window's proofs."""


def read(win):
    return win.per_proof("reduced_open")
