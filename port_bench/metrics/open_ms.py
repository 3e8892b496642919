"""Milliseconds a proof in the PCS opening (stark/pcs.py open, stark/fri.py):
the program's `pcs_open_total` phase (`BfCoreProof.timings`, synchronised
with the card at its end), averaged over the window's proofs."""


def read(win):
    return win.per_proof("pcs_open_total")
