"""Milliseconds a proof in the quotient (stark/quotient.py, ops/quotient.py;
with the low-memory LDE rebuild): the program's `quotient` phase
(`BfCoreProof.timings`, synchronised with the card at its end), averaged
over the window's proofs."""


def read(win):
    return win.per_proof("quotient")
