"""Milliseconds a proof in trace generation (models/): the program's
`trace_gen` phase (`BfCoreProof.timings`, synchronised with the card at its
end), averaged over the window's proofs."""


def read(win):
    return win.per_proof("trace_gen")
