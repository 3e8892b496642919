"""Milliseconds a proof in the host executor (core/, native C++): the program's
`execute` phase (`BfCoreProof.timings`, synchronised with the card at its
end), averaged over the window's proofs."""


def read(win):
    return win.per_proof("execute")
