"""Milliseconds a proof in the LogUp trace (stark/permutation.py,
ops/logup.py): the program's `perm_trace` phase (`BfCoreProof.timings`,
synchronised with the card at its end), averaged over the window's proofs."""


def read(win):
    return win.per_proof("perm_trace")
