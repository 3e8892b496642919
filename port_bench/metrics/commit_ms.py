"""Milliseconds a proof in the commitments (LDE and Merkle tree of the main,
permutation and quotient rounds): the sum of the program's `main_commit`,
`perm_commit` and `quotient_commit` phases, averaged over the window's
proofs."""


def read(win):
    return win.per_proof("main_commit", "perm_commit", "quotient_commit")
