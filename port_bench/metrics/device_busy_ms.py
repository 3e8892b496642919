"""Milliseconds a proof in which the card ran an operation: the union of
its kernels, copies and sets in the traced window, over the window's
proofs."""


def read(win):
    if win.trace is None or not win.trace["busy_s"] or not win.proofs:
        return None
    return 1e3 * win.trace["busy_s"] / len(win.proofs)
