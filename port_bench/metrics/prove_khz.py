"""Proved kHz: the cycles of every job finished in the window, each
proof's own count, over the window's milliseconds (host clock): the
upstream's summary unit taken over the user's whole wait, executor and
prove.  The judgement holds every proof's count to the interpreter's."""


def read(win):
    if not win.proofs:
        return None
    return sum(p.proof.cycles for p in win.proofs) / (win.seconds * 1e3)
