"""Share of the traced window in which no operation ran on the card, %."""


def read(win):
    if win.trace is None or not win.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - win.trace["busy_s"] / win.seconds)
