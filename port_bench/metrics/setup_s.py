"""Set-up seconds: from the process's start to the window's start (imports,
kernel libraries, setup, the warm-up job)."""


def read(win):
    return win.setup_s
