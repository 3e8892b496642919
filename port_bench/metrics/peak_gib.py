"""Peak device memory over the window, GiB: torch.cuda.max_memory_allocated
after reset_peak_memory_stats at the window's start."""


def read(win):
    return win.peak_bytes / 2**30 if win.peak_bytes else None
