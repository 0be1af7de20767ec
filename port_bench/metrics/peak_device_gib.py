"""Peak device memory allocated by the program over the window
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(rec):
    if not rec.peak_window_bytes:
        return None
    return rec.peak_window_bytes / 2**30
