"""Seconds from the start of the process to the first timed call: imports,
the CUDA context, the program's kernel library, the inputs, the targets
and one warm-up call at the cell's shapes (host clock)."""


def read(rec):
    return rec.setup_s
