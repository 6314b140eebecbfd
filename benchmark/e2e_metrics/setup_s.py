"""Seconds from the process's start to the window's: imports, the
card's start-up, building or loading the kernels, the inputs made from
the seed, the program's set-up and the warm-up."""


def read(rec):
    return rec.setup_s
