"""setup_s: process start to the first timed frame: imports, kernel build
or load, pools and BS from the seed, graph capture and warm-up."""


def read(rec):
    return rec.setup_s
