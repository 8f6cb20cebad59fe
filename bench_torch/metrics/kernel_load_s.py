"""kernel_load_s: seconds of set-up in the program's span kernels.load,
each kernel library's first load, less the nvcc build inside it
(kernels.build) where the checkout has no library yet: a first run's
build shows in setup_s alone."""

from bench_torch.lib import program_spans as ps


def read(rec):
    return ps.self_s("kernels.load")
