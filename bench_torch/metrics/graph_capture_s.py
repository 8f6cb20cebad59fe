"""graph_capture_s: seconds of set-up in the program's span
graphs.capture, each CUDA graph's warm-up on clones and its capture, less
the kernel loads (kernels.load) inside the first warm-up, which
kernel_load_s reads."""

from bench_torch.lib import program_spans as ps


def read(rec):
    return ps.self_s("graphs.capture")
