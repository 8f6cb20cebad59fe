"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_torch/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds BENCHMARK.json, bench_torch/
and the gpu_video_codec_tpu_torch package; see bench_torch/README.md.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
