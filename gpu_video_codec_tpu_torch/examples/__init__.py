"""Self-checking examples of the port's public API, each run as

    python -m gpu_video_codec_tpu_torch.examples.<name> [--device cpu]

one_shot (DeblockPipeline on one bundled frame), streaming
(StreamingDeblocker.run, host-fed with copy overlap), resident_chain
(ResidentDeblocker: a device-resident chain and a frame batch),
multi_stream (MultiStreamDeblocker over a mesh of slots) and mesh_streams
(MeshResidentDeblocker: a resident chain over the mesh's data slots).  Each holds
its output against the golden oracle and prints "bit-exact"; the card
(cuda) is the default device.
"""

import argparse
from pathlib import Path

TESTDATA = Path(__file__).resolve().parent.parent.parent / "testdata"


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="torch device of the kernels (default cuda; cpu runs their plain "
                        "versions)")
    return p
