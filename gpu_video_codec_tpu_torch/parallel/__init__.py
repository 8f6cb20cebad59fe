"""Device-mesh parallelism over torch device slots (counterpart of
gpu_video_codec_tpu/parallel): parallel/mesh.py, multistream.py and
resident_mesh.py."""

from .mesh import (  # noqa: F401
    default_mesh_shape,
    deblock_batch_sharded,
    deblock_batch_sharded_jit,
    make_mesh,
)
from .multistream import MultiStreamDeblocker  # noqa: F401
from .resident_mesh import MeshResidentDeblocker  # noqa: F401
