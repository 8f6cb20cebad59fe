from .yuv import FramePlanes, read_yv12, read_yv12_stream, write_yv12  # noqa: F401
from .bs import BoundaryStrength, chroma_segment_maps, luma_segment_maps  # noqa: F401
from .tiles import plane_to_tiles, tiles_to_plane  # noqa: F401
from .config import BACKENDS, DeblockConfig  # noqa: F401
