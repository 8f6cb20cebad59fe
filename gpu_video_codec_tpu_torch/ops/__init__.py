from .tables import BETA_TABLE, TC_TABLE, get_beta, get_tc  # noqa: F401
from .filters import chroma_edge_filter, luma_edge_filter  # noqa: F401
from .deblock import deblock_frame, deblock_plane, deblock_tiles  # noqa: F401
