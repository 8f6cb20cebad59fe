from .pipeline import DeblockPipeline  # noqa: F401
from .resident import ResidentDeblocker  # noqa: F401
from .streaming import StreamingDeblocker  # noqa: F401
