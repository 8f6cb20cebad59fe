from .streaming import StreamingDeblocker  # noqa: F401
