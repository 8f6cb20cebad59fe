"""The native C++ CPU runtime (runtime/native.py over runtime/src/)."""
