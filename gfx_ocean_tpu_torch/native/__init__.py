"""Native (C++) host components, built with g++ at first use and bound
with ctypes (``bincode_native.py``)."""
