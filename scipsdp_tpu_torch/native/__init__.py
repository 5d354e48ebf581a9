"""Native (C++) host components: the slab-allocated B&B node store
(``frontier.cpp``, loaded through ctypes by ``frontier.py``, with a
pure-Python heap of the same pop order as its fallback)."""
