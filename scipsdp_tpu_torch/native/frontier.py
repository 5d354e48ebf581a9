"""Best-first B&B frontier backed by the native node pool.

The reference's tree management lives in SCIP's C core; this is the
framework's native runtime equivalent (frontier.cpp: slab-allocated node
storage with a best-bound heap and a free-list allocator), loaded through
ctypes with a pure-Python fallback of identical semantics.

The store holds the dense per-node data (lb, ub, bound, depth); arbitrary
Python side data (node-local cuts, warmstart vectors) rides in a dict
keyed by the pool ids, so no feature is lost relative to the Python heap.

A copy of the JAX package's ``native/frontier.py`` (host code, no JAX);
only the library's place differs: ``g++`` builds ``frontier.cpp`` at first
use into ``build/scipsdp_tpu_torch/native/<hash>/libfrontier.so``
(``native.build_library``).
"""

from __future__ import annotations

import ctypes
import heapq
import itertools
from pathlib import Path
from typing import Optional

import numpy as np

from scipsdp_tpu_torch.native import build_library

_SRC_PATH = Path(__file__).resolve().parent / "frontier.cpp"
_lib = None
_tried = False


def get_frontier_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib_path = build_library(_SRC_PATH, "libfrontier.so")
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)
        lp = ctypes.POINTER(ctypes.c_int64)
        lib.frontier_create.restype = ctypes.c_void_p
        lib.frontier_create.argtypes = [ctypes.c_int]
        lib.frontier_destroy.argtypes = [ctypes.c_void_p]
        lib.frontier_push.restype = ctypes.c_int64
        lib.frontier_push.argtypes = [ctypes.c_void_p, dp, dp,
                                      ctypes.c_double, ctypes.c_int]
        lib.frontier_pop_batch.restype = ctypes.c_int
        lib.frontier_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_double, dp, dp, dp, ip,
                                           lp]
        lib.frontier_size.restype = ctypes.c_int64
        lib.frontier_size.argtypes = [ctypes.c_void_p]
        lib.frontier_best_bound.restype = ctypes.c_double
        lib.frontier_best_bound.argtypes = [ctypes.c_void_p]
        lib.frontier_dump.restype = ctypes.c_int64
        lib.frontier_dump.argtypes = [ctypes.c_void_p, dp, dp, dp, ip, lp]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class FrontierStore:
    """Best-bound frontier of (lb, ub, bound, depth, side) entries.

    ``side`` is an arbitrary Python object (or None).  Pop order:
    ascending (bound, insertion sequence) — identical for both backends.
    """

    def __init__(self, m: int, prefer_native: bool = True):
        self.m = m
        self._side = {}
        lib = get_frontier_lib() if prefer_native else None
        self._lib = lib
        if lib is not None:
            self._h = ctypes.c_void_p(lib.frontier_create(m))
        else:
            self._heap = []
            self._counter = itertools.count()

    @property
    def native(self) -> bool:
        return self._lib is not None

    def push(self, lb, ub, bound: float, depth: int, side=None) -> None:
        if self._lib is not None:
            lbc = np.ascontiguousarray(lb, dtype=np.float64)
            ubc = np.ascontiguousarray(ub, dtype=np.float64)
            nid = self._lib.frontier_push(self._h, _dptr(lbc), _dptr(ubc),
                                          float(bound), int(depth))
            if side is not None:
                self._side[nid] = side
        else:
            heapq.heappush(self._heap, (float(bound), next(self._counter),
                                        (lb, ub, float(bound), int(depth),
                                         side)))

    def pop_upto(self, maxn: int, cutoff: float = np.inf):
        """Pop up to maxn best nodes with bound < cutoff (others are
        pruned and discarded); returns a list of
        (lb, ub, bound, depth, side)."""
        out = []
        if self._lib is not None:
            lb = np.empty((maxn, self.m))
            ub = np.empty((maxn, self.m))
            bd = np.empty(maxn)
            dp = np.empty(maxn, np.int32)
            ids = np.empty(maxn, np.int64)
            while len(out) < maxn and self._lib.frontier_size(self._h) > 0:
                want = maxn - len(out)
                n = self._lib.frontier_pop_batch(
                    self._h, want, float(cutoff), _dptr(lb), _dptr(ub),
                    _dptr(bd),
                    dp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                for i in range(n):
                    out.append((lb[i].copy(), ub[i].copy(), float(bd[i]),
                                int(dp[i]),
                                self._side.pop(int(ids[i]), None)))
                if n < want:
                    break   # remainder was pruned or frontier drained
            return out
        while self._heap and len(out) < maxn:
            bound, _, ent = heapq.heappop(self._heap)
            if bound >= cutoff:
                continue
            out.append(ent)
        return out

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.frontier_size(self._h))
        return len(self._heap)

    def best_bound(self) -> float:
        if self._lib is not None:
            if len(self) == 0:
                return np.inf
            b = self._lib.frontier_best_bound(self._h)
            return np.inf if b >= 1e299 else float(b)
        return self._heap[0][0] if self._heap else np.inf

    def dump(self):
        """All live nodes (checkpointing); does not modify the store."""
        if self._lib is not None:
            n = len(self)
            if n == 0:
                return []
            lb = np.empty((n, self.m))
            ub = np.empty((n, self.m))
            bd = np.empty(n)
            dp = np.empty(n, np.int32)
            ids = np.empty(n, np.int64)
            k = self._lib.frontier_dump(
                self._h, _dptr(lb), _dptr(ub), _dptr(bd),
                dp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            return [(lb[i].copy(), ub[i].copy(), float(bd[i]), int(dp[i]),
                     self._side.get(int(ids[i]))) for i in range(int(k))]
        return [ent for _, _, ent in sorted(self._heap,
                                            key=lambda t: (t[0], t[1]))]

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            try:
                self._lib.frontier_destroy(self._h)
            except Exception:
                pass
